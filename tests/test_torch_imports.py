"""The port imports neither ``jax`` nor ``pnp_tpu`` (the port's counterpart of
``tools/preflight.py:check_imports``): in a fresh interpreter whose import
system refuses ``jax``, ``jaxlib`` and ``pnp_tpu`` (a ``sys.meta_path``
finder that raises), every module of ``pnp_tpu_torch`` and the top level
of ``chip_smoke.py`` import, and the bench's and the entry's paths run.
``pnp_tpu_torch/__main__.py`` is the command line itself (importing it
runs it); ``tests/test_torch_cli.py`` runs it."""

import os
import pkgutil
import subprocess
import sys

import pytest

import pnp_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = """
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "pnp_tpu")
for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[name]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
try:
    import jax
except ImportError:
    print("REFUSED jax")
"""

CHECKS = {
    "every_module": """
import pnp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pnp_tpu_torch.__path__,
                                                "pnp_tpu_torch.")
         if not m.name.endswith(".__main__")]
for name in names:
    importlib.import_module(name)
print("IMPORTED", len(names))
""",
    "chip_smoke": """
import chip_smoke
assert callable(chip_smoke.main) and callable(chip_smoke.bench_phase)
print("IMPORTED chip_smoke")
""",
    "bench_and_entry_paths": """
from pnp_tpu_torch import bench, entry
bench.run_drybuild(base=(12, 7), device="cpu")
fn, args = entry.entry("cpu", base=(12, 7))
fn(*args)
print("RAN")
""",
}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_port_runs_with_jax_and_pnp_tpu_refused(name):
    code = BLOCK + CHECKS[name] + """
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("LOADED", bad)
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    out = proc.stdout
    assert proc.returncode == 0, out + proc.stderr
    assert "REFUSED jax" in out and "LOADED []" in out
    if name == "every_module":
        # every module of the package, the bench and the entry included
        names = [m.name for m in pkgutil.walk_packages(
            pnp_tpu_torch.__path__, "pnp_tpu_torch.")]
        assert {"pnp_tpu_torch.bench", "pnp_tpu_torch.entry"} <= set(names)
        assert f"IMPORTED {len(names) - 1}\n" in out     # all but __main__
