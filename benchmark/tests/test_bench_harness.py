"""The harness on the CPU at a tiny size: a throwaway cell from files in a
temporary directory, its result line, faults planted under the timed path,
the import guard, the command's refusals, and the spec's contract."""

import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import harness, meshgen, roofline
from benchmark.tests.cells import BENCH, ROOT, TINY, write_tiny_cell

import pnp_tpu_torch.postprocess.ionflux as ionflux
import pnp_tpu_torch.workloads.instationary_pnp_from_pb as driver
from pnp_tpu_torch.meshio.refine import refine_uniform
from pnp_tpu_torch.meshio.structured import pore_without_dna_mesh

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(tmp_path, traced=False, seconds=1.0, device="cpu"):
    root = write_tiny_cell(tmp_path)
    return harness.run_cell(root, TINY, 2 ** 31 + 12345, seconds, traced,
                            device, time.perf_counter())


def test_throwaway_cell_runs_and_is_correct(tmp_path):
    r = _run(tmp_path)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"] and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"step_ms", "step_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["run"]["segments_compared"] >= 1
    assert set(r["checks"]) == {"pb_err", "phi_err", "c_err", "current_err"}
    lo, hi = json.loads((BENCH / "traffic" / "transient.json").read_text(
    ))["bias_band"]
    assert lo <= r["run"]["bias"] <= hi


def test_traced_run_reads_the_span_and_counter_metrics(tmp_path):
    r = _run(tmp_path, traced=True)
    m = r["metrics"]
    # the device's metrics need the card; the rest are read here
    assert {"species_ms", "species_iters", "poisson_ms", "poisson_iters",
            "phase_a_s", "poisson_setup_s"} == set(m)
    assert m["poisson_iters"]["value"] == 1.0      # the dense tier's affine
    assert m["species_iters"]["unit"] == "its/step"
    assert r["correct"] is True


def test_same_seed_same_bias_other_seed_other_bias(tmp_path):
    cell = harness.Cell.load(write_tiny_cell(tmp_path), TINY)
    assert cell.bias(2 ** 31 + 5) == cell.bias(2 ** 31 + 5)
    assert cell.bias(2 ** 31 + 5) != cell.bias(2 ** 31 + 6)


def _faulty_build(fault):
    real = driver.build_pnp_system

    def build(*args, **kwargs):
        s = real(*args, **kwargs)
        step = s.species_step
        if fault == "state_unchanged":
            return dataclasses.replace(
                s, species_step=lambda uphi, cp, cm: (cp, cm, 1),
                poisson_solve=lambda uphi, cp, cm, pre=None: (uphi, 1))
        if fault == "half_batch":
            def half(uphi, cp, cm):
                cp2, _, k = step(uphi, cp, cm)
                return cp2, cm, k
            return dataclasses.replace(s, species_step=half)
        raise ValueError(fault)
    return build


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "current_altered"])
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, monkeypatch,
                                                     fault):
    if fault == "current_altered":
        real = ionflux.calc_ion_flux

        def altered(*args, **kwargs):
            ip, im = real(*args, **kwargs)
            return ip * (1.0 + 1e-4), im
        monkeypatch.setattr(ionflux, "calc_ion_flux", altered)
    else:
        monkeypatch.setattr(driver, "build_pnp_system", _faulty_build(fault))
    r = _run(tmp_path)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


GUARD = """
import sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
r = harness.run_cell({cell_root!r}, {cell!r}, 3, 1.5, False, "cpu",
                     time.perf_counter())
assert r["correct"], r
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return eval(out.stdout.strip().splitlines()[-1])


def test_import_guard_a_run_loads_no_jax(tmp_path):
    """A whole run (set-up, window, reference) in a process of its own
    holds no top-level ``jax``, ``jaxlib``, ``flax`` or ``pnp_tpu``."""
    root = write_tiny_cell(tmp_path)
    tops = _top_modules(GUARD.format(root=str(ROOT), cell_root=str(root),
                                     cell=TINY))
    assert "pnp_tpu_torch" in tops
    assert not set(tops) & set(harness.FORBIDDEN_MODULES), tops
    assert harness.forbidden_loaded() == []


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "pore_pnp.transient", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_command_refuses_an_unknown_cell():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "nope",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_a_run_cannot_start(tmp_path):
    """A directory with BENCHMARK.json and the benchmark alone: the
    harness cannot reach the program, so a run raises before any result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (f"import sys; sys.path.insert(0, {str(tmp_path)!r}); "
            "from benchmark import harness; import time; "
            f"harness.run_cell({str(tmp_path)!r}, 'pore_pnp.transient', 1, "
            "1, False, 'cpu', time.perf_counter())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and "pnp_tpu_torch" in out.stderr


@pytest.mark.parametrize("nx, ny, levels", [(30, 17, 0), (80, 44, 0),
                                            (30, 17, 2)])
def test_mesh_generator_is_the_ports(nx, ny, levels):
    mine = meshgen.refine(meshgen.pore_without_dna(nx, ny), levels)
    port = refine_uniform(pore_without_dna_mesh(nx, ny), levels)
    for key, arr in mine.items():
        np.testing.assert_array_equal(arr, getattr(port, key))
        assert arr.dtype == getattr(port, key).dtype


def test_roofline_reproduces_the_kernel_table():
    # PERF.md's kernel table: 6.607 ms at (2, 4801, 4801), 2.3174 at
    # (1484, 374, 374), both bounded by the operations
    assert roofline.gj_inverse_min_seconds(2, 4801) == pytest.approx(
        6.607e-3, rel=1e-3)
    assert roofline.gj_inverse_min_seconds(1484, 374) == pytest.approx(
        2.3174e-3, rel=1e-3)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = {}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        names[c["name"]] = c
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert layers.setdefault(m["layer"], m["layer"]) == m["layer"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.cuda
def test_traced_run_on_the_card_reports_every_metric(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = _run(tmp_path, traced=True, device="cuda:0")
    names = {m["name"] for m in SPEC["per_layer"]}
    assert set(r["metrics"]) == names
    assert 0 < r["metrics"]["gj_inverse.roofline"]["value"] <= 100
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["correct"] is True
