"""The plain reference against ``pnp_tpu_torch`` on the CPU at small pore
sizes, and its float32 control against the cells' limits."""

import json

import numpy as np
import pytest

from benchmark import meshgen
from benchmark.control import control_numbers
from benchmark.reference import compare, pnp as reference
from benchmark.tests.cells import BENCH

from pnp_tpu_torch.config import Surface, Sysparams
from pnp_tpu_torch.fem.space import FunctionSpace
from pnp_tpu_torch.meshio.mesh import Mesh
from pnp_tpu_torch.postprocess.ionflux import calc_ion_flux
from pnp_tpu_torch.workloads.instationary_pnp_from_pb import build_pnp_system

CONF = json.loads((BENCH / "configs" / "pore_pnp.json").read_text())
BLOCK_RAS = dict(dense_poisson_threshold=0, ras_block_size=64,
                 poisson_inv_threshold=0)


def _program(mesh, system, surfaces, n_steps, **build_kw):
    """The port's presolved production steps (factor every 4 on
    block-RAS), in the compare module's layout."""
    sysp = Sysparams(**system, surfaces=[Surface(**s) for s in surfaces])
    sysp.n_surfaces = len(surfaces)
    S = build_pnp_system(sysp, FunctionSpace(Mesh(**mesh), 1), device="cpu",
                         **build_kw)
    uphi = S.poisson_solve(S.uphi0, S.ucp0, S.ucm0)[0]
    ucp, ucm, factor, cur = S.ucp0, S.ucm0, None, []
    for i in range(n_steps):
        if S.factor_kind == "ras":
            if i % 4 == 0:
                factor = S.species_factor(uphi)
            ucp, ucm, _ = S.species_step_reuse(factor, uphi, ucp, ucm)
        else:
            ucp, ucm, _ = S.species_step(uphi, ucp, ucm)
        if i % system["potentialUpdateFreq"] == 0:
            uphi, _ = S.poisson_solve(uphi, ucp, ucm)
        ip, im = calc_ion_flux(S.ionflux_tables, uphi, ucp, ucm)
        cur.append((i, ip.numpy(), im.numpy()))
    return S, {"pb": S.pb.numpy(), "segments": [{
        "state": tuple(v.numpy() for v in (uphi, ucp, ucm)),
        "currents": cur}]}


@pytest.mark.parametrize("nx, ny, levels, build_kw, pfreq, tol", [
    (30, 17, 0, {}, 1, 1e-10),           # dense tier
    (30, 17, 1, BLOCK_RAS, 1, 1e-7),     # block-RAS, two-level RAS Poisson
    (30, 17, 1, BLOCK_RAS, 4, 1e-7),     # Poisson one step in four
])
def test_reference_matches_port(nx, ny, levels, build_kw, pfreq, tol):
    mesh = meshgen.refine(meshgen.pore_without_dna(nx, ny), levels)
    system = dict(CONF["system"], potentialUpdateFreq=pfreq)
    surfaces = [dict(s) for s in CONF["surfaces"]]
    surfaces[CONF["bias_surface"]]["coulombPotential"] = 24.2
    S, prog = _program(mesh, system, surfaces, 8, **build_kw)
    assert S.factor_kind == ("ras" if build_kw else "dense")
    ref = reference.run(mesh, system, surfaces, 8)
    nums = compare.numbers(prog, ref)
    assert nums["pb_err"] < 1e-13
    assert max(nums.values()) < tol, nums
    # the currents carry the bias: the outflow's is far from zero
    assert abs(ref["currents"][-1][1][3]) > 1.0


def test_compare_catches_a_wrong_field():
    mesh = meshgen.pore_without_dna(30, 17)
    surfaces = [dict(s) for s in CONF["surfaces"]]
    ref = reference.run(mesh, CONF["system"], surfaces, 2)
    bad = [v.copy() for v in ref["state"]]
    bad[2][7] *= 1.01
    prog = {"pb": ref["pb"], "segments": [
        {"state": tuple(bad), "currents": ref["currents"]}]}
    nums = compare.numbers(prog, ref)
    assert nums["c_err"] > 1e-4 and nums["phi_err"] == 0.0
    prog["segments"][0]["currents"] = ref["currents"][:1]
    assert np.isnan(compare.numbers(prog, ref)["current_err"])


@pytest.mark.parametrize("cell", ["pore_pnp.transient",
                                  "pore_pnp_L3.transient",
                                  "pore_pnp_L3.potential_every_4"])
def test_float32_control_fails_the_limits(cell):
    """The control at a test's size (488 nodes, 4 steps) fails at least
    one of each cell's limits; at the cells' own sizes it is read on the
    card by ``control.py``."""
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    mesh = meshgen.pore_without_dna(30, 17)
    surfaces = [dict(s) for s in CONF["surfaces"]]
    nums = control_numbers(mesh, CONF["system"], surfaces, 4, "cpu")
    assert any(v > limits["limits"][k] for k, v in nums.items()), nums


def test_reference_imports_no_program():
    import subprocess
    import sys
    code = ("import sys; import benchmark.reference.pnp, "
            "benchmark.reference.compare, benchmark.meshgen; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, check=True).stdout
    tops = eval(out)
    assert "pnp_tpu_torch" not in tops and "pnp_tpu" not in tops
    assert "jax" not in tops
