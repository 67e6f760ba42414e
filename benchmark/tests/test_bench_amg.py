"""The ``CG_AMG_SSOR`` configuration (``pore_pnp_L3_amg``) on the CPU at
small pore sizes: the port under CG and the two-level AMG against the
plain reference, which does not depend on the program's solver, and the
float32 control against the cell's limits."""

import json

import pytest

from benchmark import meshgen
from benchmark.control import control_numbers
from benchmark.reference import compare, pnp as reference
from benchmark.tests.cells import BENCH
from benchmark.tests.test_bench_reference import _program

CELL = "pore_pnp_L3_amg.transient4"
CONF = json.loads((BENCH / "configs" / "pore_pnp_L3_amg.json").read_text())
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())


def _surfaces(bias):
    surfaces = [dict(s) for s in CONF["surfaces"]]
    surfaces[CONF["bias_surface"]]["coulombPotential"] = bias
    return surfaces


def test_the_configuration_is_the_l3_case_under_amg():
    l3 = json.loads((BENCH / "configs" / "pore_pnp_L3.json").read_text())
    assert CONF["system"] == dict(l3["system"], linearSolver="CG_AMG_SSOR")
    for key in ("surfaces", "bias_surface", "mesh", "reduced"):
        assert CONF[key] == l3[key]
    # the case is L3's; the source names the solver variant's definition
    assert CONF["case"] == l3["source"]
    assert CONF["source"] != l3["source"]
    assert "instationary_pnp_from_pb_md.hh" in CONF["source"]
    assert LIMITS["reference_steps"] == 4


def test_reference_matches_port_under_cg_amg():
    """1,827 nodes, above the dense tier: CG under the two-level AMG for
    PB, Poisson and species against SuperLU and BiCGSTAB, 8 presolved
    steps, held to the block-RAS case's 1e-7."""
    mesh = meshgen.refine(meshgen.pore_without_dna(30, 17), 1)
    surfaces = _surfaces(24.2)
    S, prog = _program(mesh, CONF["system"], surfaces, 8,
                       dense_poisson_threshold=0)
    assert (S.factor_kind, S.poisson_tier) == (None, "krylov")
    ref = reference.run(mesh, CONF["system"], surfaces, 8)
    nums = compare.numbers(prog, ref)
    assert max(nums.values()) < 1e-7, nums
    assert abs(ref["currents"][-1][1][3]) > 1.0


@pytest.mark.parametrize("bias", [23.85, 24.35])
def test_float32_control_fails_the_limits(bias):
    """At 488 nodes and the cell's 4 steps the float32 control fails at
    least one of the cell's limits; at 189,697 nodes it is read on the
    card by ``control.py``."""
    mesh = meshgen.pore_without_dna(30, 17)
    nums = control_numbers(mesh, CONF["system"], _surfaces(bias),
                           LIMITS["reference_steps"], "cpu")
    assert any(v > LIMITS["limits"][k] for k, v in nums.items()), nums
