"""The very-large Poisson inverse configuration (``pore_pnp_L2``) on the
CPU at small pore sizes: the port on its very-large tier against the
plain reference, which solves Poisson by SuperLU whatever the program's
tier, and the float32 control against the cell's limits."""

import json

import pytest

from benchmark import meshgen
from benchmark.control import control_numbers
from benchmark.reference import compare, pnp as reference
from benchmark.tests.cells import BENCH
from benchmark.tests.test_bench_reference import _program

from pnp_tpu_torch.workloads import instationary_pnp_from_pb as W

CELL = "pore_pnp_L2.transient"
CONF = json.loads((BENCH / "configs" / "pore_pnp_L2.json").read_text())
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())


def _surfaces(bias):
    surfaces = [dict(s) for s in CONF["surfaces"]]
    surfaces[CONF["bias_surface"]]["coulombPotential"] = bias
    return surfaces


def test_the_configuration_is_the_l3_case_refined_twice():
    l3 = json.loads((BENCH / "configs" / "pore_pnp_L3.json").read_text())
    assert CONF["mesh"] == dict(l3["mesh"], refine_levels=2)
    for key in ("system", "surfaces", "bias_surface", "reduced"):
        assert CONF[key] == l3[key]
    # the case is L3's; the source names the geometry whose mesh this is
    assert CONF["case"] == l3["source"]
    assert CONF["source"] != l3["source"]
    assert "pore_without_dna.geo" in CONF["source"]
    assert CONF["reduced"] == ["mesh"]
    assert LIMITS["reference_steps"] == 16
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    (work,) = [w for w in spec["workloads"] if w["name"] == CELL]
    assert (work["config"], work["traffic"], work["chips"]) == (
        "pore_pnp_L2", "transient", 1)


def test_reference_matches_port_on_the_very_large_tier(monkeypatch):
    """1,827 nodes with the very-large Poisson tier forced (its mid-size
    bound set to 0, blocks of 64 dofs): one equilibrated f32 inverse by
    kernel 1's plain version, each re-solve refined to 1e-10, block-RAS
    species; 8 presolved steps against SuperLU, held to the block-RAS
    case's 1e-7, since the species stages stop at 1e-5 as there
    (measured 2.7e-9, ``c_err``)."""
    monkeypatch.setattr(W, "POISSON_INV_MAX_DOFS", 0)
    mesh = meshgen.refine(meshgen.pore_without_dna(30, 17), 1)
    surfaces = _surfaces(24.2)
    S, prog = _program(mesh, CONF["system"], surfaces, 8,
                       dense_poisson_threshold=0, ras_block_size=64)
    assert (S.factor_kind, S.poisson_tier) == ("ras", "inverse_large")
    ref = reference.run(mesh, CONF["system"], surfaces, 8)
    nums = compare.numbers(prog, ref)
    assert nums["pb_err"] < 1e-13
    assert max(nums.values()) < 1e-7, nums
    assert abs(ref["currents"][-1][1][3]) > 1.0


@pytest.mark.parametrize("bias", [23.85, 24.35])
def test_float32_control_fails_the_limits(bias):
    """At 488 nodes and the cell's 16 steps the float32 control fails at
    least one of the cell's limits at both ends of the bias band (three
    of its four numbers do: ``pb_err`` 1.5e-7, ``phi_err`` 9.6e-5 and
    more, ``c_err`` 8.9e-6 and more; ``current_err`` 3.6e-5 to 5.2e-5
    stays below its 1e-4); at 47,745 nodes it is read on the card by
    ``control.py``."""
    mesh = meshgen.pore_without_dna(30, 17)
    nums = control_numbers(mesh, CONF["system"], _surfaces(bias),
                           LIMITS["reference_steps"], "cpu")
    assert any(v > LIMITS["limits"][k] for k, v in nums.items()), nums
