"""The port's measurement and step entry points (``pnp_tpu_torch/bench.py``,
``pnp_tpu_torch/entry.py``) against the reference package on the CPU, on
the bench's case at a small base: ``pore_case(30, 17)`` (488 nodes) and
its refinement (1,827 nodes) in place of ``pore_case(80, 44)``. The
headline's presolved steps and ``entry()``'s step to 1e-10 (the dense
tier's bound), the scaled level forced onto the block-RAS tier to 2e-4 of
max + 1 (the reference's stage-slack bound) with iteration counts within
one, the multi-shard dry run's plan against the reference's on the 8
virtual devices of tests/conftest.py, and the command line's output."""

import functools
import json
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.refine import refine_uniform as j_refine
from pnp_tpu.meshio.structured import pore_without_dna_mesh
from pnp_tpu.parallel.dist import build_dist_context as j_dist
from pnp_tpu.parallel.sharding import make_device_mesh
from pnp_tpu.workloads import instationary_pnp_from_pb as JW

from pnp_tpu_torch import bench as B
from pnp_tpu_torch import entry as EN
from pnp_tpu_torch.workloads import distributed_pnp as TD

from test_torch_host import jax_sysparams

torch.set_num_threads(1)

BASE = (30, 17)
RAS = dict(dense_poisson_threshold=0, ras_block_size=64)
RTOL = 1e-10           # the dense tier (tests/test_torch_slice.py)
STAGE_SLACK = 2e-4     # the reference's stage-tolerance bound (test_block_ras.py:190)
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "config_overrides",
                 "phases", "scaled"}
SCALED_KEYS = {"nodes", "dofs_per_s", "step_ms", "ras_refresh_every",
               "phases", "poisson_tier", "peak_gib"}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def slack(a, b) -> float:
    """max |a - b| / (max |b| + 1), the reference's cross-tier measure."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1.0))


def j_case(levels: int):
    """The reference's Sysparams and space of the port's ``_load``."""
    tsys, tspace = B._load(levels, BASE)
    mesh = pore_without_dna_mesh(*BASE)
    if levels:
        mesh = j_refine(mesh, levels)
    assert np.array_equal(np.asarray(mesh.nodes), tspace.mesh.nodes)
    assert np.array_equal(np.asarray(mesh.tris), tspace.mesh.tris)
    return jax_sysparams(tsys), JFS(mesh, 1)


def j_presolved(j):
    return j.poisson_solve(j.uphi0, j.ucp0, j.ucm0)[0], j.ucp0, j.ucm0


def test_headline_matches_reference():
    """run_headline with one timed step (3 presolved steps in all) against
    the reference's fused_step loop from its presolved state: 1e-10
    (measured 2.1e-14)."""
    out, state = B.run_headline(1, base=BASE, device="cpu")
    j = JW.build_pnp_system(*j_case(0))
    s = j_presolved(j)
    for _ in range(3):
        s = j.fused_step(*s)
    for a, b in zip(state, s):
        assert rel(a, b) <= RTOL
    assert (out["nodes"], out["triangles"], out["poisson_tier"]) == \
        (488, 852, "dense")
    assert out["pb_newton_iterations"] == j.pb_newton_iterations
    assert set(out["phases"]) == {"species_ms", "poisson_ms",
                                  "fused_step_ms"}
    assert out["value"] > 0 and out["peak_gib"] is None
    assert set(out["launches"].values()) == {0}          # CPU: plain paths


def test_scaled_matches_reference():
    """run_scaled on L1 forced onto the block-RAS tier (K = 29 blocks of 64)
    against the reference's species_factor + fused_step_reuse block and
    phase protocol: fields to 2e-4 of max + 1 (measured 1.4e-11), the
    phases' iteration counts within one."""
    out, state = B.run_scaled(1, n_meas=2, base=BASE, device="cpu", **RAS)
    j = JW.build_pnp_system(*j_case(1), **RAS)

    def block(s, n):
        factor = j.species_factor(s[0])
        for _ in range(n):
            s = j.fused_step_reuse(factor, *s)
        return s

    s = block(block(j_presolved(j), 1), 2)
    for a, b in zip(state, s):
        assert slack(a, b) <= STAGE_SLACK
    uphi = s[0]
    ucp, ucm, _ = j.species_step_reuse(j.species_factor(uphi), *s)
    uphi2, _ = j.poisson_solve(uphi, ucp, ucm)
    ucp, ucm, k_sp = j.species_step_reuse(j.species_factor(uphi2), uphi2,
                                          ucp, ucm)
    _, k_po = j.poisson_solve(uphi2, ucp, ucm)
    ph = out["phases"]
    assert abs(ph["species_stage_iters"] - int(k_sp)) <= 1
    assert abs(ph["poisson_iters"] - int(k_po)) <= 1
    assert (out["nodes"], out["triangles"]) == (1827, 3408)
    assert out["poisson_tier"] == "inverse" and out["ras_refresh_every"] == 4
    assert SCALED_KEYS <= set(out)


def test_entry_step_matches_reference():
    """entry()'s fn(*args) against the reference's fused_step from its
    presolved start with a zero PB field: 1e-10 (measured 8.8e-14)."""
    fn, args = EN.entry("cpu", base=BASE)
    got = fn(*args)
    jsys, jspace = j_case(0)
    j = JW.build_pnp_system(jsys, jspace, pb_field=jnp.zeros(jspace.ndof))
    s = j_presolved(j)
    for a, b in zip(args, s):
        assert rel(a, b) <= RTOL
    for a, b in zip(got, j.fused_step(*s)):
        assert rel(a, b) <= RTOL


def test_dryrun_multichip_plan_matches_reference(monkeypatch, capsys):
    """dryrun_multichip(8) reports the reference plan's Kb, B_N and B_H on
    8 virtual devices; its large run takes two-level Schwarz (forced here:
    1,827 dofs)."""
    monkeypatch.setattr(TD, "TWO_LEVEL_DOFS", 0)
    out = EN.dryrun_multichip(8, "cpu", base=BASE)
    jsys, jspace = j_case(0)
    jc = j_dist(jspace, make_device_mesh(8))
    assert (out["Kb"], out["B_N"], out["B_H"]) == \
        (jc.Kb, jc.plan.B_N, jc.plan.B_H)
    assert (out["ndof"], out["E"], out["pb_newton"]) == (488, 852, 4)
    assert all(bool(torch.isfinite(t).all()) for t in out["state"])
    large = out["large"]
    assert (large["ndof"], large["poisson_tier"]) == (1827, "two_level")
    printed = capsys.readouterr().out
    assert (f"dryrun_multichip: OK on 8 shards (ndof=488, E=852, "
            f"Kb={jc.Kb}, B_N={jc.plan.B_N}, B_H={jc.plan.B_H}, "
            "pb_newton=4)") in printed
    assert "dryrun_multichip_large: OK on 8 shards (ndof=1827" in printed


def test_dryrun_large_refuses_one_level():
    """Below TWO_LEVEL_DOFS the large dry run raises: it exists to run the
    two-level Schwarz tier."""
    with pytest.raises(RuntimeError, match="not two-level"):
        EN.dryrun_multichip_large(2, device="cpu", base=BASE)


def test_drybuild_prints_ok(capsys):
    state = B.run_drybuild(base=BASE, device="cpu")
    assert capsys.readouterr().out.strip() == "DRYBUILD-OK"
    assert all(bool(torch.isfinite(t).all()) for t in state)


def test_main_prints_the_headline_then_the_full_line(monkeypatch, capsys):
    """The command line's JSON: the headline line first with ``scaled``
    empty, then the line with every level; bench.py's keys, vs_baseline
    null, no overrides, and nothing else null but the peak memory, which
    the CPU does not have."""
    monkeypatch.setattr(B, "run_headline",
                        functools.partial(B.run_headline, 1, base=BASE))
    monkeypatch.setattr(B, "run_level", lambda levels, n, device=None:
                        B.run_scaled(levels, n, base=BASE, device=device,
                                     **RAS)[0])
    monkeypatch.setattr(B, "LADDER", ((1, 1),))
    assert B.main(["--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 2 and lines[0]["scaled"] == []
    line = lines[-1]
    assert HEADLINE_KEYS <= set(line)
    assert (line["metric"], line["unit"], line["vs_baseline"],
            line["config_overrides"], line["case"], line["card"]) == \
        (B.METRIC, "DOF/s", None, {}, B.CASE, "cpu")
    assert {k: v for k, v in line.items() if k != "scaled"} == \
        {k: v for k, v in lines[0].items() if k != "scaled"}
    assert len(line["scaled"]) == 1 and SCALED_KEYS <= set(line["scaled"][0])
    assert B.null_or_nonfinite(line) == [".peak_gib", ".scaled[0].peak_gib"]


def test_main_scaled_prints_one_level(monkeypatch, capsys):
    """``--scaled L N``, a level's own process, prints its result after
    ``SCALED-JSON:``."""
    monkeypatch.setattr(B, "run_scaled",
                        functools.partial(B.run_scaled, base=BASE, **RAS))
    assert B.main(["--scaled", "1", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("SCALED-JSON:")
    level = json.loads(out[len("SCALED-JSON:"):])
    assert level["nodes"] == 1827 and SCALED_KEYS <= set(level)


def test_level_that_fails_or_runs_out_of_time_raises(monkeypatch):
    """A level's process that fails, or outlasts its limit, fails the
    bench: no null in its place."""
    with pytest.raises(RuntimeError, match="scaled L1: exit"):
        B.run_level(1, 1, device="no-such-device")
    monkeypatch.setitem(B.LEVEL_TIMEOUT_S, 1, 0.5)
    with pytest.raises(subprocess.TimeoutExpired):
        B.run_level(1, 1, device="cpu")


@pytest.mark.parametrize("value, bad", [
    ({"a": 1.0, "vs_baseline": None}, []),
    ({"a": [1, None], "b": {"c": float("nan")}}, [".a[1]", ".b.c"]),
    ({"a": float("inf")}, [".a"]),
])
def test_null_or_nonfinite(value, bad):
    assert B.null_or_nonfinite(value) == bad
