"""The port's block-RAS tier and factor-amortized stepping against the
reference package on the CPU, on the 488-node pore case forced above the
dense tier (``dense_poisson_threshold=0``, blocks of 64 dofs: K = 8,
L = 103): both Poisson tiers, the species factor-reuse entry points of
both kinds, presolved runs with ``ras_refresh_every=4`` and a checkpoint
resume. Each test states its tolerance and the value it measured."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu.fem import assembly as JA
from pnp_tpu.fem import constraints as JC
from pnp_tpu.fem.geometry import build_volume_tables as j_tables
from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.structured import pore_without_dna_mesh
from pnp_tpu.operators import volume as JV
from pnp_tpu.operators.common import interp_grad as j_interp_grad
from pnp_tpu.solvers import block_ras as JBR
from pnp_tpu.solvers import direct as JD
from pnp_tpu.timestepping.tableaux import alexander2 as j_alexander2
from pnp_tpu.workloads import instationary_pnp_from_pb as JW
from pnp_tpu.workloads.common import make_scalar_context as j_context

from pnp_tpu_torch import interop, problems
from pnp_tpu_torch.utils import profiling as TPROF
from pnp_tpu_torch.workloads import instationary_pnp_from_pb as TW

from test_torch_host import jax_sysparams

torch.set_num_threads(1)

BS = 64
RAS = dict(dense_poisson_threshold=0, ras_block_size=BS)
STAGE_SLACK = 2e-4     # the reference's stage-tolerance bound (test_block_ras.py:190)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def slack(a, b) -> float:
    """max |a - b| / (max |b| + 1), the reference's cross-tier measure."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1.0))


@pytest.fixture(scope="module")
def case():
    tsys, tspace = problems.pore_case(30, 17)
    jsys = jax_sysparams(tsys)
    jspace = JFS(pore_without_dna_mesh(30, 17), 1)
    j_mid = JW.build_pnp_system(jsys, jspace, **RAS)
    pb = interop.field(j_mid.pb)
    t_mid = TW.build_pnp_system(tsys, tspace, pb_field=pb, device="cpu",
                                **RAS)
    j_ras = JW.build_pnp_system(jsys, jspace, pb_field=j_mid.pb,
                                poisson_inv_threshold=0, **RAS)
    t_ras = TW.build_pnp_system(tsys, tspace, pb_field=pb,
                                poisson_inv_threshold=0, **RAS, device="cpu")
    s0 = (j_mid.uphi0, j_mid.ucp0, j_mid.ucm0)
    uphi, _ = j_mid.poisson_solve(*s0)
    return dict(tsys=tsys, tspace=tspace, jsys=jsys, jspace=jspace,
                j_mid=j_mid, t_mid=t_mid, j_ras=j_ras, t_ras=t_ras, s0=s0,
                presolved=(uphi, s0[1], s0[2]))


def _t(state):
    return interop.state(*state)


def test_systems_take_the_block_ras_tier(case):
    t_mid, t_ras = case["t_mid"], case["t_ras"]
    assert (t_mid.factor_kind, t_mid.poisson_tier) == ("ras", "inverse")
    assert (t_ras.factor_kind, t_ras.poisson_tier) == ("ras", "ras")
    assert t_mid.species_dense_f32 is None and t_mid.pb_newton_iterations == 0
    jc = JBR.build_block_context_for_space(case["jspace"], BS)
    ctx = t_mid.block_context
    assert (ctx.K, ctx.B, ctx.L) == (jc.K, jc.B, jc.L) == (8, 61, 103)
    assert ctx.loc2glob.equal(interop.block_context(jc).loc2glob)
    assert tuple(t_mid.poisson_pre.shape) == (1, 488, 488)
    A = t_ras.species_local_f32(_t(case["presolved"])[0])
    assert tuple(A.shape) == (2, 8, 103, 103) and A.dtype == torch.float32
    # the port's own PB field through its phase A matches the reference's
    own = TW.build_pnp_system(case["tsys"], case["tspace"], device="cpu",
                              **RAS)
    assert own.pb_newton_iterations == case["j_mid"].pb_newton_iterations
    assert rel(own.pb, case["j_mid"].pb) <= 1e-10


def _jax_poisson_pre(case):
    """The reference's Poisson setup state of both tiers, built as its
    workload builds it (workloads/instationary_pnp_from_pb.py:358-514)."""
    jsys, jspace = case["jsys"], case["jspace"]
    ctx = j_context(jsys, jspace, component=0, quad_order=3)
    A_el = JV.poisson_jacobian_el(ctx.vt, jsys.cylindrical, jsys.pi)
    inv = JD.inv_f32_setup(JA.dense_constrained_matrix(
        A_el.astype(jnp.float32), ctx.vt.dofmap, jspace.ndof, ctx.free)[None])
    cr = JBR.build_block_context_for_space(jspace, BS)
    ras = (JBR.build_local_inverses(cr, A_el, ctx.free),
           JBR.build_p1_coarse(cr, A_el, ctx.vt.dofmap, ctx.free,
                               jspace.dof_coords))
    return inv, ras


def test_poisson_solve_tiers(case):
    """The 1e-10 Poisson re-solve on one state in both tiers of both
    packages: every pair within 1e-8 (the reference's cross-tier bound,
    tests/test_block_ras.py:279; measured ~1e-11). With the reference's
    inverse or RAS factors carried across, the same refinement/iteration
    counts and 1e-12 (measured ~1e-15)."""
    s0 = case["s0"]
    ts0 = _t(s0)
    phis = {}
    for name in ("mid", "ras"):
        phis["j_" + name], kj = case["j_" + name].poisson_solve(*s0)
        phis["t_" + name], kt = case["t_" + name].poisson_solve(*ts0)
        assert abs(kt - int(kj)) <= 1, (name, kt, int(kj))
    for a in phis:
        for b in phis:
            assert slack(phis[a], phis[b]) <= 1e-8, (a, b)
    jinv, jras = _jax_poisson_pre(case)
    for name, pre in (("mid", interop.poisson_inverse(jinv)),
                      ("ras", interop.ras_factor(jras))):
        got, kt = case["t_" + name].poisson_solve(*ts0, phi_pre=pre)
        _, kj = case["j_" + name].poisson_solve(*s0)
        assert kt == int(kj), (name, kt, int(kj))
        assert slack(got, phis["j_" + name]) <= 1e-12, name


def test_species_local_matrices_match_reference(case):
    """The port's species RAS local stage matrices (the input of its own
    factor) at the presolved potential against the reference's, built
    from the reference's element Jacobians, mass matrix, tableau
    coefficients and masks: 1e-6 relative (f32; measured 0)."""
    jsys, jspace = case["jsys"], case["jspace"]
    pi, phi = jsys.pi, case["presolved"][0]
    vt2, vt5 = j_tables(jspace, 2), j_tables(jspace, 5)
    M_el = JV.mass_jacobian_el(vt5, 1.0, False, pi)
    gphi = j_interp_grad(phi[vt2.dofmap], vt2.gradphi)
    K_pair = jnp.stack([JV.drift_diffusion_jacobian_el(gphi, vt2, z, False, pi)
                        for z in (1.0, -1.0)])
    tab = j_alexander2()
    a01, b01 = float(tab.A[0][1]), float(tab.B[0][1])
    free_pair = jnp.stack([jnp.asarray(JC.free_dof_mask(jspace, jsys, c))
                           for c in (1, 2)])
    want = JBR.assemble_local_matrices(
        JBR.build_block_context_for_space(jspace, BS),
        a01 * M_el[None] + (jsys.tau * b01) * K_pair, free_pair)
    got = case["t_mid"].species_local_f32(_t(case["presolved"])[0])
    assert tuple(got.shape) == tuple(want.shape) == (2, 8, 103, 103)
    assert rel(got, want) <= 1e-6, rel(got, want)


@pytest.mark.parametrize("two_level", [False, True])
def test_species_step_reuse_ras(case, two_level):
    """species_step_reuse and fused_step_reuse with the reference's RAS
    factor carried across (one-level, or with the batched p1 coarse
    level): the same Krylov iterations and 1e-10 (measured ~1e-13). The
    port's own factor (Gauss-Jordan local inverses): the reference's
    iterations within one (measured equal, 4 one-level), and with the
    fresh species step within the stage slack (measured ~1e-12)."""
    if two_level:
        kw = dict(pb_field=case["j_mid"].pb, species_two_level=True, **RAS)
        jsys_ = JW.build_pnp_system(case["jsys"], case["jspace"], **kw)
        kw["pb_field"] = interop.field(case["j_mid"].pb)
        tsys_ = TW.build_pnp_system(case["tsys"], case["tspace"],
                                    device="cpu", **kw)
    else:
        jsys_, tsys_ = case["j_mid"], case["t_mid"]
    js = case["presolved"]
    ts = _t(js)
    jf = jsys_.species_factor(js[0])
    tf = interop.ras_factor(jf)
    assert isinstance(tf, tuple) == two_level
    jcp, jcm, jk = jsys_.species_step_reuse(jf, *js)
    tcp, tcm, tk = tsys_.species_step_reuse(tf, *ts)
    assert tk == int(jk) > 0
    assert rel(tcp, jcp) <= 1e-10 and rel(tcm, jcm) <= 1e-10
    for a, b in zip(tsys_.fused_step_reuse(tf, *ts),
                    jsys_.fused_step_reuse(jf, *js)):
        assert rel(a, b) <= 1e-10
    own = tsys_.species_factor(ts[0])
    assert isinstance(own, tuple) == two_level
    ocp, ocm, ok_ = tsys_.species_step_reuse(own, *ts)
    assert abs(ok_ - int(jk)) <= 1, (ok_, int(jk))
    for a, b in zip((ocp, ocm), (jcp, jcm)):
        assert slack(a, b) <= STAGE_SLACK
    jcp2, jcm2, _ = jsys_.species_step(*js)
    for a, b in zip(tsys_.species_step(*ts)[:2], (jcp2, jcm2)):
        assert slack(a, b) <= STAGE_SLACK


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    out = tmp_path_factory.mktemp("scaled")
    res = {}
    for name, pit in (("mid", 49152), ("ras", 0)):
        kw = dict(n_steps=5, presolve_potential=True, ras_refresh_every=4,
                  poisson_inv_threshold=pit, **RAS)
        res["j_" + name] = JW.run_instationary_pnp_from_pb(
            case["jsys"], case["jspace"], **kw)
        res["t_" + name] = TW.run_instationary_pnp_from_pb(
            case["tsys"], case["tspace"], output_dir=str(out / name),
            checkpoint_path=str(out / f"{name}.npz"), checkpoint_freq=4,
            **kw, device="cpu")
    return res, out


@pytest.mark.parametrize("tier", ["mid", "ras"])
def test_run_matches_reference(case, runs, tier):
    """5 presolved steps with the factor refreshed every 4: fields and
    currents within the stage slack 2e-4 (measured ~1e-12); the factor is
    rebuilt on steps 0 and 4; per-step counts reported."""
    res, out = runs
    tr, jr = res["t_" + tier], res["j_" + tier]
    assert tr.pb_newton_iterations == jr.pb_newton_iterations
    for name in ("phi", "cp", "cm"):
        got = getattr(tr, name)
        assert torch.isfinite(got).all()
        assert slack(got, getattr(jr, name)) <= STAGE_SLACK, name
    assert len(tr.current_history) == len(jr.current_history) == 5
    for (ta, ipa, ima), (tb, ipb, imb) in zip(tr.current_history,
                                              jr.current_history):
        assert ta == tb
        assert slack(ipa, ipb) <= STAGE_SLACK and slack(ima, imb) <= STAGE_SLACK
    assert tr.factor_rebuilt == [True, False, False, False, True]
    assert len(tr.step_ms) == 5 and min(tr.species_iterations) > 0
    assert min(tr.poisson_iterations) > 0
    assert tr.system.poisson_tier == ("inverse" if tier == "mid" else "ras")
    rows = (out / tier / "current.dat").read_text().split("\n")
    assert len(rows) == 6 and rows[-1] == ""


def test_checkpoint_resume_at_step_4(case, runs):
    """Resume from the step-4 checkpoint: the refresh is keyed on the
    absolute step, so the resumed run rebuilds at step 4 as the
    uninterrupted one did and matches it to 1e-13 (measured 0)."""
    res, out = runs
    for tier, pit in (("mid", 49152), ("ras", 0)):
        resumed = TW.run_instationary_pnp_from_pb(
            case["tsys"], case["tspace"], n_steps=5, presolve_potential=True,
            ras_refresh_every=4, poisson_inv_threshold=pit,
            checkpoint_path=str(out / f"{tier}.npz"), resume=True, **RAS,
            device="cpu")
        assert resumed.factor_rebuilt == [True]
        assert len(resumed.current_history) == 1
        for name in ("phi", "cp", "cm"):
            assert rel(getattr(resumed, name),
                       getattr(res["t_" + tier], name)) <= 1e-13


def test_dense_factor_reuse():
    """The dense kind (the 488-node pore at the dense tier): species_factor,
    species_step_reuse and fused_step_reuse against the reference. With
    the reference's f32 stage inverses carried across: the same
    refinement counts and 1e-10 (measured ~1e-15). The port's own factor
    (Gauss-Jordan inverse): 1e-10 (refinement runs to convergence;
    measured ~1e-14)."""
    tsys, tspace = problems.pore_case(30, 17)
    jsys_ = JW.build_pnp_system(jax_sysparams(tsys),
                                JFS(pore_without_dna_mesh(30, 17), 1))
    tsys_ = TW.build_pnp_system(tsys, tspace,
                                pb_field=interop.field(jsys_.pb), device="cpu")
    assert tsys_.factor_kind == jsys_.factor_kind == "dense"
    s0 = (jsys_.uphi0, jsys_.ucp0, jsys_.ucm0)
    js = (jsys_.poisson_solve(*s0)[0], s0[1], s0[2])
    ts = _t(js)
    jf = jsys_.species_factor(js[0])
    tf = torch.tensor(np.asarray(jf))
    jcp, jcm, jk = jsys_.species_step_reuse(jf, *js)
    tcp, tcm, tk = tsys_.species_step_reuse(tf, *ts)
    assert tk == int(jk) and rel(tcp, jcp) <= 1e-10 and rel(tcm, jcm) <= 1e-10
    for a, b in zip(tsys_.fused_step_reuse(tf, *ts),
                    jsys_.fused_step_reuse(jf, *js)):
        assert rel(a, b) <= 1e-10
    own = tsys_.species_factor(ts[0])
    assert own.dtype == torch.float32 and own.shape == tf.shape
    for a, b in zip(tsys_.fused_step_reuse(own, *ts),
                    jsys_.fused_step_reuse(jf, *js)):
        assert rel(a, b) <= 1e-10


def test_unported_options_raise(case):
    """``species_inv_threshold`` no longer raises: the mid-size species
    tier builds the stage inverses at a refresh and tags them
    (tests/test_torch_large_tiers.py holds the tier to the reference).
    ``CG_AMG_SSOR`` no longer raises: phase A's Newton runs CG under the
    two-level AMG (the reference's Newton count, the PB field to 1e-10)
    and the Poisson re-solve takes the Krylov tier with an aggregation of
    its own (the reference's field to 1e-9)."""
    tsys, tspace = case["tsys"], case["tspace"]
    mid = TW.build_pnp_system(tsys, tspace, species_inv_threshold=20000,
                              pb_field=case["t_mid"].pb, device="cpu", **RAS)
    assert (mid.factor_kind, mid.poisson_tier) == ("ras", "inverse")
    ts = _t(case["presolved"])
    kind, X = factor = mid.species_factor(ts[0])
    assert kind == "inv" and tuple(X.shape) == (2, 488, 488)
    cp, cm, k = mid.species_step_reuse(factor, *ts)
    want_cp, want_cm, _ = case["t_mid"].species_step(*ts)
    assert 0 < k <= 8
    assert slack(cp, want_cp) <= STAGE_SLACK
    assert slack(cm, want_cm) <= STAGE_SLACK
    import dataclasses
    amg = dataclasses.replace(tsys, linearSolver="CG_AMG_SSOR")
    t_amg = TW.build_pnp_system(amg, tspace, **RAS, device="cpu")
    j_amg = JW.build_pnp_system(jax_sysparams(amg), case["jspace"], **RAS)
    assert (t_amg.factor_kind, t_amg.poisson_tier) == (None, "krylov")
    assert t_amg.pb_newton_iterations == int(j_amg.pb_newton_iterations) > 0
    assert rel(t_amg.pb, j_amg.pb) <= 1e-10, rel(t_amg.pb, j_amg.pb)
    tu, tk = t_amg.poisson_solve(t_amg.uphi0, t_amg.ucp0, t_amg.ucm0)
    ju, jk = j_amg.poisson_solve(j_amg.uphi0, j_amg.ucp0, j_amg.ucm0)
    assert abs(tk - int(jk)) <= 1 and rel(tu, ju) <= 1e-9, rel(tu, ju)
    # the other variants above the dense tier no longer raise: species
    # stages and Poisson by the variant (tests/test_torch_species_krylov.py)
    cg = dataclasses.replace(tsys, linearSolver="CG_Jacobi")
    system = TW.build_pnp_system(cg, tspace, pb_field=case["t_mid"].pb,
                                 **RAS, device="cpu")
    assert (system.factor_kind, system.poisson_tier) == (None, "krylov")


def test_profiling(tmp_path):
    """PhaseTimer times and counts phases; maybe_trace writes a trace and
    the recorder's summary beside it, whose counters count the host reads
    made through ``host_read``."""
    timer = TPROF.PhaseTimer()
    x = torch.ones(64, dtype=torch.float64)
    with TPROF.maybe_trace(str(tmp_path / "tr")) as prof:
        for _ in range(2):
            with timer.phase("matvec", sync=(x,)):
                y = x @ x
        assert TPROF.host_read(y) == 64.0
    assert prof is not None and float(y) == 64.0
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert timer.counts["matvec"] == 2 and timer.ms("matvec") >= 0.0
    assert "matvec" in timer.report()
    with TPROF.maybe_trace(None) as none:
        assert none is None
    summary = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert summary["counters"] == {"host_syncs": 1, "amg_builds": 0}
    assert summary["spans"]["host.sync"]["count"] == 1
    assert TPROF.counters == TPROF.Counters(host_syncs=1)
