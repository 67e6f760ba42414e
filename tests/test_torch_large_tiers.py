"""The very-large Poisson inverse tier and the mid-size species inverse
tier of the port, on the CPU at the 488-node pore case forced above the
dense tier (``dense_poisson_threshold=0``, blocks of 64 dofs).

Both tiers are gated to a TPU in the reference, so neither runs there as
a whole under JAX-CPU. The very-large setup is held against the reference's
own pieces (its diagonal, its ``_phi_parts`` formula written out, its
Pallas Gauss-Jordan in interpret mode, its ``scaled_inv_apply``); the tier
as a whole against the mid-size tier of both packages; the mid-size
species tier against the reference's dense tier on one state and against
the port's own dense-species run. Each test states its tolerance and the
value it measured."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu.fem import assembly as JA
from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.structured import pore_without_dna_mesh
from pnp_tpu.operators import volume as JV
from pnp_tpu.operators.pallas_kernels import batched_inverse_pallas
from pnp_tpu.solvers import direct as JD
from pnp_tpu.workloads import instationary_pnp_from_pb as JW
from pnp_tpu.workloads.common import make_scalar_context as j_context

from pnp_tpu_torch import interop, problems
from pnp_tpu_torch.solvers import direct as TD
from pnp_tpu_torch.workloads import instationary_pnp_from_pb as TW

from test_torch_host import jax_sysparams

torch.set_num_threads(1)

RAS = dict(dense_poisson_threshold=0, ras_block_size=64)
TIER_REL_TOL = 1e-8    # the reference's cross-tier bound (test_block_ras.py:279)
STAGE_SLACK = 2e-4     # its stage-tolerance bound (test_block_ras.py:190)
NDOF = 488


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def slack(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1.0))


@pytest.fixture(scope="module")
def case():
    tsys, tspace = problems.pore_case(30, 17)
    jsys = jax_sysparams(tsys)
    jspace = JFS(pore_without_dna_mesh(30, 17), 1)
    j_mid = JW.build_pnp_system(jsys, jspace, **RAS)
    pb = interop.field(j_mid.pb)
    s0 = (j_mid.uphi0, j_mid.ucp0, j_mid.ucm0)
    uphi, _ = j_mid.poisson_solve(*s0)
    return dict(tsys=tsys, tspace=tspace, jsys=jsys, jspace=jspace,
                j_mid=j_mid, pb=pb, s0=s0, presolved=(uphi, s0[1], s0[2]))


@pytest.fixture()
def forced_large(monkeypatch):
    """The very-large tier at small size: the mid-size bound set to 0."""
    monkeypatch.setattr(TW, "POISSON_INV_MAX_DOFS", 0)


def _large_system(case, **kw):
    return TW.build_pnp_system(case["tsys"], case["tspace"],
                               pb_field=case["pb"], device="cpu", **RAS, **kw)


def test_scaled_inv_apply_matches_reference():
    """d = S (X_eq (S r)) on the same (X_eq, s) and r through both
    packages: 1e-6 relative (f32 sums in another order; measured 1.5e-7).
    The reference's 128-padded pair gives the same apply as its crop."""
    rng = np.random.RandomState(3)
    n, Np = 200, 256
    X = np.eye(Np, dtype=np.float32)
    X[:n, :n] = rng.standard_normal((n, n)).astype(np.float32)
    s = np.ones(Np, np.float32)
    s[:n] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    r = rng.standard_normal((1, n))
    want = np.asarray(JD.scaled_inv_apply(
        (jnp.asarray(X[None]), jnp.asarray(s)), jnp.asarray(r)))
    pre = interop.poisson_inverse((X[None], s), ndof=n)
    assert tuple(pre[0].shape) == (1, n, n) and tuple(pre[1].shape) == (n,)
    got = TD.scaled_inv_apply(pre, torch.tensor(r))
    assert got.dtype == torch.float64 and tuple(got.shape) == (1, n)
    assert rel(got, want) <= 1e-6, rel(got, want)
    # the plain form is untouched by the tuple branch
    plain = TD.scaled_inv_apply(pre[0], torch.tensor(r))
    assert rel(plain, X[:n, :n].astype(np.float64) @ r[0]) <= 1e-6


def _reference_large_setup(case):
    """The reference's equilibrated Poisson matrix, scale and inverse at
    the unpadded size, from the pieces its very-large branch uses
    (workloads/instationary_pnp_from_pb.py:413-426, ``_phi_parts``)."""
    jsys, jspace = case["jsys"], case["jspace"]
    ctx = j_context(jsys, jspace, component=0, quad_order=3)
    dm, n = ctx.vt.dofmap, jspace.ndof
    A_el = JV.poisson_jacobian_el(ctx.vt, jsys.cylindrical, jsys.pi)
    d = JA.constrained_diagonal(A_el, dm, n, ctx.free)
    sc = (1.0 / jnp.sqrt(jnp.maximum(jnp.abs(d), 1e-30))).astype(jnp.float32)
    free32 = ctx.free.astype(jnp.float32)
    w_el = (free32 * sc)[dm]
    Am = A_el.astype(jnp.float32) * w_el[:, :, None] * w_el[:, None, :]
    A_eq = jnp.zeros((n, n), jnp.float32).at[
        dm[:, :, None], dm[:, None, :]].add(Am)
    A_eq = A_eq + jnp.diag(1.0 - free32)
    X_eq = batched_inverse_pallas(A_eq[None], interpret=True,
                                  equilibrate=False)
    op = JA.make_constrained_operator_batched(A_el[None], dm, n,
                                              ctx.free[None])
    return A_eq, sc, X_eq, op


def test_large_setup_matches_reference_pieces(case, forced_large):
    """The port's (X_eq, s) against the reference's pieces: the scale to
    1e-6 (f64 rsqrt rounded to f32; measured 0); the inverse to 1e-3 of
    its largest entry (two f32 eliminations in different pivot orders;
    measured 1.6e-6) and ||A_eq X_eq - I|| <= 1e-4 on the reference's
    equilibrated matrix (the port frees its own; measured 2.9e-6); the
    apply on a seeded residual to 1e-4 (measured 5.5e-7). The reference's
    pair carried across serves the port's re-solve, and the re-solve
    agrees with the reference's mid-size tier to TIER_REL_TOL (measured
    2.3e-11)."""
    system = _large_system(case)
    assert system.poisson_tier == "inverse_large"
    X_eq, s = system.poisson_pre
    assert tuple(X_eq.shape) == (1, NDOF, NDOF) and X_eq.dtype == torch.float32
    assert tuple(s.shape) == (NDOF,) and s.dtype == torch.float32
    A_eq_j, s_j, X_eq_j, op_j = _reference_large_setup(case)
    assert rel(s, s_j) <= 1e-6, rel(s, s_j)
    # Dirichlet rows carry s = 1 and the identity
    free = TW.C.free_dof_mask(case["tspace"], case["tsys"], 0)
    assert np.all(s.numpy()[~free] == 1.0)
    assert rel(X_eq, X_eq_j) <= 1e-3, rel(X_eq, X_eq_j)
    # X_eq inverts the reference's equilibrated matrix: ||A_eq X - I||
    resid = np.asarray(A_eq_j, np.float64) @ X_eq[0].numpy().astype(
        np.float64) - np.eye(NDOF)
    assert np.abs(resid).max() <= 1e-4, np.abs(resid).max()
    r = np.random.RandomState(5).standard_normal((1, NDOF))
    r[:, ~free] = 0.0
    want = np.asarray(JD.scaled_inv_apply((X_eq_j, s_j), jnp.asarray(r)))
    got = TD.scaled_inv_apply(system.poisson_pre, torch.tensor(r))
    assert rel(got, want) <= 1e-4, rel(got, want)
    # the reference's inverse carried across serves the port's re-solve
    ts0 = interop.state(*case["s0"])
    own, k_own = system.poisson_solve(*ts0)
    carried, k_car = system.poisson_solve(
        *ts0, phi_pre=interop.poisson_inverse((X_eq_j, s_j), ndof=NDOF))
    assert abs(k_own - k_car) <= 1
    assert slack(own, carried) <= TIER_REL_TOL
    want_phi, _ = case["j_mid"].poisson_solve(*case["s0"])
    assert slack(own, want_phi) <= TIER_REL_TOL, slack(own, want_phi)


def test_large_setup_probe(case):
    """``inv_f32_setup_large`` probes against the element operator: the
    equilibrated matrix passes; three times that matrix gives an inverse
    whose refinement stalls at (2/3)^2 > 0.25 and reads False, counted in
    ``probe_failures`` and raising nothing."""
    A_eq_j, s_j, _, _ = _reference_large_setup(case)
    mid = _large_system(case)          # the mid-size tier: for its operator
    assert mid.poisson_tier == "inverse"
    from pnp_tpu_torch.fem import assembly as FA
    from pnp_tpu_torch.operators import volume as V
    from pnp_tpu_torch.workloads.common import make_scalar_context
    tsys, tspace = case["tsys"], case["tspace"]
    ctx = make_scalar_context(tsys, tspace, component=0, quad_order=3,
                              device="cpu")
    A_el = V.poisson_jacobian_el(ctx.vt, tsys.cylindrical, tsys.pi)
    op = FA.make_constrained_operator(A_el[None], ctx.vt.dofmap, NDOF,
                                      ctx.free[None])
    A_eq = torch.tensor(np.asarray(A_eq_j))[None]
    s = torch.tensor(np.asarray(s_j))
    n0 = TD.probe_failures["count"]
    X, ok = TD.inv_f32_setup_large(A_eq, s, op)
    assert ok and TD.probe_failures["count"] == n0
    assert rel(X, mid.poisson_pre / (s[:, None] * s[None, :])) <= 1e-3
    X3, ok3 = TD.inv_f32_setup_large(3.0 * A_eq, s, op)
    assert not ok3 and TD.probe_failures["count"] == n0 + 1
    assert torch.isfinite(X3).all()
    with pytest.raises(ValueError):
        TD.inv_f32_setup_large(torch.cat([A_eq, A_eq]), s, op)


def test_failed_probe_keeps_two_level_ras(case, forced_large, monkeypatch):
    """A False verdict of the very-large probe is a result, not an error:
    the system keeps the two-level RAS Poisson and says so."""
    real = TD.K.gj_inverse

    def off_by_three(A, equilibrate=True):
        """Kernel 1 with the very-large tier's call (no equilibration of
        its own) scaled so that its refinement no longer contracts."""
        X = real(A, equilibrate)
        return X if equilibrate else X / 3.0

    monkeypatch.setattr(TD.K, "gj_inverse", off_by_three)
    n0 = TD.probe_failures["count"]
    system = _large_system(case)
    assert system.poisson_tier == "ras"
    assert TD.probe_failures["count"] == n0 + 1
    inv_p, p1_p = system.poisson_pre
    assert inv_p.dtype == torch.float32 and len(p1_p) == 3
    ts0 = interop.state(*case["s0"])
    phi, k = system.poisson_solve(*ts0)
    want, _ = case["j_mid"].poisson_solve(*case["s0"])
    assert slack(phi, want) <= TIER_REL_TOL


def test_large_tier_run_matches_mid_size_tier(case, forced_large, monkeypatch):
    """Five presolved steps on the very-large tier against the port's
    mid-size tier and against the reference's mid-size tier: fields and
    currents to TIER_REL_TOL (measured <= 2.1e-11), refinement counts within
    one of the port's mid-size tier at every step."""
    tsys, tspace = case["tsys"], case["tspace"]
    kw = dict(n_steps=5, presolve_potential=True, ras_refresh_every=4, **RAS)
    large = TW.run_instationary_pnp_from_pb(tsys, tspace, device="cpu", **kw)
    assert large.system.poisson_tier == "inverse_large"
    monkeypatch.setattr(TW, "POISSON_INV_MAX_DOFS", 16384)
    mid = TW.run_instationary_pnp_from_pb(tsys, tspace, device="cpu", **kw)
    assert mid.system.poisson_tier == "inverse"
    ref = JW.run_instationary_pnp_from_pb(case["jsys"], case["jspace"], **kw)
    for other in (mid, ref):
        for name in ("phi", "cp", "cm"):
            a, b = getattr(large, name), getattr(other, name)
            assert slack(a, b) <= TIER_REL_TOL, (name, slack(a, b))
        for (_, ip, im), (_, jp, jm) in zip(large.current_history,
                                            other.current_history):
            assert slack(np.concatenate([ip, im]),
                         np.concatenate([jp, jm])) <= TIER_REL_TOL
    assert large.species_iterations == mid.species_iterations
    for a, b in zip(large.poisson_iterations, mid.poisson_iterations):
        assert abs(a - b) <= 1, (large.poisson_iterations,
                                 mid.poisson_iterations)
    assert large.factor_kinds == ["ras"] * 5


# ---- the mid-size species tier ----------------------------------------------

@pytest.fixture(scope="module")
def mid_species(case):
    return TW.build_pnp_system(case["tsys"], case["tspace"],
                               pb_field=case["pb"], device="cpu",
                               species_inv_threshold=NDOF, **RAS)


def test_mid_species_factor_matches_reference_dense_tier(case, mid_species):
    """The species update does not depend on the Poisson tier: on one
    presolved state the mid-size species tier's factor and reuse step give
    the (ucp, ucm) of the reference's dense tier: STAGE_SLACK bound
    (measured 8e-16: both refine to the same f64 residual target), the
    same refinement count; with the reference's inverses carried across
    1e-10 (measured 3.4e-15)."""
    j_dense = JW.build_pnp_system(case["jsys"], case["jspace"],
                                  pb_field=case["j_mid"].pb)
    assert j_dense.factor_kind == "dense"
    js = case["presolved"]
    ts = interop.state(*js)
    jf = j_dense.species_factor(js[0])
    jcp, jcm, jk = j_dense.species_step_reuse(jf, *js)
    assert mid_species.factor_kind == "ras"        # as in the reference
    kind, X = factor = mid_species.species_factor(ts[0])
    assert kind == "inv" and tuple(X.shape) == (2, NDOF, NDOF)
    assert X.dtype == torch.float32
    tcp, tcm, tk = mid_species.species_step_reuse(factor, *ts)
    assert tk == int(jk), (tk, int(jk))
    for a, b in zip((tcp, tcm), (jcp, jcm)):
        assert slack(a, b) <= STAGE_SLACK, slack(a, b)
    carried = interop.species_factor(("inv", jf))
    ccp, ccm, ck = mid_species.species_step_reuse(carried, *ts)
    assert ck == int(jk)
    assert rel(ccp, jcp) <= 1e-10 and rel(ccm, jcm) <= 1e-10
    # fused_step_reuse dispatches on the tag as well
    for a, b in zip(mid_species.fused_step_reuse(factor, *ts)[1:],
                    (tcp, tcm)):
        assert torch.equal(a, b)


def test_mid_species_run_matches_dense_species_run(case):
    """Five presolved steps with a refresh every 2 on the mid-size species
    tier against the port's dense tier (a fresh inverse every step): the
    stage-tolerance bound STAGE_SLACK (measured 4.6e-10); every window ran
    on inverses and says so."""
    tsys, tspace = case["tsys"], case["tspace"]
    kw = dict(n_steps=5, presolve_potential=True, device="cpu")
    mid = TW.run_instationary_pnp_from_pb(
        tsys, tspace, ras_refresh_every=2, species_inv_threshold=NDOF,
        **RAS, **kw)
    dense = TW.run_instationary_pnp_from_pb(tsys, tspace, **kw)
    assert mid.factor_kinds == ["inv"] * 5
    assert mid.factor_rebuilt == [True, False, True, False, True]
    assert dense.factor_kinds == ["dense"] * 5
    for name in ("phi", "cp", "cm"):
        a, b = getattr(mid, name), getattr(dense, name)
        assert slack(a, b) <= STAGE_SLACK, (name, slack(a, b))
    # below the threshold the option leaves the RAS factor alone
    off = TW.build_pnp_system(tsys, tspace, pb_field=case["pb"], device="cpu",
                              species_inv_threshold=NDOF - 1, **RAS)
    ts = interop.state(*case["presolved"])
    assert isinstance(off.species_factor(ts[0]), torch.Tensor)


def test_mid_species_failed_probe_runs_window_on_ras(case, monkeypatch):
    """A refresh whose stage inverses fail the contraction probe keeps the
    RAS factor for its window, and the run says which windows did: here
    the first refresh's verdict is forced False, the second passes."""
    verdicts = iter([False, True])
    real = TD.contraction_ok
    monkeypatch.setattr(TD, "contraction_ok",
                        lambda A, X: real(A, X) and next(verdicts))
    n0 = TD.probe_failures["count"]
    tsys, tspace = case["tsys"], case["tspace"]
    run = TW.run_instationary_pnp_from_pb(
        tsys, tspace, n_steps=4, presolve_potential=True, device="cpu",
        ras_refresh_every=2, species_inv_threshold=NDOF, **RAS)
    assert run.factor_kinds == ["ras", "ras", "inv", "inv"]
    assert TD.probe_failures["count"] == n0 + 1
    monkeypatch.undo()
    want = TW.run_instationary_pnp_from_pb(
        tsys, tspace, n_steps=4, presolve_potential=True, device="cpu",
        ras_refresh_every=2, **RAS)
    assert want.factor_kinds == ["ras"] * 4
    # the RAS window took the RAS path's iterations, the inverse window
    # the refinement's
    assert run.species_iterations[:2] == want.species_iterations[:2]
    for name in ("phi", "cp", "cm"):
        assert slack(getattr(run, name), getattr(want, name)) <= STAGE_SLACK


def test_raw_biased_start_diverges_in_both_packages(case):
    """A property of the in-code pore case (24.1 bias, tau 1), not of the
    port: without ``presolve_potential`` the first species step sees the
    raw bias jump and the run leaves the physical range within six steps in
    the reference as in the port (concentrations beyond 1e3 where the
    presolved run stays below 10; c0 = 0.06). The command line of either
    package has no presolve switch, so it runs the production workload on
    other cases. The diverged states are not compared."""
    kw = dict(n_steps=6, **RAS)
    rt = TW.run_instationary_pnp_from_pb(case["tsys"], case["tspace"],
                                         device="cpu", **kw)
    rj = JW.run_instationary_pnp_from_pb(case["jsys"], case["jspace"], **kw)
    ok = TW.run_instationary_pnp_from_pb(case["tsys"], case["tspace"],
                                         presolve_potential=True,
                                         device="cpu", **kw)
    assert float(rt.cp.abs().max()) > 1e3
    assert float(np.abs(np.asarray(rj.cp)).max()) > 1e3
    assert float(ok.cp.abs().max()) < 10.0 and float(ok.cm.abs().max()) < 10.0
