"""Solver layer of the port against the reference package on the CPU, on
the 488-node pore case: preconditioners, Krylov (single and batched),
every linear-solver variant, Newton through ``solve_pb``, and the dense
direct pieces. Iterates agree to 1e-10 relative (f64 recurrences whose
dots sum in another order than XLA's)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu.fem import assembly as JA
from pnp_tpu.solvers import direct as JD
from pnp_tpu.solvers import krylov as JK
from pnp_tpu.solvers import linear_problem as JL
from pnp_tpu.solvers import precond as JP
from pnp_tpu.workloads.common import make_scalar_context as j_context
from pnp_tpu.workloads.pb import solve_pb as j_solve_pb
from pnp_tpu.operators import volume as JV

from pnp_tpu_torch.fem import assembly as TA
from pnp_tpu_torch.operators import volume as TV
from pnp_tpu_torch.solvers import direct as TD
from pnp_tpu_torch.solvers import krylov as TK
from pnp_tpu_torch.solvers import linear_problem as TL
from pnp_tpu_torch.solvers import precond as TP
from pnp_tpu_torch.solvers.newton import NewtonParams, newton_solve
from pnp_tpu_torch.workloads.common import make_scalar_context as t_context
from pnp_tpu_torch.workloads.pb import solve_pb as t_solve_pb

from test_torch_fem import close, spaces

torch.set_num_threads(1)

RTOL = 1e-10


@pytest.fixture(scope="module")
def systems():
    """Two operators on the pore case, both packages, single and batched:
    an SPD mass + PB-Jacobian operator at a smooth iterate and a
    non-symmetric mass + drift-diffusion one, conditioned well enough that
    every variant takes the same iteration count in both packages."""
    tsys, tspace, jsys, jspace = spaces(1)
    tc, jc = t_context(tsys, tspace, 0, 3), j_context(jsys, jspace, 0, 3)
    u = 0.3 * np.sin(0.05 * np.arange(tspace.ndof))
    ue_t, ue_j = torch.tensor(u)[tc.dofmap], jnp.asarray(u)[jc.dofmap]
    gt = torch.einsum("ei,eqid->eqd", ue_t, tc.vt.gradphi)
    gj = jnp.einsum("ei,eqid->eqd", ue_j, jc.vt.gradphi)
    blocks = {
        "spd": (TV.pb_jacobian_el(ue_t, tc.vt, 0.7, 0.06, True, tsys.pi),
                JV.pb_jacobian_el(ue_j, jc.vt, 0.7, 0.06, True, jsys.pi)),
        "nonsym": (TV.drift_diffusion_jacobian_el(gt, tc.vt, 1.0),
                   JV.drift_diffusion_jacobian_el(gj, jc.vt, 1.0)),
    }
    M_t, M_j = TV.mass_jacobian_el(tc.vt), JV.mass_jacobian_el(jc.vt)
    ft, fj = torch.stack([tc.free] * 2), jnp.stack([jc.free] * 2)
    out = {}
    for name, (Kt, Kj) in blocks.items():
        At, Aj = M_t + 0.5 * Kt, M_j + 0.5 * Kj
        out[name] = (
            TA.make_constrained_operator(At, tc.dofmap, tc.ndof, tc.free),
            TA.constrained_diagonal(At, tc.dofmap, tc.ndof, tc.free),
            JA.make_constrained_operator(Aj, jc.dofmap, jc.ndof, jc.free),
            JA.constrained_diagonal(Aj, jc.dofmap, jc.ndof, jc.free))
        out[name + "2"] = (
            TA.make_constrained_operator_batched(torch.stack([At] * 2),
                                                 tc.dofmap, tc.ndof, ft),
            torch.stack([out[name][1]] * 2),
            JA.make_constrained_operator_batched(jnp.stack([Aj] * 2),
                                                 jc.dofmap, jc.ndof, fj),
            jnp.stack([out[name][3]] * 2))
    b = np.random.RandomState(0).randn(tspace.ndof) * np.asarray(jc.free)
    return out, b


def test_preconditioners(systems):
    ops, b = systems
    op_t, d_t, op_j, d_j = ops["spd"]
    lt = TP.estimate_dinv_spectral_radius(op_t, d_t, torch.tensor(b) + 1e-30)
    lj = JP.estimate_dinv_spectral_radius(op_j, d_j, jnp.asarray(b) + 1e-30)
    close(lt, lj, rtol=1e-12)
    x = np.random.RandomState(2).randn(b.shape[0])
    close(TP.jacobi_precond(d_t)(torch.tensor(x)),
          JP.jacobi_precond(d_j)(jnp.asarray(x)))
    close(TP.chebyshev_jacobi_precond(op_t, d_t, lt)(torch.tensor(x)),
          JP.chebyshev_jacobi_precond(op_j, d_j, lj)(jnp.asarray(x)),
          rtol=1e-12)
    assert torch.equal(TP.identity_precond()(torch.tensor(x)),
                       torch.tensor(x))


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
@pytest.mark.parametrize("batched", [False, True])
def test_krylov(systems, solver, batched):
    ops, b = systems
    name = ("spd" if solver == "cg" else "nonsym") + ("2" if batched else "")
    op_t, d_t, op_j, d_j = ops[name]
    bt, bj = torch.tensor(b), jnp.asarray(b)
    if batched:   # two systems advanced together (second rhs rough)
        b2 = b * np.where(np.arange(b.shape[0]) % 2, 1.0, -3.0)
        bt = torch.stack([bt, torch.tensor(b2)])
        bj = jnp.stack([bj, jnp.asarray(b2)])
    M_t, M_j = TP.jacobi_precond(d_t), JP.jacobi_precond(d_j)
    rt = getattr(TK, solver)(op_t, bt, torch.zeros_like(bt), M_t, 1e-9, 500)
    rj = getattr(JK, solver)(op_j, bj, jnp.zeros_like(bj), M_j, 1e-9, 500)
    assert rt.iterations == int(rj.iterations)
    assert rt.converged and bool(rj.converged)
    close(rt.x, rj.x, rtol=RTOL)
    close(rt.relres, rj.relres, rtol=1e-3, atol=1e-14)


@pytest.mark.parametrize("variant", ["BCGS_SSORk", "BCGS_NOPREC",
                                     "CG_NOPREC", "CG_Jacobi",
                                     "BCGS_Jacobi"])
def test_linear_solver_variants(systems, variant):
    """Same iterations and iterates to 1e-10 — except unpreconditioned
    BiCGSTAB, whose erratic residual history lets a last-bit difference
    move the stopping iteration by one: there both reach the 1e-9
    reduction and the iterates agree to 1e-8 (the solve's own accuracy)."""
    ops, b = systems
    op_t, d_t, op_j, d_j = ops["spd"]
    st = TL.make_krylov_solver(variant, 2000)
    sj = JL.make_krylov_solver(variant, 2000)
    bt, bj = torch.tensor(b), jnp.asarray(b)
    rt = st(op_t, bt, torch.zeros_like(bt), d_t, 1e-9)
    rj = sj(op_j, bj, jnp.zeros_like(bj), d_j, 1e-9)
    assert rt.converged and bool(rj.converged)
    erratic = variant == "BCGS_NOPREC"
    assert abs(rt.iterations - int(rj.iterations)) <= int(erratic)
    close(rt.x, rj.x, rtol=1e-8 if erratic else RTOL)
    if erratic:
        return
    ut, _ = TL.stationary_linear_solve(lambda u: op_t(u) - bt, op_t, d_t,
                                       torch.zeros_like(bt), st, 1e-9)
    uj, _ = JL.stationary_linear_solve(lambda u: op_j(u) - bj, op_j, d_j,
                                       jnp.zeros_like(bj), sj, 1e-9)
    close(ut, uj, rtol=RTOL)


def test_amg_variant_not_ported():
    with pytest.raises(NotImplementedError, match="AMG"):
        TL.make_krylov_solver("CG_AMG_SSOR", 100)
    with pytest.raises(ValueError):
        TL.make_krylov_solver("LU", 100)


@pytest.mark.parametrize("reassemble", [0.0, 0.5])
def test_solve_pb_matches_reference(reassemble):
    tsys, tspace, jsys, jspace = spaces(1)
    tsys = dataclasses.replace(tsys, newtonReassembleThreshold=reassemble)
    jsys = dataclasses.replace(jsys, newtonReassembleThreshold=reassemble)
    rt, rj = t_solve_pb(tsys, tspace), j_solve_pb(jsys, jspace)
    assert rt.converged and rj.converged
    assert (rt.iterations, rt.linear_iterations, rt.jacobian_builds) == \
        (rj.iterations, rj.linear_iterations, rj.jacobian_builds)
    close(rt.u, rj.u, rtol=RTOL)
    assert abs(rt.defect - rj.defect) <= 1e-6 * rj.initial_defect


def test_newton_line_search_and_cap():
    """Damped steps, accept-best and the iteration cap on a scalar
    equation the full step overshoots (atan(u) = 0 from u = 3)."""
    res = lambda u: torch.atan(u)
    solve = lambda u, r, red: (r * (1 + u * u), 1)
    out = newton_solve(res, solve, torch.tensor([3.0], dtype=torch.float64),
                       NewtonParams(reduction=1e-12, max_iterations=30))
    assert out.converged and abs(float(out.u)) < 1e-10
    capped = newton_solve(res, solve,
                          torch.tensor([3.0], dtype=torch.float64),
                          NewtonParams(reduction=1e-12, max_iterations=1,
                                       line_search_max=0))
    assert not capped.converged and capped.iterations == 1
    with pytest.raises(ValueError):
        newton_solve(res, None, torch.zeros(1), NewtonParams(),
                     assemble_fn=lambda u: u)


def test_direct_pieces():
    rng = np.random.RandomState(4)
    N = 60
    A = (np.eye(N) * 4 + rng.randn(2, N, N) * 0.3).astype(np.float32)
    At, Aj = torch.tensor(A), jnp.asarray(A)
    close(TD.probe_vectors(N, (2,)), JD.probe_vectors(N, (2,)), rtol=0)
    X = TD.batched_inv_f32(At)
    assert bool(JD.contraction_ok(Aj, jnp.asarray(X.numpy())))
    bad = X.clone()
    bad[1] *= 3.0        # an inverse that no longer contracts
    assert TD.contraction_ok(At, bad) == bool(
        JD.contraction_ok(Aj, jnp.asarray(bad.numpy())))
    assert not TD.contraction_ok(At, bad)
    n0 = TD.probe_failures["count"]
    singular = At.clone()
    singular[0, :, 5] = 0.0
    singular[0, 5, :] = 0.0
    with pytest.raises(FloatingPointError):
        TD.batched_inv_f32(singular)
    assert TD.probe_failures["count"] == n0 + 1
    with pytest.raises(NotImplementedError):
        TD.scaled_inv_apply((X, X[:, 0]), torch.zeros(2, N))


def test_inverse_refinement_matches_reference():
    """Refinement against the exact f64 element operator with the same f32
    inverse on both sides: same count, same solution."""
    tsys, tspace, jsys, jspace = spaces(1)
    tc, jc = t_context(tsys, tspace, 1, 2), j_context(jsys, jspace, 1, 2)
    A_t = TV.mass_jacobian_el(tc.vt) + 0.5 * TV.laplace_jacobian_el(tc.vt)
    A_j = JV.mass_jacobian_el(jc.vt) + 0.5 * JV.laplace_jacobian_el(jc.vt)
    A_t2, A_j2 = torch.stack([A_t, 2 * A_t]), jnp.stack([A_j, 2 * A_j])
    free_t = torch.stack([tc.free, tc.free])
    free_j = jnp.stack([jc.free, jc.free])
    dense = TA.dense_constrained_matrix_batched(A_t2, tc.dofmap, tc.ndof,
                                                free_t)
    X = TD.batched_inv_f32(dense)
    r = np.random.RandomState(5).randn(2, tspace.ndof) * np.asarray(free_j)
    xt, kt = TD.make_inv_refine_solver(X, A_t2, tc.dofmap, tc.ndof, free_t)(
        torch.tensor(r), 1e-12)
    xj, kj = JD.make_inv_refine_solver(jnp.asarray(X.numpy()), A_j2,
                                       jc.dofmap, jc.ndof, free_j)(
        jnp.asarray(r), 1e-12)
    assert kt == int(kj)
    close(xt, xj, rtol=RTOL)
    close(TD.scaled_inv_apply(X, torch.tensor(r)),
          JD.scaled_inv_apply(jnp.asarray(X.numpy()), jnp.asarray(r)),
          rtol=1e-6)
