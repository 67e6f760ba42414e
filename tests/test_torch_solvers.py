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

from pnp_tpu_torch import problems
from pnp_tpu_torch.fem import assembly as TA
from pnp_tpu_torch.operators import volume as TV
from pnp_tpu_torch.solvers import block_ras as TBR
from pnp_tpu_torch.solvers import direct as TD
from pnp_tpu_torch.solvers import krylov as TK
from pnp_tpu_torch.solvers import linear_problem as TL
from pnp_tpu_torch.solvers import precond as TP
from pnp_tpu_torch.solvers.newton import NewtonParams, newton_solve
from pnp_tpu_torch.utils import profiling as TPR
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
    tc = t_context(tsys, tspace, 0, 3, device="cpu")
    jc = j_context(jsys, jspace, 0, 3)
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
            TA.make_constrained_operator(torch.stack([At] * 2),
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


def _bicgstab_out_of_place(op, b, x0, M, reduction, maxiter):
    """BiCGSTAB's loop as it stood before it updated its vectors in place,
    frozen here with its helpers: the in-place loop must give its bits.
    Returns (x, iterations, relres)."""
    def norm(v):
        return torch.sqrt(torch.sum((v * v).to(torch.float64), dim=-1,
                                    keepdim=True)).to(v.dtype)

    def dot(a, c):
        return torch.sum((a * c).to(torch.float64), dim=-1,
                         keepdim=True).to(a.dtype)

    def nz(v):
        return torch.where(v == 0.0, 1.0, v)

    M = M if M is not None else (lambda r: r)
    r = b - op(x0)
    norm0 = norm(r)
    tol = reduction * torch.clamp_min(norm0, 1e-300)
    rhat = r
    one = torch.ones_like(norm0)
    x, p, v = x0, torch.zeros_like(b), torch.zeros_like(b)
    rho, alpha, omega, k = one, one, one, 0
    while k < maxiter and bool(torch.any(norm(r) > tol)):
        rho_new = dot(rhat, r)
        beta = (rho_new / nz(rho)) * (alpha / nz(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = op(phat)
        alpha = rho_new / nz(dot(rhat, v))
        s = r - alpha * v
        shat = M(s)
        t = op(shat)
        omega = dot(t, s) / nz(dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    return x, k, (norm(r) / torch.clamp_min(norm0, 1e-300))[..., 0]


@pytest.fixture(scope="module")
def ras_systems():
    """Non-symmetric mass + drift-diffusion systems of a long time step on
    the 488-node pore case with 64-dof RAS blocks (K = 8; 10-90
    iterations to 1e-9): one flat, and a pair whose second system has
    other blocks and more constrained dofs; for each, no preconditioner,
    RAS, and two-level RAS with the p1 coarse level."""
    tsys, tspace = problems.pore_case(30, 17, 1)
    tc = t_context(tsys, tspace, 0, 3, device="cpu")
    n, dm = tc.ndof, tc.dofmap
    u = torch.tensor(0.3 * np.sin(0.05 * np.arange(n)))
    g = torch.einsum("ei,eqid->eqd", u[dm], tc.vt.gradphi)
    mass = TV.mass_jacobian_el(tc.vt)
    A = mass + 500.0 * TV.drift_diffusion_jacobian_el(g, tc.vt, 1.0)
    A2 = torch.stack([A, mass + 800.0 * TV.drift_diffusion_jacobian_el(
        -g, tc.vt, 1.0)])
    free2 = torch.stack([tc.free, tc.free.clone()])
    free2[1, ::7] = False
    ctx = TBR.build_block_context_for_space(tspace, 64, "cpu")
    coords = tspace.dof_coords
    out = {}
    for batched, (A_el, free) in ((False, (A, tc.free)), (True, (A2, free2))):
        op = TA.make_constrained_operator(A_el, dm, n, free)
        inv = TBR.build_local_inverses(ctx, A_el, free)
        p1 = (TBR.build_p1_coarse_batched if batched
              else TBR.build_p1_coarse)(ctx, A_el, dm, free, coords)
        rng = np.random.RandomState(3)
        b = torch.tensor(rng.randn(*free.shape)) * free
        out[batched] = (op, b, {
            "none": None,
            "ras": TBR.make_ras_precond(ctx, inv, free),
            "ras-p1": TBR.make_two_level_precond(ctx, inv, None, op, free,
                                                 p1_coarse=p1)})
    return out


@pytest.mark.parametrize("stop", ["converged", "maxiter"])
@pytest.mark.parametrize("precond", ["none", "ras", "ras-p1"])
@pytest.mark.parametrize("batched", [False, True])
def test_bicgstab_in_place_gives_the_out_of_place_bits(ras_systems, batched,
                                                       precond, stop):
    """``krylov.bicgstab`` updating its vectors in place gives the bits,
    count and relative residuals of the out-of-place loop it replaced, on
    a converging solve and on one stopped at ``maxiter``; with ``graph`` on
    the CPU, and inside ``recording()``, the solve stays eager: the same
    bits and no capture in ``graph_counts``."""
    op, b, precs = ras_systems[batched]
    M = precs[precond]
    maxiter = 2000 if stop == "converged" else 3
    x0 = torch.zeros_like(b)
    want_x, want_k, want_relres = _bicgstab_out_of_place(op, b, x0, M, 1e-9,
                                                         maxiter)
    before = dict(TK.graph_counts)
    got = [TK.bicgstab(op, b, x0, M, 1e-9, maxiter),
           TK.bicgstab(op, b, x0, M, 1e-9, maxiter, graph=True)]
    with TPR.recording():
        got.append(TK.bicgstab(op, b, x0, M, 1e-9, maxiter, graph=True))
    assert TK.graph_counts == before
    assert torch.equal(x0, torch.zeros_like(b))
    for res in got:
        assert res.iterations == want_k
        assert res.converged == (stop == "converged")
        assert torch.equal(res.x, want_x)
        assert torch.equal(res.relres, want_relres)
    assert want_k == maxiter if stop == "maxiter" else 3 < want_k < maxiter


@pytest.mark.parametrize("maxiter", [1, 2, 14, 15, 16, 31])
@pytest.mark.parametrize("restart", [0, 4, 15])
def test_graphed_segments_follow_the_eager_loop(monkeypatch, restart,
                                                maxiter):
    """The graphed loop's segment plan (``krylov._segment``), expanded to
    ``maxiter``, is the eager loop's sequence of kept and restarted
    iterations: the first eager, each restart eager, every run between
    them one loop segment. Then ``krylov._iterate`` with a device-side
    loop stood in by one that steps eagerly (``_capture`` replaced), for a
    solve that converges after each possible iteration and one that never
    does: the eager loop's iterations and keep/restart sequence, one
    capture, a loop a segment, and ``replays`` the iterations the loops
    ran."""
    want = [not (restart and j % restart == 0) for j in range(1, maxiter + 1)]
    got, kinds, k = [], [], 0
    while k < maxiter:
        kind, n = TK._segment(k, maxiter, restart)
        assert n >= 1 and k + n <= maxiter and (n == 1 or kind == "loop")
        assert (kind == "eager") == (k == 0 and want[0])
        got += [kind != "restart"] * n
        kinds.append(kind)
        k += n
    assert got == want
    assert all(a != "loop" or b == "restart"
               for a, b in zip(kinds, kinds[1:]))
    assert [TK._segment(j, maxiter, restart, graphed=False)[0]
            for j in range(maxiter)] == [
        "eager" if keep else "restart" for keep in want]

    def solve(device, stop):
        """The keep flags of each iteration and the count; ``stop``: the
        iteration whose flag first reads False."""
        seen = []

        def step(keep=True):
            seen.append(keep)
            return torch.tensor(len(seen) < stop)

        def capture(fn, dev):
            assert fn is step and dev == device

            def run(n):
                for ran in range(1, n + 1):
                    if not fn().item():
                        return ran, False
                return n, True
            return run

        monkeypatch.setattr(TK, "_capture", capture)
        return seen, TK._iterate(step, torch.tensor(True), maxiter, device,
                                 restart)

    for stop in range(1, maxiter + 2):
        seen, k = solve(None, stop)
        assert k == min(stop, maxiter) and seen == want[:k]
        before = dict(TK.graph_counts)
        assert solve("loop", stop) == (seen, k)
        loops = sum(1 for j in range(1, k + 1) if want[j - 1] and j > 1
                    and (j == 2 or not want[j - 2]))
        assert TK.graph_counts == {
            "captures": before["captures"] + (loops > 0),
            "loops": before["loops"] + loops,
            "replays": before["replays"] + sum(want[1:k])}


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


def test_cg_restart_converges_where_plain_cg_stalls():
    """``krylov.cg(restart=)``, the species stages' CG under
    ``CG_AMG_SSOR``: on a convection-diffusion operator that is not
    symmetric plain CG stalls and never reaches the tolerance, while CG
    restarted every 15 iterations converges (to the true residual); a
    solve that converges within the period is plain CG, bit for bit."""
    n = 400
    one = torch.ones(n - 1, dtype=torch.float64)
    A = (torch.diag(torch.full((n,), 2.01, dtype=torch.float64))
         - 1.1 * torch.diag(one, -1) - 0.9 * torch.diag(one, 1))
    b = torch.sin(0.37 * torch.arange(n, dtype=torch.float64)) + 0.2
    x0 = torch.zeros_like(b)
    plain = TK.cg(lambda x: A @ x, b, x0, None, 1e-6, 2000)
    again = TK.cg(lambda x: A @ x, b, x0, None, 1e-6, 2000, restart=15)
    assert not plain.converged and plain.iterations == 2000
    assert again.converged and again.iterations < 1000
    assert float(torch.linalg.vector_norm(b - A @ again.x)
                 / torch.linalg.vector_norm(b)) < 2e-6
    S = (A + A.T) / 2
    short = TK.cg(lambda x: S @ x, b, x0, None, 1e-8, 2000)
    within = TK.cg(lambda x: S @ x, b, x0, None, 1e-8, 2000,
                   restart=short.iterations + 1)
    assert short.converged and within.iterations == short.iterations
    assert torch.equal(within.x, short.x)


def test_amg_variant_not_ported(systems):
    """``CG_AMG_SSOR`` is ported: CG under two-level aggregation AMG on the
    SPD pore operator, with the reference's iteration count and iterate
    (1e-10); an unknown variant is still a ValueError."""
    from pnp_tpu.solvers.amg import make_amg_context as j_amg
    from pnp_tpu_torch.solvers.amg import make_amg_context as t_amg

    tsys, tspace, jsys, jspace = spaces(1)
    tc = t_context(tsys, tspace, 0, 3, device="cpu")
    jc = j_context(jsys, jspace, 0, 3)
    u = 0.3 * np.sin(0.05 * np.arange(tspace.ndof))
    At = TV.mass_jacobian_el(tc.vt) + 0.5 * TV.pb_jacobian_el(
        torch.tensor(u)[tc.dofmap], tc.vt, 0.7, 0.06, True, tsys.pi)
    Aj = JV.mass_jacobian_el(jc.vt) + 0.5 * JV.pb_jacobian_el(
        jnp.asarray(u)[jc.dofmap], jc.vt, 0.7, 0.06, True, jsys.pi)
    ops, b = systems
    op_t, d_t, op_j, d_j = ops["spd"]
    st = TL.make_krylov_solver("CG_AMG_SSOR", 2000, amg_ctx=t_amg(
        tc.dofmap, tc.ndof, tc.free, dof_coords=tspace.dof_coords))
    sj = JL.make_krylov_solver("CG_AMG_SSOR", 2000, amg_ctx=j_amg(
        jc.dofmap, jc.ndof, jc.free, dof_coords=jspace.dof_coords))
    bt, bj = torch.tensor(b), jnp.asarray(b)
    rt = st(op_t, bt, torch.zeros_like(bt), d_t, 1e-9, A_el=At)
    rj = sj(op_j, bj, jnp.zeros_like(bj), d_j, 1e-9, A_el=Aj)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations) > 0
    close(rt.x, rj.x, rtol=RTOL)
    with pytest.raises(ValueError):
        TL.make_krylov_solver("LU", 100)


@pytest.mark.parametrize("reassemble", [0.0, 0.5])
def test_solve_pb_matches_reference(reassemble):
    tsys, tspace, jsys, jspace = spaces(1)
    tsys = dataclasses.replace(tsys, newtonReassembleThreshold=reassemble)
    jsys = dataclasses.replace(jsys, newtonReassembleThreshold=reassemble)
    rt, rj = t_solve_pb(tsys, tspace, device="cpu"), j_solve_pb(jsys, jspace)
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
    # the scaled (X_eq, s) form: d = S (X_eq (S r)), held to the reference
    s = X[0, 0].abs() + 0.5
    r = torch.linspace(-1.0, 1.0, N, dtype=torch.float64)[None]
    got = TD.scaled_inv_apply((X[:1], s), r)
    want = JD.scaled_inv_apply((jnp.asarray(X[:1].numpy()),
                                jnp.asarray(s.numpy())),
                               jnp.asarray(r.numpy()))
    close(got, want, rtol=1e-6)


def test_inverse_refinement_matches_reference():
    """Refinement against the exact f64 element operator with the same f32
    inverse on both sides: same count, same solution."""
    tsys, tspace, jsys, jspace = spaces(1)
    tc = t_context(tsys, tspace, 1, 2, device="cpu")
    jc = j_context(jsys, jspace, 1, 2)
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
