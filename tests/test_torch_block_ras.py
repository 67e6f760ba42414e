"""Block-RAS solver layer of the port against the reference package on the
CPU: the block decomposition (identical arrays), the local-matrix
assembly (f32, 1e-6), the one- and two-level preconditioners applied with
the reference's own inverses and coarse tables carried across (the f64
coarse path to 1e-12, the f32 local products to f32 round-off),
BiCGSTAB under RAS with each package's own factors (iteration counts
within one), the LU refinement solver, and PB Newton through the block-RAS
branch of ``make_pb_assemble_solve``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu.fem import assembly as JA
from pnp_tpu.fem.geometry import build_volume_tables as j_tables
from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio import structured as JST
from pnp_tpu.operators import volume as JV
from pnp_tpu.solvers import block_ras as JBR
from pnp_tpu.solvers import direct as JD
from pnp_tpu.solvers import krylov as JK
from pnp_tpu.solvers.newton import NewtonParams as JNP
from pnp_tpu.solvers.newton import newton_solve as j_newton
from pnp_tpu.workloads import pb as JPB
from pnp_tpu.workloads.common import make_scalar_context as j_context

from pnp_tpu_torch import interop, problems
from pnp_tpu_torch.fem import assembly as TA
from pnp_tpu_torch.fem.geometry import build_volume_tables as t_tables
from pnp_tpu_torch.fem.space import FunctionSpace as TFS
from pnp_tpu_torch.meshio import structured as TST
from pnp_tpu_torch.operators import volume as TV
from pnp_tpu_torch.solvers import block_ras as TBR
from pnp_tpu_torch.solvers import direct as TD
from pnp_tpu_torch.solvers import krylov as TK
from pnp_tpu_torch.solvers.newton import NewtonParams as TNP
from pnp_tpu_torch.solvers.newton import newton_solve as t_newton
from pnp_tpu_torch.workloads import pb as TPB
from pnp_tpu_torch.workloads.common import make_scalar_context as t_context

from test_torch_fem import close
from test_torch_host import jax_sysparams

torch.set_num_threads(1)

T = lambda a: torch.tensor(np.asarray(a))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


SPACES = {
    "rect12x9-32": (lambda m: m.rect_mesh(12, 9, 1.0, 1.0), 32),
    "rect20x7-48": (lambda m: m.rect_mesh(20, 7, 1.0, 1.0), 48),
    "pore30x17-64": (lambda m: m.pore_without_dna_mesh(30, 17), 64),
}


@pytest.mark.parametrize("case", sorted(SPACES))
def test_block_context_matches_reference(case):
    """The decomposition decides solver trajectories: identical arrays."""
    make, bs = SPACES[case]
    jspace, tspace = JFS(make(JST), 1), TFS(make(TST), 1)
    jc = JBR.build_block_context_for_space(jspace, bs)
    tc = TBR.build_block_context_for_space(tspace, bs)
    assert (tc.K, tc.B, tc.L, tc.ndof) == (jc.K, jc.B, jc.L, jc.ndof)
    for name in ("loc2glob", "elem_ids", "elem_dof_local", "owner"):
        got = getattr(tc, name)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jc, name)))
        assert interop.block_context(jc).__getattribute__(name).equal(got)
    np.testing.assert_array_equal(TBR.morton_order(tspace.dof_coords),
                                  JBR.morton_order(jspace.dof_coords))
    np.testing.assert_array_equal(TBR._ranges_concat(np.array([3, 0, 2, 1])),
                                  [0, 1, 2, 0, 1, 0])


@pytest.fixture(scope="module")
def laplace():
    """The reference's block-RAS test problems (tests/test_block_ras.py:
    25-36, 97-110) in both packages: Laplace on a 40x40 square with
    Dirichlet boundary, and the advection-dominated (2, ndof) stage-like
    pair M + K(+-1) under a constant steep field."""
    jmesh, tmesh = JST.rect_mesh(40, 40, 1.0, 1.0), TST.rect_mesh(40, 40, 1.0, 1.0)
    jspace, tspace = JFS(jmesh, 1), TFS(tmesh, 1)
    jvt, tvt = j_tables(jspace, 2), t_tables(tspace, 2)
    onb = np.zeros(jspace.ndof, bool)
    onb[np.unique(jmesh.edges)] = True
    jfree, tfree = jnp.asarray(~onb), torch.as_tensor(~onb)
    jA, tA = JV.laplace_jacobian_el(jvt), TV.laplace_jacobian_el(tvt)
    gj = jnp.broadcast_to(jnp.asarray([40.0, 25.0]), jvt.gradphi.shape[:2] + (2,))
    gt = torch.tensor([40.0, 25.0], dtype=torch.float64).expand(
        tvt.gradphi.shape[:2] + (2,))
    jM, tM = JV.mass_jacobian_el(jvt, 1.0, False, np.pi), \
        TV.mass_jacobian_el(tvt, 1.0, False, np.pi)
    jpair = jnp.stack([jM + JV.drift_diffusion_jacobian_el(gj, jvt, s, False, np.pi)
                       for s in (1.0, -1.0)])
    tpair = torch.stack([tM + TV.drift_diffusion_jacobian_el(gt, tvt, s, False, np.pi)
                         for s in (1.0, -1.0)])
    jc = JBR.build_block_context_for_space(jspace, 128)
    tc = TBR.build_block_context_for_space(tspace, 128)
    return dict(jspace=jspace, tspace=tspace, jvt=jvt, tvt=tvt, jfree=jfree,
                tfree=tfree, jA=jA, tA=tA, jpair=jpair, tpair=tpair, jc=jc,
                tc=tc, ndof=jspace.ndof)


def _rhs(P, batched):
    b = np.where(np.asarray(P["jfree"]), 1.0, 0.0)
    if batched:
        b = np.stack([b, b * np.cos(0.3 * np.arange(b.shape[0]))])
    return b


def _quantized(a, bits: int = 7) -> np.ndarray:
    """``a`` rounded to a power-of-two grid of ``bits`` bits of its largest
    magnitude. With inverses and residuals both on such grids, every f32
    product and every sum over a local set (L < 2^10 slots) is exact in
    f32, so the two packages' local matvecs agree bit for bit whatever
    their summation order."""
    a = np.asarray(a)
    q = 2.0 ** (np.floor(np.log2(np.abs(a).max())) - bits + 1)
    return (np.round(a.astype(np.float64) / q) * q).astype(a.dtype)


@pytest.mark.parametrize("batched", [False, True])
def test_assemble_local_matrices(laplace, batched):
    """f32 assembly summed in another order than XLA's: 1e-6 of each
    block's scale (measured ~1e-7); the relative diagonal shift too."""
    P = laplace
    if batched:
        jf, tf = jnp.stack([P["jfree"]] * 2), torch.stack([P["tfree"]] * 2)
        args_j, args_t, shift = (P["jpair"], jf), (P["tpair"], tf), 0.01
    else:
        args_j, args_t, shift = (P["jA"], P["jfree"]), (P["tA"], P["tfree"]), 0.0
    want = np.asarray(JBR.assemble_local_matrices(P["jc"], *args_j, rel_shift=shift))
    got = TBR.assemble_local_matrices(P["tc"], *args_t, rel_shift=shift)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel(got, want) <= 1e-6


@pytest.mark.parametrize("restricted", [True, False])
def test_ras_precond_with_reference_inverses(laplace, restricted):
    """The reference's local inverses carried across. Rounded to 7-bit
    grids with the residual (:func:`_quantized`), every f32 local product
    is exact in both packages, and the applies agree to 1e-12 (measured
    0): gathers, restriction and scatters add nothing. With the raw
    inverses the f32 products sum in another order than XLA's: 1e-5 of
    the apply's scale (f32 round-off of sums over ~200 slots; measured
    2.6e-7 to 1.0e-6)."""
    P = laplace
    for jA, tA, jf, tf, batched in (
            (P["jA"], P["tA"], P["jfree"], P["tfree"], False),
            (P["jpair"], P["tpair"], jnp.stack([P["jfree"]] * 2),
             torch.stack([P["tfree"]] * 2), True)):
        jinv = JBR.build_local_inverses(P["jc"], jA, jf)
        r = _rhs(P, batched) * np.sin(0.7 * np.arange(P["ndof"]))
        for inv, x, tol in ((_quantized(jinv), _quantized(r), 1e-12),
                            (np.asarray(jinv), r, 1e-5)):
            want = JBR.make_ras_precond(P["jc"], jnp.asarray(inv), jf,
                                        restricted)(jnp.asarray(x))
            got = TBR.make_ras_precond(P["tc"], interop.ras_factor(inv), tf,
                                       restricted)(T(x))
            assert got.dtype == torch.float64 and rel(got, want) <= tol


@pytest.mark.parametrize("coarse", ["pwconst", "p1-3", "p1-6", "p1-batched"])
def test_two_level_precond_with_reference_tables(laplace, coarse):
    """Two-level forms with the reference's inverses and coarse tables
    carried across. The coarse correction runs in f64 (the coarse inverse
    cast up, as in the reference). With zero local inverses the whole
    apply is the coarse path, and with 7-bit-grid local inverses and
    residual (exact f32 local products, as in the one-level test) the
    whole two-level apply: both agree to 1e-12. With the raw local
    inverses their f32 products bound it at 1e-5 (as the one-level test;
    measured 6.5e-7 to 9.6e-7).
    The port's own coarse tables: weights and indices identical, coarse
    inverses to f32 round-off of their scale."""
    P = laplace
    jc, tc, jvt, tvt = P["jc"], P["tc"], P["jvt"], P["tvt"]
    batched = coarse == "p1-batched"
    if batched:
        jA, tA = P["jpair"], P["tpair"]
        jf, tf = jnp.stack([P["jfree"]] * 2), torch.stack([P["tfree"]] * 2)
    else:
        jA, tA, jf, tf = P["jA"], P["tA"], P["jfree"], P["tfree"]
    jinv = JBR.build_local_inverses(jc, jA, jf)
    jop = (JA.make_constrained_operator_batched if batched
           else JA.make_constrained_operator)(jA, jvt.dofmap, P["ndof"], jf)
    top = TA.make_constrained_operator(tA, tvt.dofmap, P["ndof"], tf)
    coords = P["jspace"].dof_coords
    if coarse == "pwconst":
        jcinv = JBR.build_coarse_inverse(jc, jA, jvt.dofmap, jf)
        tcinv = TBR.build_coarse_inverse(tc, tA, tvt.dofmap, tf)
        assert rel(tcinv, jcinv) <= 1e-5
        Mj = lambda inv: JBR.make_two_level_precond(jc, inv, jcinv, jop, jf)
        Mt = lambda inv: TBR.make_two_level_precond(tc, inv, T(jcinv), top,
                                                    tf)
    else:
        if batched:
            jp1 = JBR.build_p1_coarse_batched(jc, jA, jvt.dofmap, jf, coords)
            tp1 = TBR.build_p1_coarse_batched(tc, tA, tvt.dofmap, tf, coords)
        else:
            m = int(coarse[-1])
            jp1 = JBR.build_p1_coarse(jc, jA, jvt.dofmap, jf, coords, n_modes=m)
            tp1 = TBR.build_p1_coarse(tc, tA, tvt.dofmap, tf, coords, n_modes=m)
        close(tp1[1], jp1[1], rtol=0, atol=0)
        np.testing.assert_array_equal(tp1[2].numpy(), np.asarray(jp1[2]))
        assert rel(tp1[0], jp1[0]) <= 1e-4
        Mj = lambda inv: JBR.make_two_level_precond(jc, inv, None, jop, jf,
                                                    p1_coarse=jp1)
        Mt = lambda inv: TBR.make_two_level_precond(
            tc, inv, None, top, tf, p1_coarse=interop.p1_coarse(jp1))
    r = _rhs(P, batched) * np.sin(0.7 * np.arange(P["ndof"]))
    zero = jnp.zeros_like(jinv)
    close(Mt(interop.ras_factor(zero))(T(r)), Mj(zero)(jnp.asarray(r)),
          rtol=1e-12)
    q_inv, q_r = jnp.asarray(_quantized(jinv)), _quantized(r)
    close(Mt(interop.ras_factor(q_inv))(T(q_r)), Mj(q_inv)(jnp.asarray(q_r)),
          rtol=1e-12)
    assert rel(Mt(interop.ras_factor(jinv))(T(r)),
               Mj(jinv)(jnp.asarray(r))) <= 1e-5


@pytest.mark.parametrize("case", ["laplace", "laplace-p1", "advective"])
def test_bicgstab_ras_matches_reference(laplace, case):
    """BiCGSTAB under RAS, each package with its own local inverses (the
    port's Gauss-Jordan against XLA's LU inverse, which round differently):
    iteration counts within one, solutions to the solve's accuracy."""
    P = laplace
    jc, tc, jvt, tvt, n = P["jc"], P["tc"], P["jvt"], P["tvt"], P["ndof"]
    if case == "advective":
        jA, tA = P["jpair"], P["tpair"]
        jf, tf = jnp.stack([P["jfree"]] * 2), torch.stack([P["tfree"]] * 2)
        jop = JA.make_constrained_operator_batched(jA, jvt.dofmap, n, jf)
        top = TA.make_constrained_operator(tA, tvt.dofmap, n, tf)
        red = 1e-8
    else:
        jA, tA, jf, tf = P["jA"], P["tA"], P["jfree"], P["tfree"]
        jop = JA.make_constrained_operator(jA, jvt.dofmap, n, jf)
        top = TA.make_constrained_operator(tA, tvt.dofmap, n, tf)
        red = 1e-10
    jinv = JBR.build_local_inverses(jc, jA, jf)
    tinv = TBR.build_local_inverses(tc, tA, tf)
    if case == "laplace-p1":
        coords = P["jspace"].dof_coords
        Mj = JBR.make_two_level_precond(
            jc, jinv, None, jop, jf,
            p1_coarse=JBR.build_p1_coarse(jc, jA, jvt.dofmap, jf, coords))
        Mt = TBR.make_two_level_precond(
            tc, tinv, None, top, tf,
            p1_coarse=TBR.build_p1_coarse(tc, tA, tvt.dofmap, tf, coords))
    else:
        Mj = JBR.make_ras_precond(jc, jinv, jf)
        Mt = TBR.make_ras_precond(tc, tinv, tf)
    b = _rhs(P, case == "advective")
    rj = JK.bicgstab(jop, jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)), Mj,
                     red, 2000)
    rt = TK.bicgstab(top, T(b), torch.zeros_like(T(b)), Mt, red, 2000)
    assert rt.converged and bool(rj.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 1, (
        rt.iterations, int(rj.iterations))
    true_res = (torch.linalg.vector_norm(T(b) - top(rt.x), dim=-1)
                / torch.linalg.vector_norm(T(b), dim=-1))
    assert float(true_res.max()) <= 10 * red
    assert rel(rt.x, rj.x) <= 1e3 * red


def test_local_inverse_probe_names_the_block(laplace):
    """A failed contraction probe raises and says which (system, block)."""
    P = laplace
    A = TBR.assemble_local_matrices(P["tc"], torch.stack([P["tA"]] * 2),
                                    torch.stack([P["tfree"]] * 2))
    A[1, 3] = 0.0                      # a singular local matrix
    n0 = TD.probe_failures["count"]
    with pytest.raises(FloatingPointError, match="'system': 1, 'block': 3"):
        TBR.invert_local_matrices(A)
    assert TD.probe_failures["count"] == n0 + 1
    X = TBR.invert_local_matrices(A[0])
    assert X.shape == A[0].shape and TD.contraction_ok(A[0], X)


def test_lu_refine_solver_matches_reference():
    """The reference's advective pair (tests/test_direct.py:16-41): f32 LU
    (``torch.linalg.lu_factor`` against ``jax.scipy``) + f64 refinement
    reaches each tolerance; solutions agree to the tighter one."""
    jmesh, tmesh = JST.rect_mesh(16, 16, 1.0, 1.0), TST.rect_mesh(16, 16, 1.0, 1.0)
    jspace, tspace = JFS(jmesh, 1), TFS(tmesh, 1)
    jvt, tvt = j_tables(jspace, 3), t_tables(tspace, 3)
    phi = 40.0 * jspace.dof_coords[:, 0]
    gj = jnp.einsum("ei,eqid->eqd", jnp.asarray(phi)[jvt.dofmap], jvt.gradphi)
    gt = torch.einsum("ei,eqid->eqd", T(phi)[tvt.dofmap], tvt.gradphi)
    jpair = jnp.stack([JV.mass_jacobian_el(jvt) + 0.5
                       * JV.drift_diffusion_jacobian_el(gj, jvt, s)
                       for s in (1.0, -1.0)])
    tpair = torch.stack([TV.mass_jacobian_el(tvt) + 0.5
                         * TV.drift_diffusion_jacobian_el(gt, tvt, s)
                         for s in (1.0, -1.0)])
    free = np.ones(jspace.ndof, dtype=bool)
    free[np.unique(jspace.bedge_dofs)] = False
    jf, tf = jnp.asarray(np.stack([free, free])), torch.as_tensor(
        np.stack([free, free]))
    n = jspace.ndof
    jsolve = JD.make_lu_refine_solver(
        JD.batched_lu_factor_f32(JA.dense_constrained_matrix_batched(
            jpair, jvt.dofmap, n, jf)), jpair, jvt.dofmap, n, jf)
    tlu = TD.batched_lu_factor_f32(TA.dense_constrained_matrix_batched(
        tpair, tvt.dofmap, n, tf))
    assert tlu[0].dtype == torch.float32
    tsolve = TD.make_lu_refine_solver(tlu, tpair, tvt.dofmap, n, tf)
    top = TA.make_constrained_operator(tpair, tvt.dofmap, n, tf)
    r = np.random.RandomState(0).standard_normal((2, n)) * free
    for red in (1e-5, 1e-10):
        xt, kt = tsolve(T(r), red)
        xj, kj = jsolve(jnp.asarray(r), red)
        res = torch.linalg.vector_norm(T(r) - top(xt), dim=1)
        assert bool((res <= red * 1.01 * torch.linalg.vector_norm(T(r), dim=1)).all())
        assert kt < 20 and abs(kt - int(kj)) <= 1, (kt, int(kj))
        assert rel(xt, xj) <= 10 * red
    assert float(xt[torch.as_tensor(~np.stack([free, free]))].abs().max()) == 0.0


def test_pb_newton_block_ras_matches_reference():
    """PB through ``make_pb_assemble_solve(ras_threshold=0,
    ras_block_size=64)`` on the 488-node pore: the same Newton and linear
    iteration counts, field to 1e-8 (measured ~1e-12)."""
    tsys, tspace = problems.pore_case(30, 17)
    jsys = jax_sysparams(tsys)
    jspace = JFS(JST.pore_without_dna_mesh(30, 17), 1)
    jc = j_context(jsys, jspace, 0, 3)
    tc = t_context(tsys, tspace, 0, 3, device="cpu")
    kw = dict(reduction=tsys.newtonReduction,
              min_linear_reduction=tsys.newtonMinLinearReduction,
              max_iterations=int(tsys.newtonMaxIterations),
              line_search_max=int(tsys.newtonLineSearchMaxIteration),
              reassemble_threshold=tsys.newtonReassembleThreshold)
    ja, js = JPB.make_pb_assemble_solve(jc, ras_threshold=0, ras_block_size=64)
    ta, ts = TPB.make_pb_assemble_solve(tc, ras_threshold=0, ras_block_size=64)
    rj = j_newton(JPB.make_pb_residual(jc), None, jnp.zeros(jc.ndof),
                  JNP(**kw), assemble_fn=ja, assembled_solve_fn=js)
    rt = t_newton(TPB.make_pb_residual(tc), None,
                  torch.zeros(tc.ndof, dtype=torch.float64), TNP(**kw),
                  assemble_fn=ta, assembled_solve_fn=ts)
    assert rt.converged and rj.converged
    assert (rt.iterations, rt.jacobian_builds) == (rj.iterations,
                                                   rj.jacobian_builds)
    assert abs(rt.linear_iterations - rj.linear_iterations) <= 1
    assert rel(rt.u, rj.u) <= 1e-8
    # the combined per-iteration form is assemble + solve
    r = TPB.make_pb_residual(tc)(rt.u * 0.5)
    x1, k1 = TPB.make_pb_linear_solver(tc, 0, 64)(rt.u * 0.5, r, 1e-6)
    x2, k2 = ts(ta(rt.u * 0.5), r, 1e-6)
    assert k1 == k2 and torch.equal(x1, x2)
