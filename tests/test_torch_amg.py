"""The two-level aggregation AMG (``CG_AMG_SSOR``) of the port against the
reference package on the CPU: aggregate arrays identical in both branches
(Morton runs and the capped greedy fallback), the preconditioner apply to
1e-12 on flat and batched systems, CG iteration counts equal, the
fallback to Chebyshev-Jacobi without a context, and the variant through
the solver factory. Models: tests/test_solvers.py:65-137."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu.fem import assembly as JA
from pnp_tpu.fem.geometry import build_volume_tables as j_tables
from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio import structured as JST
from pnp_tpu.operators import volume as JV
from pnp_tpu.solvers import amg as JAMG
from pnp_tpu.solvers import krylov as JK
from pnp_tpu.solvers import linear_problem as JL

from pnp_tpu_torch.fem import assembly as TA
from pnp_tpu_torch.fem.geometry import build_volume_tables as t_tables
from pnp_tpu_torch.fem.space import FunctionSpace as TFS
from pnp_tpu_torch.meshio import structured as TST
from pnp_tpu_torch.operators import volume as TV
from pnp_tpu_torch.solvers import amg as TAMG
from pnp_tpu_torch.solvers import krylov as TK
from pnp_tpu_torch.solvers import linear_problem as TL
from pnp_tpu_torch.solvers import precond as TP

torch.set_num_threads(1)

T = lambda a: torch.tensor(np.asarray(a))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


MESHES = {
    "rect24x24": lambda m: m.rect_mesh(24, 24, 1.0, 1.0),
    "one_wall40x4": lambda m: m.rect_mesh(40, 4, 5.0, 0.5),
    "pore30x17": lambda m: m.pore_without_dna_mesh(30, 17),
}


def laplace_system(name: str, degree: int = 1, mass: float = 0.0):
    """The same Dirichlet (boundary-edge) Laplace (+ mass) system in both
    packages: (tspace, t tables, t A_el, t free, j tables, j A_el, j free)."""
    jspace = JFS(MESHES[name](JST), degree)
    tspace = TFS(MESHES[name](TST), degree)
    jvt, tvt = j_tables(jspace, 2 * degree), t_tables(tspace, 2 * degree,
                                                      "cpu")
    jA = JV.laplace_jacobian_el(jvt) + mass * JV.mass_jacobian_el(jvt)
    tA = TV.laplace_jacobian_el(tvt) + mass * TV.mass_jacobian_el(tvt)
    free = np.ones(tspace.ndof, dtype=bool)
    free[np.unique(tspace.bedge_dofs)] = False
    return tspace, tvt, tA, T(free), jvt, jA, jnp.asarray(free)


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("coords", [True, False], ids=["morton", "greedy"])
@pytest.mark.parametrize("target", [16, 256])
def test_aggregates_identical(name, coords, target):
    """Both branches of ``build_aggregates`` and ``make_amg_context`` (a
    (2, ndof) mask takes the union) give the reference's arrays."""
    tspace, tvt, _, tfree, jvt, _, _ = laplace_system(name)
    dm = tvt.dofmap.numpy()
    c = tspace.dof_coords if coords else None
    free = tfree.numpy()
    got = TAMG.build_aggregates(dm, tspace.ndof, free, target, dof_coords=c)
    want = JAMG.build_aggregates(dm, tspace.ndof, free, target, dof_coords=c)
    assert got[1] == want[1] and got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    # a second mask that frees the Dirichlet dofs of one side only
    pair = np.stack([free, free | (tspace.dof_coords[:, 0] < 1e-12)])
    tc = TAMG.make_amg_context(tvt.dofmap, tspace.ndof, T(pair), target,
                               dof_coords=c)
    jc = JAMG.make_amg_context(jvt.dofmap, tspace.ndof, pair, target,
                               dof_coords=c)
    assert tc.n_agg == jc.n_agg and tc.agg.dtype == torch.int64
    np.testing.assert_array_equal(tc.agg.numpy(), np.asarray(jc.agg))
    np.testing.assert_array_equal(tc.free.numpy(), np.asarray(jc.free))


@pytest.mark.parametrize("coords", [True, False], ids=["morton", "greedy"])
def test_aggregate_members(coords):
    """The restriction's table: each aggregate's dofs once, ascending,
    padded with ndof, every free dof in its own aggregate's row; summing
    a residual through it equals the scatter-add over ``agg`` (exactly,
    on integer values)."""
    tspace, tvt, _, tfree, *_ = laplace_system("pore30x17")
    n = tspace.ndof
    c = tspace.dof_coords if coords else None
    ctx = TAMG.make_amg_context(tvt.dofmap, n, tfree, 16, dof_coords=c)
    agg, table = ctx.agg.numpy(), ctx.members.numpy()
    assert table.shape[0] == ctx.n_agg
    for k, row in enumerate(table):
        ids = row[row < n]
        assert (row[len(ids):] == n).all() and (np.diff(ids) > 0).all()
        np.testing.assert_array_equal(ids, np.where(agg == k)[0])
    r = np.random.RandomState(1).randint(-9, 9, n).astype(np.float64)
    want = np.zeros(ctx.n_agg)
    np.add.at(want, agg[agg >= 0], r[agg >= 0])
    got = np.append(r, 0.0)[table].sum(axis=-1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["rect24x24", "pore30x17"])
def test_precond_apply_flat_and_batched(name):
    """M(r) to 1e-12 of the reference's on a flat system and on a (2, ndof)
    batch whose systems carry their own masks and scales."""
    tspace, tvt, tA, tfree, jvt, jA, jfree = laplace_system(name, mass=0.3)
    n = tspace.ndof
    c = tspace.dof_coords
    rng = np.random.RandomState(0)
    r = rng.standard_normal(n) * tfree.numpy()
    td = TA.constrained_diagonal(tA, tvt.dofmap, n, tfree)
    jd = JA.constrained_diagonal(jA, jvt.dofmap, n, jfree)
    tc = TAMG.make_amg_context(tvt.dofmap, n, tfree, 64, dof_coords=c)
    jc = JAMG.make_amg_context(jvt.dofmap, n, jfree, 64, dof_coords=c)
    got = TAMG.two_level_precond(tA, tc, td)(T(r))
    want = JAMG.two_level_precond(jA, jc, jd)(jnp.asarray(r))
    assert got.dtype == torch.float64
    assert rel(got, want) <= 1e-12, rel(got, want)

    free2 = np.stack([tfree.numpy(), tfree.numpy()
                      | (c[:, 0] < 1e-12)])
    tA2, jA2 = torch.stack([tA, 2.5 * tA]), jnp.stack([jA, 2.5 * jA])
    td2 = torch.stack([TA.constrained_diagonal(a, tvt.dofmap, n, T(f))
                       for a, f in zip(tA2, free2)])
    jd2 = jnp.stack([JA.constrained_diagonal(a, jvt.dofmap, n,
                                             jnp.asarray(f))
                     for a, f in zip(jA2, free2)])
    tc2 = TAMG.make_amg_context(tvt.dofmap, n, T(free2), 64, dof_coords=c)
    jc2 = JAMG.make_amg_context(jvt.dofmap, n, free2, 64, dof_coords=c)
    r2 = rng.standard_normal((2, n)) * free2
    got = TAMG.two_level_precond(tA2, tc2, td2, free=T(free2))(T(r2))
    want = JAMG.two_level_precond(jA2, jc2, jd2, free=jnp.asarray(free2))(
        jnp.asarray(r2))
    assert tuple(got.shape) == (2, n)
    assert rel(got, want) <= 1e-12, rel(got, want)
    # the batched apply equals the per-system applies
    for s in range(2):
        one = TAMG.two_level_precond(tA2[s], tc2, td2[s], free=T(free2[s]))
        assert rel(one(T(r2[s])), got[s]) <= 1e-12


@pytest.mark.parametrize("name,target", [("one_wall40x4", 16),
                                         ("rect24x24", 64)])
def test_cg_counts_equal_and_two_level_accelerates(name, target):
    """CG under the two-level scheme through ``make_krylov_solver``: the
    reference's iteration count, the solution to 1e-10, fewer iterations
    than CG + Jacobi; without ``amg_ctx`` or ``A_el`` the variant falls
    back to Chebyshev-Jacobi in both packages."""
    tspace, tvt, tA, tfree, jvt, jA, jfree = laplace_system(name)
    n = tspace.ndof
    b = np.random.RandomState(1).standard_normal(n) * tfree.numpy()
    top = TA.make_constrained_operator(tA, tvt.dofmap, n, tfree)
    jop = JA.make_constrained_operator(jA, jvt.dofmap, n, jfree)
    td = TA.constrained_diagonal(tA, tvt.dofmap, n, tfree)
    jd = JA.constrained_diagonal(jA, jvt.dofmap, n, jfree)
    c = tspace.dof_coords
    ts = TL.make_krylov_solver("CG_AMG_SSOR", 2000, amg_ctx=TAMG.make_amg_context(
        tvt.dofmap, n, tfree, target, dof_coords=c))
    js = JL.make_krylov_solver("CG_AMG_SSOR", 2000, amg_ctx=JAMG.make_amg_context(
        jvt.dofmap, n, jfree, target, dof_coords=c))
    rt = ts(top, T(b), torch.zeros(n, dtype=torch.float64), td, 1e-8,
            A_el=tA)
    rj = js(jop, jnp.asarray(b), jnp.zeros(n), jd, 1e-8, A_el=jA)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations) > 0
    assert rel(rt.x, rj.x) <= 1e-10, rel(rt.x, rj.x)
    jac = TK.cg(top, T(b), torch.zeros(n, dtype=torch.float64),
                TP.jacobi_precond(td), 1e-8, 2000)
    assert rt.iterations < jac.iterations
    # the fallback: no element blocks -> Chebyshev-Jacobi(3) CG
    ft = ts(top, T(b), torch.zeros(n, dtype=torch.float64), td, 1e-8)
    fj = js(jop, jnp.asarray(b), jnp.zeros(n), jd, 1e-8)
    assert ft.iterations == int(fj.iterations)
    assert rel(ft.x, fj.x) <= 1e-10
    bare = TL.make_krylov_solver("CG_AMG_SSOR", 2000)
    assert bare(top, T(b), torch.zeros(n, dtype=torch.float64), td, 1e-8,
                A_el=tA).iterations == ft.iterations
    with pytest.raises(ValueError):
        TL.make_krylov_solver("LU", 100)


def test_amg_beats_chebyshev_at_scale():
    """On a mesh where the coarse level matters (rect 100 x 100), the
    Morton two-level scheme takes fewer CG iterations than
    Chebyshev-Jacobi(3), as in the reference's own test, with the
    reference's count."""
    jspace = JFS(JST.rect_mesh(100, 100, 1.0, 1.0), 1)
    tspace = TFS(TST.rect_mesh(100, 100, 1.0, 1.0), 1)
    tvt = t_tables(tspace, 2, "cpu")
    tA = TV.laplace_jacobian_el(tvt)
    jvt = j_tables(jspace, 2)
    jA = JV.laplace_jacobian_el(jvt)
    c = tspace.dof_coords
    free = ~((c[:, 0] < 1e-12) | (c[:, 0] > 1 - 1e-12))
    n = tspace.ndof
    b = np.where(free, np.random.RandomState(0).standard_normal(n), 0.0)
    top = TA.make_constrained_operator(tA, tvt.dofmap, n, T(free))
    td = TA.constrained_diagonal(tA, tvt.dofmap, n, T(free))
    lam = TP.estimate_dinv_spectral_radius(top, td, T(b))
    cheb = TK.cg(top, T(b), torch.zeros(n, dtype=torch.float64),
                 TP.chebyshev_jacobi_precond(top, td, lam, 3), 1e-8, 4000)
    ctx = TAMG.make_amg_context(tvt.dofmap, n, T(free), 256, dof_coords=c)
    res = TK.cg(top, T(b), torch.zeros(n, dtype=torch.float64),
                TAMG.two_level_precond(tA, ctx, td), 1e-8, 4000)
    jfree = jnp.asarray(free)
    jop = JA.make_constrained_operator(jA, jvt.dofmap, n, jfree)
    jd = JA.constrained_diagonal(jA, jvt.dofmap, n, jfree)
    jres = JK.cg(jop, jnp.asarray(b), jnp.zeros(n), JAMG.two_level_precond(
        jA, JAMG.make_amg_context(jvt.dofmap, n, jfree, 256, dof_coords=c),
        jd), 1e-8, 4000)
    assert res.converged and res.iterations < cheb.iterations
    assert res.iterations == int(jres.iterations)
    r = T(b) - top(res.x)
    assert float(r.norm()) < 1e-7 * float(np.linalg.norm(b))
