"""The port's DistContext and Schwarz preconditioners against the
reference package on the CPU (the reference's shards on the 8 virtual
devices of tests/conftest.py, the port's a batch axis): element gathers
and scatters, SpMV and diagonals to 1e-13; local matrices to 1e-12 and
equal to the true principal submatrices; one Schwarz apply (to f32
round-off: an f32 matvec a shard) and BiCGSTAB under Schwarz with the
reference's inverses carried across (the same iterations, solutions to
1e-10) and with each package's own (iterations
within one); the LU path against the inverse path; the two-level coarse
level below one-level in iterations on a pore case. Models:
tests/test_dist.py, tests/test_dist_large.py:37-87."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu.fem.geometry import build_volume_tables as j_tables
from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio import structured as JST
from pnp_tpu.operators import volume as JV
from pnp_tpu.parallel.dist import build_dist_context as j_dist
from pnp_tpu.parallel.sharding import make_device_mesh
from pnp_tpu.solvers import krylov as JK
from pnp_tpu.solvers import schwarz as JSW

from pnp_tpu_torch import interop, problems
from pnp_tpu_torch.fem import assembly as TA
from pnp_tpu_torch.fem.geometry import build_volume_tables as t_tables
from pnp_tpu_torch.fem.space import FunctionSpace as TFS
from pnp_tpu_torch.meshio import structured as TST
from pnp_tpu_torch.operators import volume as TV
from pnp_tpu_torch.parallel.dist import build_dist_context as t_dist
from pnp_tpu_torch.solvers import krylov as TK
from pnp_tpu_torch.solvers import schwarz as TSW
from pnp_tpu_torch.workloads.common import make_scalar_context as t_context
from pnp_tpu_torch.workloads.distributed_pnp import partition_volume_tables

torch.set_num_threads(1)

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")
K = 8


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def system():
    """rect_mesh(24, 16) at P1: Laplace + 0.1 mass, boundary dofs
    constrained, in both packages with K = 8 shards each."""
    tspace = TFS(TST.rect_mesh(24, 16, 2.0, 1.0), 1)
    jspace = JFS(JST.rect_mesh(24, 16, 2.0, 1.0), 1)
    tvt, jvt = t_tables(tspace, 2, "cpu"), j_tables(jspace, 2)
    A_el = (TV.laplace_jacobian_el(tvt)
            + 0.1 * TV.mass_jacobian_el(tvt)).numpy()
    tc = t_dist(tspace, K, "cpu")
    jc = j_dist(jspace, make_device_mesh(K))
    bnd = np.zeros(tspace.ndof, bool)
    bnd[np.unique(tspace.mesh.edges)] = True
    free = tc.pad_mask_flat() & ~tc.partition(bnd.astype(np.int8)).astype(bool)
    return dict(tspace=tspace, tvt=tvt, A_el=A_el, tc=tc, jc=jc, free=free,
                tA=torch.tensor(tc.partition_elem(A_el)),
                jA=jc.put_sharded(jnp.asarray(jc.partition_elem(A_el))))


@needs_8
def test_context_ops_match_reference(system):
    tc, jc = system["tc"], system["jc"]
    for f in ("dofmap_local", "send_idx", "recv_pos"):
        assert getattr(tc, f).dtype == torch.int64
    np.testing.assert_array_equal(tc.dofmap_local.numpy(),
                                  np.asarray(jc.dofmap_local))
    assert (tc.Kb, tc.E_flat, tc.n) == (jc.Kb, jc.E_flat, jc.n)
    np.testing.assert_array_equal(tc.pad_mask_flat(), jc.pad_mask_flat())
    for a, b in zip(tc.env_maps(), jc.env_maps()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(1)
    ndof = system["tspace"].ndof
    x = rng.standard_normal(ndof)
    xs = rng.standard_normal((3, ndof))
    np.testing.assert_array_equal(tc.partition(x), jc.partition(x))
    np.testing.assert_array_equal(tc.unpartition(tc.partition(x)), x)
    xp = np.stack([tc.partition(v) for v in xs])
    tA, jA = system["tA"], system["jA"]
    pairs = [
        (tc.gather_elem(torch.tensor(xp[0])), jc.gather_elem(jnp.asarray(xp[0]))),
        (tc.gather_elem(torch.tensor(xp)), jc.gather_elem(jnp.asarray(xp))),
        (tc.local_with_halo(torch.tensor(xp)),
         jc.local_with_halo(jnp.asarray(xp))),
        (tc.spmv(tA, torch.tensor(xp[1])), jc.spmv(jA, jnp.asarray(xp[1]))),
        (tc.spmv(tA.expand(3, *tA.shape), torch.tensor(xp)),
         jc.spmv(jnp.broadcast_to(jA, (3,) + jA.shape), jnp.asarray(xp))),
        (tc.diagonal(tA), jc.diagonal(jA)),
        (tc.diagonal(tA.expand(2, *tA.shape)),
         jc.diagonal(jnp.broadcast_to(jA, (2,) + jA.shape))),
    ]
    re = rng.standard_normal((2, tc.E_flat, tc.n))
    pairs += [(tc.scatter_elem(torch.tensor(re)),
               jc.scatter_elem(jnp.asarray(re))),
              (tc.scatter_elem(torch.tensor(re[0])),
               jc.scatter_elem(jnp.asarray(re[0])))]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        assert rel(got, want) <= 1e-13, rel(got, want)
    # the SpMV against the single-device one, and the global host form
    y = tc.to_host_global(tc.spmv(tA, torch.tensor(tc.partition(x))))
    y_ref = TA.spmv(torch.tensor(system["A_el"]), torch.tensor(x),
                    system["tvt"].dofmap, ndof)
    assert rel(y, y_ref) <= 1e-13
    free = torch.tensor(system["free"])
    op = tc.make_constrained_operator(tA, free)
    jop = jc.make_constrained_operator(jA, jnp.asarray(system["free"]))
    assert rel(op(torch.tensor(xp[2])), jop(jnp.asarray(xp[2]))) <= 1e-13


@needs_8
def test_local_matrices(system):
    """env=True: the reference's local matrices to 1e-12 and the true
    principal submatrices A[loc, loc]; env=False and the shift too."""
    tc, jc = system["tc"], system["jc"]
    free = torch.tensor(system["free"])
    jfree = jnp.asarray(system["free"])
    for env, shift in ((True, 0.0), (True, 1e-7), (False, 1e-7)):
        got = TSW.build_local_matrices(tc, system["tA"], free, shift, env=env)
        want = JSW.build_local_matrices(jc, system["jA"], jfree, shift,
                                        env=env)
        assert got.dtype == torch.float64
        assert rel(got, want) <= 1e-12, (env, shift, rel(got, want))
    A_loc = TSW.build_local_matrices(tc, system["tA"], free, 0.0).numpy()
    plan, ndof = tc.plan, system["tspace"].ndof
    dofmap = np.asarray(system["tspace"].dofmap)
    A = np.zeros((ndof, ndof))
    for e in range(len(dofmap)):
        A[np.ix_(dofmap[e], dofmap[e])] += system["A_el"][e]
    freeg = tc.unpartition(system["free"].astype(np.int8)).astype(bool)
    L = plan.B_N + plan.B_H
    loc2glob = -np.ones((K, L), dtype=np.int64)
    loc2glob[:, :plan.B_N] = plan.owned_global
    for s in range(K):
        for e_loc, e in enumerate(plan.elem_ids[s]):
            if e >= 0:
                loc2glob[s, plan.dofmap_local[s, e_loc]] = dofmap[e]
    for s in range(K):
        g = loc2glob[s]
        valid = (g >= 0) & np.where(g >= 0, freeg[np.maximum(g, 0)], False)
        ref = np.zeros((L, L))
        ref[np.ix_(valid, valid)] = A[np.ix_(g[valid], g[valid])]
        ref += np.diag(~valid * 1.0)
        np.testing.assert_allclose(A_loc[s], ref, rtol=1e-12, atol=1e-12)
    # batched (S, K, L, L) equals the flat one per system
    A2 = TSW.build_local_matrices(
        tc, torch.stack([system["tA"], 2.0 * system["tA"]]),
        torch.stack([free, free]), 0.0)
    A_2 = TSW.build_local_matrices(tc, 2.0 * system["tA"], free, 0.0)
    assert rel(A2[0], A_loc) <= 1e-15 and rel(A2[1], A_2) <= 1e-15


@needs_8
@pytest.mark.parametrize("restricted", [True, False], ids=["RAS", "ASM"])
def test_schwarz_apply_and_bicgstab(system, restricted):
    """With the reference's f32 local inverses carried across, one apply
    matches to f32 round-off (1e-6) and BiCGSTAB (CG for the symmetric
additive form) takes the same iterations to the same
    solution (1e-10); with the port's own inverses (the Gauss-Jordan plain
    version), within one iteration and the solve's own accuracy. RAS beats
    plain BiCGSTAB by half; the LU path solves too."""
    tc, jc = system["tc"], system["jc"]
    free = torch.tensor(system["free"])
    jfree = jnp.asarray(system["free"])
    j_inv = JSW.invert_local_matrices(
        jc, JSW.build_local_matrices(jc, system["jA"], jfree))
    t_own = TSW.invert_local_matrices(
        tc, TSW.build_local_matrices(tc, system["tA"], free))
    carried = torch.tensor(np.asarray(j_inv, np.float32))
    assert t_own.dtype == torch.float32 and t_own.shape == carried.shape
    assert rel(t_own, carried) <= 1e-4
    rng = np.random.RandomState(2)
    b = system["free"] * tc.partition(rng.standard_normal(
        system["tspace"].ndof))
    Mt = TSW.make_ras_inv_precond(tc, carried, restricted)
    Mj = JSW.make_ras_inv_precond(jc, j_inv, restricted)
    # an f32 matvec a shard, summed in another order: f32 round-off
    # (measured 1.5e-7)
    assert rel(Mt(torch.tensor(b)), Mj(jnp.asarray(b))) <= 1e-6
    op = tc.make_constrained_operator(system["tA"], free)
    jop = jc.make_constrained_operator(system["jA"], jfree)
    bt, bj = torch.tensor(b), jnp.asarray(b)
    # RAS is nonsymmetric: BiCGSTAB; symmetric additive Schwarz: CG
    solver = "bicgstab" if restricted else "cg"
    rt = getattr(TK, solver)(op, bt, torch.zeros_like(bt), Mt, 1e-10, 500)
    rj = getattr(JK, solver)(jop, bj, jnp.zeros_like(bj), Mj, 1e-10, 500)
    assert rt.converged and rt.iterations == int(rj.iterations), (
        rt.iterations, int(rj.iterations), rel(rt.x, rj.x))
    assert rel(rt.x, rj.x) <= 1e-10, rel(rt.x, rj.x)
    own = getattr(TK, solver)(op, bt, torch.zeros_like(bt),
                              TSW.make_ras_inv_precond(tc, t_own, restricted),
                              1e-10, 500)
    assert own.converged and abs(own.iterations - rt.iterations) <= 1
    assert rel(own.x, rt.x) <= 1e-8
    base = TK.bicgstab(op, bt, torch.zeros_like(bt), None, 1e-10, 500)
    if restricted:
        assert rt.iterations < base.iterations / 2
    lu = getattr(TK, solver)(op, bt, torch.zeros_like(bt),
                             TSW.make_schwarz_precond(
                                 tc, system["tA"], free,
                                 restricted=restricted, use_inverse=False),
                             1e-10, 500)
    assert lu.converged and abs(lu.iterations - own.iterations) <= 1
    assert rel(lu.x, own.x) <= 1e-8
    # batched stacks: per-system local inverses, one solve
    A2 = torch.stack([system["tA"], 2.5 * system["tA"]])
    f2 = torch.stack([free, free])
    b2 = torch.stack([bt, bt.flip(0) * f2[1]])
    M2 = TSW.make_schwarz_precond(tc, A2, f2, restricted=restricted)
    op2 = tc.make_constrained_operator(A2, f2)
    res = TK.bicgstab(op2, b2, torch.zeros_like(b2), M2, 1e-10, 500)
    assert res.converged
    r = (b2 - op2(res.x)).norm(dim=1) / b2.norm(dim=1)
    assert bool((r < 1e-9).all())


@needs_8
def test_two_level_coarse_cuts_poisson_iterations():
    """On the pore-class Poisson operator at K = 8, the per-shard linear
    coarse level keeps the solve exact and takes fewer BiCGSTAB
    iterations than one-level Schwarz; its coarse matrix inverse and W
    equal the reference's (1e-10), and one two-level apply with the
    reference's local inverses matches to f32 round-off (1e-6)."""
    tsys, tspace = problems.pore_case(60, 33)
    ctx_phi = t_context(tsys, tspace, 0, 3, device="cpu")
    tc = t_dist(tspace, K, "cpu")
    vt_p = partition_volume_tables(tc, ctx_phi.vt)
    free_np = (tc.partition(ctx_phi.free.numpy().astype(np.int8))
               .astype(bool) & tc.pad_mask_flat())
    free = torch.tensor(free_np)
    A_phi = TV.poisson_jacobian_el(vt_p, tsys.cylindrical, tsys.pi)
    op = tc.make_constrained_operator(A_phi, free)
    inv = TSW.invert_local_matrices(
        tc, TSW.build_local_matrices(tc, A_phi, free))
    M1 = TSW.make_ras_inv_precond(tc, inv)
    p1 = TSW.build_p1_coarse_dist(tc, op, free_np, tspace.dof_coords)
    M2 = TSW.make_two_level_inv_precond(tc, inv, p1, op, free)
    r = torch.where(free, 1.0, 0.0).to(torch.float64)
    res1 = TK.bicgstab(op, r, torch.zeros_like(r), M1, 1e-10, 3000)
    res2 = TK.bicgstab(op, r, torch.zeros_like(r), M2, 1e-10, 3000)
    for res in (res1, res2):
        assert float((r - op(res.x)).norm() / r.norm()) < 1e-9
    assert float((res2.x - res1.x).abs().max()) <= 1e-8 * float(
        res1.x.abs().max())
    assert res2.iterations < res1.iterations, (res1.iterations,
                                               res2.iterations)

    jspace = JFS(JST.pore_without_dna_mesh(60, 33), 1)
    jc = j_dist(jspace, make_device_mesh(K))
    A_np = A_phi.numpy()
    jA = jc.put_sharded(jnp.asarray(A_np))
    jfree = jc.put_sharded(jnp.asarray(free_np))
    jop = jc.make_constrained_operator(jA, jfree)
    jp1 = JSW.build_p1_coarse_dist(jc, jop, free_np, jspace.dof_coords)
    for a, b in zip(p1, jp1):
        assert rel(a, b) <= 1e-10, rel(a, b)
    j_inv = JSW.invert_local_matrices(
        jc, JSW.build_local_matrices(jc, jA, jfree))
    Mt = TSW.make_two_level_inv_precond(
        tc, torch.tensor(np.asarray(j_inv, np.float32)), p1, op, free)
    Mj = JSW.make_two_level_inv_precond(jc, j_inv, jp1, jop, jfree)
    b = np.random.RandomState(3).standard_normal(tc.Kb) * free_np
    assert rel(Mt(torch.tensor(b)), Mj(jnp.asarray(b))) <= 1e-6
    assert interop.halo_plan(jc.plan).B_N == tc.plan.B_N
