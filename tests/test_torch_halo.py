"""The port's halo plan and owner-partitioned SpMV/assembly against the
reference package on the CPU: plans identical for K = 1, 2, 4, 8 at P1
and P2 (in element order and in Morton order), the partition helpers
identical, and the sharded SpMV, dot and nonlinear assembler against the
dense single-device assembly to 1e-13. Model: tests/test_halo.py (which
places the shards on 8 virtual devices; here they are a batch axis)."""

import numpy as np
import pytest
import torch

from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio import structured as JST
from pnp_tpu.parallel import dist as JDIST
from pnp_tpu.parallel import halo as JH

from pnp_tpu_torch import interop
from pnp_tpu_torch.fem import assembly as TA
from pnp_tpu_torch.fem.geometry import build_volume_tables as t_tables
from pnp_tpu_torch.fem.space import FunctionSpace as TFS
from pnp_tpu_torch.meshio import structured as TST
from pnp_tpu_torch.operators import volume as TV
from pnp_tpu_torch.parallel import dist as TDIST
from pnp_tpu_torch.parallel import halo as TH

torch.set_num_threads(1)

TOL = 1e-13


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def spaces(degree):
    return (TFS(TST.rect_mesh(20, 14, 2.0, 1.0), degree),
            JFS(JST.rect_mesh(20, 14, 2.0, 1.0), degree))


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("K", [1, 2, 4, 8])
@pytest.mark.parametrize("morton", [False, True], ids=["plain", "morton"])
def test_plans_identical(degree, K, morton):
    tspace, jspace = spaces(degree)
    dm = np.asarray(tspace.dofmap)
    np.testing.assert_array_equal(dm, np.asarray(jspace.dofmap))
    perm = TDIST.locality_element_order(tspace.mesh) if morton else None
    if morton:
        np.testing.assert_array_equal(
            perm, JDIST.locality_element_order(jspace.mesh))
    got = TH.build_halo_plan(dm, tspace.ndof, K, element_perm=perm)
    want = JH.build_halo_plan(dm, tspace.ndof, K, element_perm=perm)
    carried = interop.halo_plan(want)
    for f in ("K", "B_E", "B_N", "B_H", "H_pair", "ndof"):
        assert getattr(got, f) == getattr(want, f) == getattr(carried, f), f
    for f in ("dofmap_local", "elem_ids", "send_idx", "recv_pos",
              "owned_global", "owner_of"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(getattr(carried, f), b)
    # the partition helpers
    rng = np.random.RandomState(K)
    x = rng.standard_normal(tspace.ndof)
    np.testing.assert_array_equal(TH.partition_vector(got, x),
                                  JH.partition_vector(want, x))
    np.testing.assert_array_equal(
        TH.unpartition_vector(got, TH.partition_vector(got, x)), x)
    arr = rng.standard_normal((tspace.mesh.num_tris, 3))
    np.testing.assert_array_equal(TH.partition_element_array(got, arr),
                                  JH.partition_element_array(want, arr))
    owned = got.owned_global[got.owned_global >= 0]
    assert sorted(owned.tolist()) == list(range(tspace.ndof))


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("K", [2, 4, 8])
def test_sharded_spmv_and_assembler_match_dense(degree, K):
    """The (K, B_N) SpMV with the packed exchange equals the single-device
    element-block SpMV, its dot the global dot, and the assembler of a
    nonlinear element kernel (a PB-like residual) the global assembly, all
    to 1e-13."""
    tspace, _ = spaces(degree)
    vt = t_tables(tspace, 2 * degree, "cpu")
    A_el = TV.laplace_jacobian_el(vt) + 0.3 * TV.mass_jacobian_el(vt)
    plan = TH.build_halo_plan(tspace.dofmap, tspace.ndof, K,
                              TDIST.locality_element_order(tspace.mesh))
    A_p, dm, send, recv = TH.plan_tensors(plan, "cpu", A_el)
    assert tuple(A_p.shape) == (K, plan.B_E) + tuple(A_el.shape[1:])
    spmv, dot = TH.make_sharded_spmv(plan, "cpu", A_p, dm, send, recv)
    rng = np.random.RandomState(0)
    x = rng.standard_normal(tspace.ndof)
    xp = torch.tensor(TH.partition_vector(plan, x))
    y = TH.unpartition_vector(plan, spmv(xp).numpy())
    y_ref = TA.spmv(A_el, torch.tensor(x), vt.dofmap, tspace.ndof)
    assert rel(y, y_ref) <= TOL, rel(y, y_ref)
    assert abs(float(dot(xp, xp)) - float(x @ x)) <= TOL * float(x @ x)

    qw = torch.tensor(TH.partition_element_array(plan, vt.qw.numpy()))
    shape = vt.shape

    def kernel(xe):                       # (K, B_E, n) -> (K, B_E, n)
        u = torch.einsum("kei,qi->keq", xe, shape)
        return torch.einsum("keq,qi,keq->kei", torch.sinh(u), shape, qw)

    assemble = TH.make_sharded_assembler(plan, "cpu", dm, send, recv)
    got = TH.unpartition_vector(plan, assemble(xp, kernel).numpy())
    ue = torch.tensor(x)[vt.dofmap]
    u = ue @ shape.T
    want = TA.scatter_add(torch.einsum("eq,qi,eq->ei", torch.sinh(u), shape,
                                       vt.qw), vt.dofmap, tspace.ndof)
    assert rel(got, want) <= TOL, rel(got, want)


def test_exchange_round_trip():
    """The forward exchange delivers each halo slot its owner's value, and
    the backward exchange returns each halo slot's contribution to it."""
    tspace, _ = spaces(1)
    K = 4
    plan = TH.build_halo_plan(tspace.dofmap, tspace.ndof, K)
    _, send, recv = TH.plan_tensors(plan, "cpu")
    x = np.arange(tspace.ndof, dtype=np.float64) + 1.0
    xp = torch.tensor(TH.partition_vector(plan, x))[None]   # (1, K, B_N)
    halo = TH.forward_halo(xp, send, recv, plan.B_H)[0].numpy()
    loc2glob = np.full((K, plan.B_N + plan.B_H), -1)
    loc2glob[:, :plan.B_N] = plan.owned_global
    dm = np.asarray(tspace.dofmap)
    for s in range(K):
        for e_loc, e in enumerate(plan.elem_ids[s]):
            if e >= 0:
                loc2glob[s, plan.dofmap_local[s, e_loc]] = dm[e]
    for s in range(K):
        g = loc2glob[s, plan.B_N:]
        real = g >= 0
        np.testing.assert_array_equal(halo[s][real], x[g[real]])
        assert (halo[s][~real] == 0).all()
    # each halo slot sends 1 to its owner: the owner's count of readers
    ones = torch.tensor((loc2glob[:, plan.B_N:] >= 0).astype(np.float64))
    back = TH.backward_return(ones[None], send, recv, plan.B_N)[0].numpy()
    readers = np.zeros(tspace.ndof)
    for s in range(K):
        g = loc2glob[s, plan.B_N:]
        np.add.at(readers, g[g >= 0], 1.0)
    np.testing.assert_array_equal(TH.unpartition_vector(plan, back), readers)
