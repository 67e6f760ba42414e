"""The port's two kernels on the CPU: their plain versions against the
reference's Pallas kernels (interpret mode) and plain paths, and the
wrappers' routing and input checks. Each kernel against its plain version
on the card: tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_tpu.fem.geometry import build_volume_tables as j_tables
from pnp_tpu.fem.space import FunctionSpace as JFS
from pnp_tpu.meshio.structured import rect_mesh
from pnp_tpu.operators import volume as JV
from pnp_tpu.operators.pallas_kernels import (batched_inverse_pallas,
                                              pad_to_tile,
                                              pb_residual_jacobian_pallas)
from pnp_tpu.solvers.direct import contraction_ok as j_contraction_ok

from pnp_tpu_torch import interop
from pnp_tpu_torch.operators import kernels as K
from pnp_tpu_torch.solvers.direct import contraction_ok

torch.set_num_threads(1)


def pb_inputs(cylindrical, seed=0):
    mesh = rect_mesh(20, 16, 2.0, 1.0, y0=0.1)
    vt = j_tables(JFS(mesh, 1), 3)
    u = np.random.RandomState(seed).uniform(-1, 1, mesh.num_nodes)
    ue = jnp.asarray(u)[vt.dofmap]
    return vt, ue, (1.0, 0.06, cylindrical, np.pi)


def torch_pb_args(vt, ue, params, device="cpu"):
    t = interop.volume_tables(vt, device)
    return (interop.field(ue, device), t.shape, t.gradphi, t.qw,
            t.qy) + params


# --- kernel 2: fused PB element residual + Jacobian ----------------------

@pytest.mark.parametrize("cylindrical", [False, True])
def test_pb_plain_matches_pallas_and_volume(cylindrical):
    """To 1e-13 against the interpret-mode Pallas kernel and the
    reference's volume forms, as tests/test_pallas.py holds the kernel."""
    vt, ue, params = pb_inputs(cylindrical)
    r_ref = JV.pb_residual_el(ue, vt, *params)
    A_ref = JV.pb_jacobian_el(ue, vt, *params)
    E = ue.shape[0]
    r_pl, A_pl = pb_residual_jacobian_pallas(
        pad_to_tile(ue), jnp.asarray(vt.shape), pad_to_tile(vt.gradphi),
        pad_to_tile(vt.qw), pad_to_tile(vt.qy), *params, interpret=True)
    r, A = K.pb_residual_jacobian_plain(*torch_pb_args(vt, ue, params))
    for ref in (r_ref, r_pl[:E]):
        np.testing.assert_allclose(r.numpy(), np.asarray(ref), rtol=1e-13,
                                   atol=1e-13)
    for ref in (A_ref, A_pl[:E]):
        np.testing.assert_allclose(A.numpy(), np.asarray(ref), rtol=1e-13,
                                   atol=1e-13)


def test_pb_wrapper_routes_cpu_to_plain():
    vt, ue, params = pb_inputs(True, seed=1)
    args = torch_pb_args(vt, ue, params)
    before = dict(K.launches)
    r, A = K.pb_residual_jacobian(*args)
    r_p, A_p = K.pb_residual_jacobian_plain(*args)
    assert torch.equal(r, r_p) and torch.equal(A, A_p)
    assert K.launches == before          # the plain version launches nothing
    f32 = [a.float() if isinstance(a, torch.Tensor) else a for a in args]
    r32, _ = K.pb_residual_jacobian(*f32)
    assert r32.dtype == torch.float32
    torch.testing.assert_close(r32.double(), r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bad", ["n", "dtype", "shape"])
def test_pb_wrapper_rejects_bad_input(bad):
    vt, ue, params = pb_inputs(False)
    ue_t, shape, gradphi, qw, qy = torch_pb_args(vt, ue, params)[:5]
    if bad == "n":
        ue_t, shape, gradphi = ue_t[:, :2], shape[:, :2], gradphi[:, :, :2]
    elif bad == "dtype":
        qw = qw.float()
    else:
        qy = qy[:-1]
    with pytest.raises(ValueError):
        K.pb_residual_jacobian(ue_t, shape, gradphi, qw, qy, *params)


# --- kernel 1: batched Gauss-Jordan inverse ---------------------------------

def well_conditioned(S, N):
    rng = np.random.RandomState(0)
    return (rng.rand(S, N, N).astype(np.float32) * 0.1
            + np.eye(N, dtype=np.float32)[None] * N * 0.05)


def permuted(N=256):
    """Row-permuted diagonally dominant matrix: near-zero diagonal pivots
    everywhere (the reference's pivoting regression case)."""
    rng = np.random.RandomState(1)
    A0 = (np.eye(N, dtype=np.float32) * 8
          + rng.standard_normal((N, N)).astype(np.float32))
    P = np.eye(N, dtype=np.float32)[rng.permutation(N)]
    return (P @ A0).astype(np.float32)[None]


@pytest.mark.parametrize("S,N", [(2, 128), (2, 300), (1, 40)])
def test_gj_plain_matches_pallas_and_inv(S, N):
    """The reference kernel's bar (||AX - I|| < 5e-6) and agreement with the
    interpret-mode Pallas inverse and XLA's inverse to f32 round-off
    (different pivot orders: relative 1e-5 of the inverse's scale)."""
    A = well_conditioned(S, N)
    X = K.gj_inverse_plain(torch.tensor(A))
    Xd = X.double().numpy()
    resid = np.einsum("sij,sjk->sik", A.astype(np.float64), Xd) - np.eye(N)
    assert np.max(np.abs(resid)) < 5e-6
    scale = np.abs(Xd).max()
    for ref in (batched_inverse_pallas(jnp.asarray(A), interpret=True),
                jnp.linalg.inv(jnp.asarray(A, jnp.float64))):
        np.testing.assert_allclose(Xd, np.asarray(ref, np.float64), rtol=0,
                                   atol=1e-5 * scale)
    assert contraction_ok(torch.tensor(A), X)
    assert bool(j_contraction_ok(jnp.asarray(A), jnp.asarray(X.numpy())))


def test_gj_plain_permuted_case():
    A = permuted()
    X = K.gj_inverse_plain(torch.tensor(A))
    assert torch.isfinite(X).all()
    Xd = X[0].double().numpy()
    resid = Xd @ A[0].astype(np.float64) - np.eye(A.shape[-1])
    assert np.max(np.abs(resid)) < 1e-2
    X_pl = np.asarray(batched_inverse_pallas(jnp.asarray(A), interpret=True),
                      np.float64)[0]
    resid_pl = X_pl @ A[0].astype(np.float64) - np.eye(A.shape[-1])
    # full-column pivoting is at least as accurate as the in-block pivoting
    assert np.max(np.abs(resid)) <= 2 * np.max(np.abs(resid_pl))
    assert contraction_ok(torch.tensor(A), X)


def test_gj_wrapper_routes_and_checks():
    A = torch.tensor(well_conditioned(2, 50))
    before = dict(K.launches)
    assert torch.equal(K.gj_inverse(A), K.gj_inverse_plain(A))
    assert torch.equal(K.gj_inverse(A, equilibrate=False),
                       K.gj_inverse_plain(A, equilibrate=False))
    assert K.launches == before
    for bad in (A.double(), A[:, :, :49], A[0]):
        with pytest.raises(ValueError):
            K.gj_inverse(bad)
    K.reset_launch_counts()
    assert set(K.launches.values()) == {0}
