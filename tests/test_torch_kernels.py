"""The port's two kernels on the CPU: their plain versions against the
reference's Pallas kernels (interpret mode) and plain paths, and the
wrappers' routing and input checks. Each kernel against its plain version
on the card: tests/test_torch_cuda.py; the CUDA source of kernel 1 run on
the host: tests/test_torch_kernel_emulation.py."""

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


@pytest.mark.parametrize("outputs", ["residual", "jacobian", "both"])
@pytest.mark.parametrize("cylindrical", [False, True])
def test_pb_plain_output_variants(cylindrical, outputs):
    """Each output variant of the plain version (the kernel's arithmetic in
    torch ops: one expm1 for sinh and cosh) against the port's volume forms
    and the interpret-mode Pallas kernel, to 1e-13; the output not asked
    for is ``None``."""
    from pnp_tpu_torch.operators import volume as V

    vt, ue, params = pb_inputs(cylindrical, seed=2)
    args = torch_pb_args(vt, ue, params)
    t = interop.volume_tables(vt)
    E = ue.shape[0]
    r_pl, A_pl = pb_residual_jacobian_pallas(
        pad_to_tile(ue), jnp.asarray(vt.shape), pad_to_tile(vt.gradphi),
        pad_to_tile(vt.qw), pad_to_tile(vt.qy), *params, interpret=True)
    r, A = K.pb_residual_jacobian_plain(*args, outputs=outputs)
    assert (r is None) == (outputs == "jacobian")
    assert (A is None) == (outputs == "residual")
    if r is not None:
        for ref in (V.pb_residual_el(args[0], t, *params).numpy(),
                    np.asarray(r_pl[:E])):
            np.testing.assert_allclose(r.numpy(), ref, rtol=1e-13, atol=1e-13)
    if A is not None:
        for ref in (V.pb_jacobian_el(args[0], t, *params).numpy(),
                    np.asarray(A_pl[:E])):
            np.testing.assert_allclose(A.numpy(), ref, rtol=1e-13, atol=1e-13)
    # the prepared object on CPU tables is the same plain version
    got = K.PBElement(*args[1:])(args[0], outputs)
    for a, b in zip(got, (r, A)):
        assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(KeyError):
        K.pb_residual_jacobian_plain(*args, outputs="neither")


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-6)],
                         ids=["f64", "f32"])
def test_sinh_cosh_from_one_expm1(dtype, tol):
    """The kernel's one-exp form, in torch ops, over |u| from 1e-8 to 20,
    both signs and 0: within 1e-13 relative of torch's f64 sinh and cosh
    (f32: 1e-6). The naive (e - 1/e) / 2 would be off by 1e-8 relative at
    |u| = 1e-8."""
    mags = torch.cat([torch.zeros(1, dtype=torch.float64),
                      torch.logspace(-8, np.log10(20.0), 400,
                                     dtype=torch.float64)])
    u = torch.cat([mags, -mags])
    sh, ch = K.sinh_cosh_one_exp(u.to(dtype))
    assert sh.dtype == ch.dtype == dtype
    torch.testing.assert_close(sh.double(), torch.sinh(u), rtol=tol, atol=0)
    torch.testing.assert_close(ch.double(), torch.cosh(u), rtol=tol, atol=0)
    naive = (torch.exp(u) - torch.exp(-u)) / 2
    assert float(((naive - torch.sinh(u)).abs()
                  / torch.sinh(u).abs().clamp_min(1e-300)).max()) > 1e-10


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


def reversed_rows(S, N):
    """Well-conditioned, rows reversed: column k's pivot is row N - 1 - k,
    so the first panel's pivots lie in the last rows, far outside its
    diagonal block (the cross-block case that pivoting inside a diagonal
    block cannot serve, pnp_tpu/solvers/direct.py:40-62)."""
    return well_conditioned(S, N)[:, ::-1].copy()


GJ_CASES = {
    "dominant-128": lambda: well_conditioned(2, 128),
    "ragged-77": lambda: well_conditioned(2, 77),
    "permuted-256": permuted,
    "reversed-150": lambda: reversed_rows(1, 150),
}


@pytest.mark.parametrize("case", sorted(GJ_CASES))
def test_gj_panel_widths_agree(case):
    """Panel widths 1 (column by column), 8 and 32 are the same elimination
    up to rounding: the same pivot rows (no near-ties in these matrices),
    and inverses that agree with each other and with the f64 inverse
    (numpy's: LAPACK in f64) to 1e-4 of its scale. f32 round-off times the
    condition number: measured 3.2e-5 on the permuted matrix, under 2e-6 on
    the others."""
    A = GJ_CASES[case]()
    ref = np.linalg.inv(A.astype(np.float64))
    scale = np.abs(ref).max()
    At = torch.tensor(A)
    Xs = {B: K.gj_inverse_plain(At, equilibrate=False, panel=B)
          for B in (1, 8, 32)}
    pivots = {B: K._gj_core_plain(At, B)[1] for B in (1, 8, 32)}
    for B in (8, 32):
        assert torch.equal(pivots[B], pivots[1])
        np.testing.assert_allclose(Xs[B].numpy(), Xs[1].numpy(), rtol=0,
                                   atol=1e-4 * scale)
    for B, X in Xs.items():
        np.testing.assert_allclose(X.double().numpy(), ref, rtol=0,
                                   atol=1e-4 * scale)
        assert contraction_ok(At, X), B


@pytest.mark.parametrize("S,N,panel", [(2, 20, 32), (1, 5, 64), (1, 1, 32),
                                       (2, 77, 32), (1, 130, 64)])
def test_gj_plain_ragged_orders(S, N, panel):
    """Orders below one panel and orders that are no multiple of the panel
    width go through the same code: ||AX - I|| at the reference kernel's
    bar, and equal to the column-by-column elimination to f32 round-off."""
    A = well_conditioned(S, N)
    X = K.gj_inverse_plain(torch.tensor(A), panel=panel)
    resid = (np.einsum("sij,sjk->sik", A.astype(np.float64),
                       X.double().numpy()) - np.eye(N))
    assert np.max(np.abs(resid)) < 5e-6
    X1 = K.gj_inverse_plain(torch.tensor(A), panel=1)
    np.testing.assert_allclose(X.numpy(), X1.numpy(), rtol=0,
                               atol=1e-5 * float(X1.abs().max()))


def test_gj_plain_cross_block_pivots():
    """Pivots taken from far below the panel: the rows are swapped whole
    (finished columns included), the probe passes, and the default panel
    width finds the pivot rows of the column-by-column elimination."""
    A = reversed_rows(2, 200)
    At = torch.tensor(A)
    pivots = K._gj_core_plain(At)[1]
    assert torch.equal(pivots, K._gj_core_plain(At, 1)[1])
    assert int(pivots[0, 0]) == 199 and int(pivots[1, 31]) == 199 - 31
    X = K.gj_inverse_plain(At)
    assert contraction_ok(At, X)
    assert bool(j_contraction_ok(jnp.asarray(A), jnp.asarray(X.numpy())))
    ref = np.linalg.inv(A.astype(np.float64))
    np.testing.assert_allclose(X.double().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_gj_panel_width_follows_order():
    """One width per shape class, chosen from N: the one-block kernel's up
    to its largest order, the panel path's above."""
    assert K.panel_width(369) == K.panel_width(K.SMALL_N_MAX) == K.SMALL_PANEL
    assert K.panel_width(K.SMALL_N_MAX + 1) == K.panel_width(12097) == K.PANEL


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


def test_element_spmv_takes_cuda_only_and_cpu_takes_plain():
    """Kernel 3 refuses CPU tensors; the assembly's SpMVs on the CPU take
    the plain version and launch nothing."""
    from pnp_tpu_torch.fem import assembly as FA

    dofmap = torch.tensor([[0, 1, 2], [1, 3, 2]])
    A = torch.arange(18, dtype=torch.float64).reshape(2, 3, 3)
    free = torch.tensor([True, True, False, True])
    with pytest.raises(ValueError, match="CUDA"):
        K.ElementSpmv(A, dofmap, 4, free)
    before = dict(K.launches)
    x = torch.tensor([1.0, -2.0, 5.0, 0.5], dtype=torch.float64)
    y = FA.make_constrained_operator(A, dofmap, 4, free)(x)
    dense = torch.zeros(4, 4, dtype=torch.float64)
    for e in range(2):
        dense[dofmap[e][:, None], dofmap[e][None, :]] += A[e]
    f = free.double()
    want = (dense * f[:, None] * f[None, :] + torch.diag(1.0 - f)) @ x
    torch.testing.assert_close(y, want, rtol=1e-15, atol=0)
    assert K.launches == before


def test_incidence_table_is_built_once_and_goes_with_its_dof_map():
    """One table a dof map, shared by every apply, and refused for another
    size; the cache entry goes when the dof map does."""
    import gc

    dofmap = torch.tensor([[0, 1, 2], [1, 3, 2]])
    t = K.table_for(dofmap, 4)
    assert K.table_for(dofmap, 4) is t
    with pytest.raises(ValueError, match="not 5"):
        K.table_for(dofmap, 5)
    assert t.offsets.tolist() == [0, 1, 3, 5, 6]
    assert t.entries.tolist() == [0, 1, 3, 2, 5, 4]
    key = id(dofmap)
    assert key in K._tables
    del dofmap
    gc.collect()
    assert key not in K._tables
