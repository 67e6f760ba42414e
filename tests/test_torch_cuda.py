"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Imports no jax, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Everything here is marked ``cuda`` and skips without a CUDA device."""

import numpy as np
import pytest
import torch

from pnp_tpu_torch.fem.geometry import build_volume_tables
from pnp_tpu_torch.fem.space import FunctionSpace
from pnp_tpu_torch.meshio.structured import rect_mesh
from pnp_tpu_torch.operators import kernels as K
from pnp_tpu_torch.problems import pore_case
from pnp_tpu_torch.solvers.direct import contraction_ok
from pnp_tpu_torch.workloads.instationary_pnp_from_pb import \
    run_instationary_pnp_from_pb

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: decided at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def well_conditioned(S, N):
    rng = np.random.RandomState(0)
    return (rng.rand(S, N, N).astype(np.float32) * 0.1
            + np.eye(N, dtype=np.float32)[None] * N * 0.05)


def permuted(N=256):
    rng = np.random.RandomState(1)
    A0 = (np.eye(N, dtype=np.float32) * 8
          + rng.standard_normal((N, N)).astype(np.float32))
    P = np.eye(N, dtype=np.float32)[rng.permutation(N)]
    return (P @ A0).astype(np.float32)[None]


@pytest.mark.parametrize("case", ["2x128", "2x300", "1x40", "2x1000",
                                  "permuted"])
def test_gj_kernel_matches_plain(cuda, case):
    """Same IEEE f32 operations in the same order as the plain version:
    equal up to 1e-6 of the inverse's scale (room for a rounding-order
    slip); the contraction probe passes."""
    if case == "permuted":
        A = torch.tensor(permuted(), device=cuda)
    else:
        S, N = map(int, case.split("x"))
        A = torch.tensor(well_conditioned(S, N), device=cuda)
    n0 = K.launches["gj_inverse"]
    X = K.gj_inverse(A)
    assert K.launches["gj_inverse"] == n0 + 1
    Xp = K.gj_inverse_plain(A)
    torch.testing.assert_close(X, Xp, rtol=0,
                               atol=1e-6 * float(Xp.abs().max()))
    assert contraction_ok(A, X)


@pytest.mark.parametrize("cylindrical", [False, True])
@pytest.mark.parametrize("degree", [1, 2, 3])
def test_pb_kernel_matches_plain(cuda, cylindrical, degree):
    """f64, sums in another order: 1e-13 of each output's scale."""
    space = FunctionSpace(rect_mesh(20, 16, 2.0, 1.0, y0=0.1), degree)
    vt = build_volume_tables(space, max(3, 2 * degree), cuda)
    g = torch.Generator().manual_seed(degree)
    u = (torch.rand(space.ndof, generator=g, dtype=torch.float64) * 2 - 1)
    args = (u.to(cuda)[vt.dofmap], vt.shape, vt.gradphi, vt.qw, vt.qy,
            1.0, 0.06, cylindrical, np.pi)
    n0 = K.launches["pb_residual_jacobian"]
    r, A = K.pb_residual_jacobian(*args)
    assert K.launches["pb_residual_jacobian"] == n0 + 1
    r_p, A_p = K.pb_residual_jacobian_plain(*args)
    for a, b in ((r, r_p), (A, A_p)):
        torch.testing.assert_close(a, b, rtol=1e-13,
                                   atol=1e-13 * float(b.abs().max()))


def test_slice_on_card_matches_cpu(cuda):
    """One presolved step of the slice on the card against the CPU plain
    path, to 1e-9 relative (CUDA scatters sum with atomics in a varying
    order; kernels and cuBLAS sum in another order)."""
    sys_, space = pore_case(30, 17)
    K.reset_launch_counts()
    a = run_instationary_pnp_from_pb(sys_, space, n_steps=1,
                                     presolve_potential=True, device=cuda)
    assert min(K.launches.values()) > 0
    b = run_instationary_pnp_from_pb(sys_, space, n_steps=1,
                                     presolve_potential=True)
    for name in ("phi", "cp", "cm"):
        x, y = getattr(a, name).cpu(), getattr(b, name)
        assert float((x - y).abs().max()) <= 1e-9 * float(y.abs().max())
