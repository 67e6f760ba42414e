"""Kernel 1's CUDA source (``pnp_tpu_torch/csrc/gj_inverse.cu``) compiled as
plain C++ against ``csrc/emulation/cuda_runtime.h`` and run on the host:
one std::thread per CUDA thread, barriers for ``__syncthreads`` and the
warp shuffles. This checks the source's index arithmetic, synchronisation
and scratch layout against the plain PyTorch version; what nvcc accepts,
and every time, is checked on the card (tests/test_torch_cuda.py,
chip_smoke.py). Needs g++ with C++20; skips without one."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pnp_tpu_torch.operators import kernels as K

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel source as a host library, bound like the real one."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    out = tmp_path_factory.mktemp("gj_emulation") / "libgj_emulated.so"
    cmd = [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
           "-x", "c++", "-DGJ_HOST_EMULATION",
           "-I", str(K.CSRC / "emulation"), str(K.CSRC / "gj_inverse.cu"),
           "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0 and "c++20" in proc.stderr:
        pytest.skip("this g++ has no C++20")
    assert proc.returncode == 0, proc.stderr
    return K._bind_gj(ctypes.CDLL(str(out)))


def run_emulated(lib, A, panel, variant):
    """``kernels._gj_core_cuda`` on numpy arrays; scratch and padding are
    filled with NaN so that any read of an unwritten value shows."""
    S, N, _ = A.shape
    ld = lib.gj_work_pitch(N)
    work = np.full((S, N, ld), np.nan, np.float32)
    work[:, :, :N] = A
    out = np.full((S, N, N), np.nan, np.float32)
    n_f32 = lib.gj_scratch_floats(S, N, panel, variant)
    n_i32 = lib.gj_scratch_ints(S, N, panel, variant)
    assert n_f32 > 0 and n_i32 > 0
    fscratch = np.full(n_f32, np.nan, np.float32)
    iscratch = np.full(n_i32, -(2 ** 30), np.int32)
    err = lib.gj_inverse_f32(work.ctypes.data, out.ctypes.data,
                             fscratch.ctypes.data, iscratch.ctypes.data,
                             S, N, panel, variant, None)
    assert err == 0
    return out, iscratch[:S * N].reshape(S, N)


def matrix(S, N, rows):
    rng = np.random.RandomState(N)
    A = (rng.rand(S, N, N).astype(np.float32) * 0.1
         + np.eye(N, dtype=np.float32)[None] * N * 0.05)
    if rows == "reversed":
        return A[:, ::-1].copy()
    if rows == "permuted":
        return A[:, rng.permutation(N)].copy()
    return A


# variant 0: one block a matrix; variant 1: the panel path
@pytest.mark.parametrize("S,N,panel,variant,rows", [
    (2, 40, 32, 0, "permuted"),      # one full panel and a ragged one
    (1, 20, 32, 0, "as made"),       # N below the panel width
    (1, 100, 16, 0, "reversed"),     # pivots from the last rows
    (1, 20, 64, 1, "as made"),
    (2, 40, 16, 1, "permuted"),
    (1, 70, 32, 1, "reversed"),      # three 32-row blocks, ragged panel
])
def test_gj_source_on_host_matches_plain(emulated, S, N, panel, variant, rows):
    """The same pivot rows as the plain version and the same inverse to f32
    round-off (1e-5 of its scale; the sums are rounded in another order)."""
    A = matrix(S, N, rows)
    X, pivots = run_emulated(emulated, A, panel, variant)
    Xp, pivots_p = K._gj_core_plain(torch.tensor(A), panel)
    assert np.isfinite(X).all()
    assert np.array_equal(pivots, pivots_p.numpy())
    np.testing.assert_allclose(X, Xp.numpy(), rtol=0,
                               atol=1e-5 * float(Xp.abs().max()))


def test_gj_source_rejects_bad_plans(emulated):
    """No kernel: the one-block variant above its largest order or panel,
    a panel-path width off the 4-column grid, an empty batch."""
    for S, N, panel, variant in ((1, K.SMALL_N_MAX + 1, 32, 0),
                                 (1, 100, 64, 0), (1, 100, 30, 1),
                                 (1, 100, 128, 1), (0, 100, 64, 1),
                                 (1, 100, 0, 1), (1, 100, 32, 2)):
        assert emulated.gj_scratch_floats(S, N, panel, variant) == 0
        assert emulated.gj_scratch_ints(S, N, panel, variant) == 0
