"""The port's hand-written Hopper kernels, their bindings and plain versions.

Counterpart of ``pnp_tpu/operators/pallas_kernels.py``. Both Pallas
kernels there become CUDA C++ kernels in ``pnp_tpu_torch/csrc/``:

* :func:`gj_inverse` (``csrc/gj_inverse.cu``) replaces
  ``batched_inverse_pallas``: batched explicit f32 inverses by Gauss-Jordan
  with partial pivoting over the whole remaining column;
* :func:`pb_residual_jacobian` (``csrc/pb_element.cu``) replaces
  ``pb_residual_jacobian_pallas``: the fused PB element residual and
  Jacobian.

Build: ``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a
plain C interface at first use, into ``pnp_tpu_torch/_build/<hash>/``
keyed on a hash of the sources and flags, and ``ctypes`` loads it. Nothing
is built or imported at module import.

Routing: a CPU tensor takes the plain PyTorch version; a CUDA tensor
launches the kernel or raises. There is no fallback from one to the
other. Each wrapper adds one to ``launches[name]`` where it launches its
kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from ..fem.geometry import VolumeTables
from . import volume as V

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = {"gj_inverse": 0, "pb_residual_jacobian": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def build() -> dict:
    """Compile ``csrc/*.cu`` (if not built yet for these sources) and load
    the library. Returns {"path", "seconds", "cached", "log"}; ``log``
    holds ptxas' register/spill report of a fresh build."""
    global _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libpnp_kernels.so"
    t0 = time.perf_counter()
    cached = lib_path.exists()
    log = ""
    if not cached:
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libpnp_kernels.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        (out_dir / "build.log").write_text(log)
        os.replace(tmp, lib_path)
    if _lib is None or _lib._name != str(lib_path):
        _lib = _bind(ctypes.CDLL(str(lib_path)))
    return {"path": str(lib_path), "seconds": time.perf_counter() - t0,
            "cached": cached, "log": log}


def _bind(lib):
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.gj_inverse_f32.argtypes = [p, p, p, p, p, i, i, p]
    lib.gj_inverse_f32.restype = i
    for name in ("pb_element_f64", "pb_element_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, d, i, d, p]
        fn.restype = i
    return lib


def _library():
    if _lib is None:
        build()
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


# ---------------------------------------------------------------------------
# Kernel 1: batched Gauss-Jordan inverse (csrc/gj_inverse.cu)
# ---------------------------------------------------------------------------

def _check_square_f32(A) -> None:
    if A.dtype != torch.float32 or A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"gj_inverse takes (S, N, N) float32, got "
                         f"{tuple(A.shape)} {A.dtype}")


def _gj_core_plain(W):
    """Gauss-Jordan with partial pivoting over the whole remaining column,
    in torch ops (the arithmetic of ``csrc/gj_inverse.cu`` step by step)."""
    W = W.clone()
    S, N, _ = W.shape
    b = torch.arange(S, device=W.device)
    perm = torch.empty((S, N), dtype=torch.int64, device=W.device)
    for k in range(N):
        p = k + torch.argmax(W[:, k:, k].abs(), dim=1)       # lowest on ties
        perm[:, k] = p
        row_k, row_p = W[b, k].clone(), W[b, p].clone()
        W[b, p] = row_k
        W[b, k] = row_p
        piv = W[:, k, k].clone()
        r = W[:, k, :] / piv[:, None]
        r[:, k] = 1.0 / piv
        c = W[:, :, k].clone()
        c[:, k] = 0.0
        W[:, :, k] = 0.0
        W -= c[:, :, None] * r[:, None, :]
        W[:, k, :] = r
    # undo the row swaps as one column gather: out[:, j] = W[:, g[j]]
    g = torch.arange(N, device=W.device).repeat(S, 1)
    perm_h = perm.cpu()
    for s in range(S):
        gs = list(range(N))
        for r_ in range(N - 1, -1, -1):
            p_ = int(perm_h[s, r_])
            gs[r_], gs[p_] = gs[p_], gs[r_]
        g[s] = torch.tensor(gs, device=W.device)
    return torch.gather(W, 2, g[:, None, :].expand(S, N, N))


def _gj_core_cuda(W):
    if not W.is_cuda:
        raise ValueError("gj_inverse kernel needs a CUDA tensor")
    lib = _library()
    S, N, _ = W.shape
    work = W.contiguous().clone()
    out = torch.empty_like(work)
    col = torch.empty((S, N), dtype=torch.float32, device=W.device)
    perm = torch.empty((S, N), dtype=torch.int32, device=W.device)
    g = torch.empty((S, N), dtype=torch.int32, device=W.device)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.gj_inverse_f32(work.data_ptr(), out.data_ptr(),
                                 col.data_ptr(), perm.data_ptr(),
                                 g.data_ptr(), S, N, stream)
    _check(err, "gj_inverse")
    launches["gj_inverse"] += 1
    return out


def _equilibrated(core, A, equilibrate: bool):
    """Symmetric diagonal scaling A~ = S A S (S = 1/sqrt|diag A|) around
    the elimination, inverse unscaled as S inv(A~) S (as the reference's
    ``batched_inverse_pallas(equilibrate=True)``)."""
    if not equilibrate:
        return core(A)
    d = torch.diagonal(A, dim1=1, dim2=2).abs()
    s = torch.rsqrt(torch.clamp_min(d, 1e-30))
    X = core(A * s[:, :, None] * s[:, None, :])
    return X * s[:, :, None] * s[:, None, :]


def gj_inverse(A, equilibrate: bool = True):
    """Explicit inverses of a batch of f32 matrices: (S, N, N) -> (S, N, N).

    CUDA tensors launch ``csrc/gj_inverse.cu``; CPU tensors take
    :func:`gj_inverse_plain`. Any N (no padding)."""
    _check_square_f32(A)
    core = _gj_core_plain if _route(A) == "cpu" else _gj_core_cuda
    return _equilibrated(core, A, equilibrate)


def gj_inverse_plain(A, equilibrate: bool = True):
    """Plain PyTorch version of :func:`gj_inverse` (same algorithm and
    roundings), on any device."""
    _check_square_f32(A)
    return _equilibrated(_gj_core_plain, A, equilibrate)


# ---------------------------------------------------------------------------
# Kernel 2: fused PB element residual + Jacobian (csrc/pb_element.cu)
# ---------------------------------------------------------------------------

def _check_pb(ue, shape, gradphi, qw, qy) -> None:
    if ue.ndim != 2 or ue.shape[1] not in (3, 6, 10):
        raise ValueError(f"ue must be (E, n) with n in 3, 6, 10; got "
                         f"{tuple(ue.shape)}")
    E, n = ue.shape
    q = shape.shape[0]
    want = {"shape": (q, n), "gradphi": (E, q, n, 2), "qw": (E, q),
            "qy": (E, q)}
    for name, t in (("shape", shape), ("gradphi", gradphi), ("qw", qw),
                    ("qy", qy)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != ue.dtype or t.device != ue.device:
            raise ValueError(f"{name} must match ue's dtype and device")
    if ue.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pb_residual_jacobian takes f32 or f64, got "
                         f"{ue.dtype}")


def pb_residual_jacobian_plain(ue, shape, gradphi, qw, qy, l_b, c0,
                               cylindrical, pi):
    """Plain PyTorch version: the volume PB forms on the same tables."""
    _check_pb(ue, shape, gradphi, qw, qy)
    t = VolumeTables(shape=shape, gradphi=gradphi, qw=qw, qy=qy, dofmap=None)
    return (V.pb_residual_el(ue, t, l_b, c0, cylindrical, pi),
            V.pb_jacobian_el(ue, t, l_b, c0, cylindrical, pi))


def pb_residual_jacobian(ue, shape, gradphi, qw, qy, l_b, c0, cylindrical,
                         pi):
    """Fused PB element residual (E, n) and Jacobian (E, n, n).

    ue (E, n), shape (q, n), gradphi (E, q, n, 2), qw/qy (E, q), all f64
    (or all f32). CUDA tensors launch ``csrc/pb_element.cu``; CPU tensors
    take :func:`pb_residual_jacobian_plain`."""
    if _route(ue) == "cpu":
        return pb_residual_jacobian_plain(ue, shape, gradphi, qw, qy, l_b,
                                          c0, cylindrical, pi)
    _check_pb(ue, shape, gradphi, qw, qy)
    lib = _library()
    E, n = ue.shape
    q = shape.shape[0]
    ins = [t.contiguous() for t in (ue, shape, gradphi, qw, qy)]
    r = torch.empty((E, n), dtype=ue.dtype, device=ue.device)
    A = torch.empty((E, n, n), dtype=ue.dtype, device=ue.device)
    fn = lib.pb_element_f64 if ue.dtype == torch.float64 else lib.pb_element_f32
    with torch.cuda.device(ue.device):
        stream = torch.cuda.current_stream(ue.device).cuda_stream
        err = fn(*(t.data_ptr() for t in ins), r.data_ptr(), A.data_ptr(),
                 E, q, n, 8.0 * pi * l_b * c0, 1 if cylindrical else 0,
                 2.0 * pi, stream)
    _check(err, "pb_residual_jacobian")
    launches["pb_residual_jacobian"] += 1
    return r, A
