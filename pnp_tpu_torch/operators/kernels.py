"""The port's hand-written Hopper kernels, their bindings and plain versions.

Counterpart of ``pnp_tpu/operators/pallas_kernels.py``. Both Pallas
kernels there become CUDA C++ kernels in ``pnp_tpu_torch/csrc/``:

* :func:`gj_inverse` (``csrc/gj_inverse.cu``) replaces
  ``batched_inverse_pallas``: batched explicit f32 inverses by
  panel-blocked Gauss-Jordan with partial pivoting over the whole
  remaining column. Per panel of columns: the in-place steps on the panel
  alone, the panel's row swaps on all other columns, then one rank-panel
  product on them, so the working set is passed over N / panel times
  instead of N. Three kernel variants, chosen from N here
  (:func:`gj_variant`): one block a matrix with 32-wide panels in shared
  memory up to N = 512 (the block-RAS local batches), and above it a
  panel path with 64-wide panels whose steps take one launch a panel on a
  thread block cluster where the cluster holds the panel (the dense stage
  batch, the Schwarz batches) and one launch a column above that (the
  mid-size Poisson matrix, the very-large set-up). Its bound on an H100
  is the 2 N^3 f32 flop a matrix on the FMA pipe; the source's header
  note has the design and its measured times. The plain version is the
  same algorithm in torch ops, with the panel width as an argument;
* :func:`pb_residual_jacobian` and :class:`PBElement`
  (``csrc/pb_element.cu``) replace ``pb_residual_jacobian_pallas``: the
  fused PB element residual and Jacobian, either alone or both. The kernel
  is latency-bound at the path's sizes (its bytes take 1-3 us on an H100):
  four threads an element, one ``expm1`` for ``sinh`` and ``cosh``, the
  upper triangle of A alone accumulated; :class:`PBElement` holds what
  does not change from call to call. The plain version is the same
  arithmetic in torch ops;
* :class:`ElementSpmv` (``csrc/element_spmv.cu``) replaces no Pallas
  kernel: the constrained matrix-free SpMV from per-element blocks, which
  the reference leaves to XLA as gather, batched matvec and scatter-add,
  in one launch. Bytes bound it (the blocks, read once); one thread a dof
  row gathers over the row's elements from an incidence table built once
  per dof map (:func:`incidence_table`), so it sums in a fixed order and
  without atomics. The plain version is ``fem/assembly.py``'s gather,
  einsum and ``index_add_``, which the CPU takes;
* :func:`cg_update`, :func:`cg_direction` and :func:`krylov_unconverged`
  (``csrc/cg_update.cu``) replace no Pallas kernel: the conjugate-gradient
  iteration's vector updates and convergence flag, which XLA fuses in the
  reference and which were seventeen torch launches an iteration here, in
  three launches that round every value as those launches did (the same
  bits). Bytes bound them; the plain versions are the torch operations,
  which the CPU takes;
* :class:`GraphLoop` (``csrc/krylov_loop.cu``) replaces no Pallas kernel:
  it runs a Krylov iteration captured as a CUDA graph (``solvers/krylov.py``)
  as the body of a device-side while loop, which its one-thread kernel
  ends when the iteration's "not converged" flag reads false or after a
  limit the host sets, so that the host launches and reads once a run of
  iterations and not once an iteration. It has no plain version: the CPU
  runs the solvers' eager loop.

Build: at first use one ``nvcc`` per ``csrc/*.cu``, all started together,
then one link into a shared library with a plain C interface, in
``pnp_tpu_torch/_build/<hash>/``
keyed on a hash of the sources and flags, and ``ctypes`` loads it. Nothing
is built or imported at module import.

Routing: a CPU tensor takes the plain PyTorch version; a CUDA tensor
launches the kernel or raises. There is no fallback from one to the
other. Each wrapper adds one to ``launches[name]`` where it launches its
kernel, and nowhere else (a call captured into a CUDA graph by
``solvers.krylov`` is counted once for each iteration its loop runs
instead), and opens a ``kernels.<name>`` span
(``utils.profiling``) with the batch ``b`` and the order ``n`` (kernel 1
also its ``path``, counted in ``gj_paths``; kernel 3: the systems ``s``,
the elements ``e`` and ``n``). Kernel 3's routing sits
in ``fem/assembly.py``, whose torch ops are its plain version.
:class:`GraphLoop`'s launches are ``solvers.krylov.graph_counts["loops"]``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
import weakref

import torch

from ..utils.profiling import host_copy, span

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

launches = {"gj_inverse": 0, "pb_residual_jacobian": 0, "element_spmv": 0,
            "cg_update": 0, "cg_direction": 0, "krylov_unconverged": 0}
#: kernel 1's launched calls by path (its variants 0, 2 and 1)
gj_paths = {"one_block": 0, "cluster_panel": 0, "column_panel": 0}

_lib = None


def reset_launch_counts() -> None:
    for counts in (launches, gj_paths):
        for name in counts:
            counts[name] = 0


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


def build(defines=()) -> dict:
    """Compile ``csrc/*.cu`` (if not built yet for these sources) and load
    the library. Returns {"path", "seconds", "cached", "log"}; ``log``
    holds ptxas' register/spill report of a fresh build. ``defines``:
    extra ``-D`` flags (``tools/pb_sweep.py`` builds kernel 2's every
    design with ``-DPB_ALL_DESIGNS``); the library they give replaces the
    loaded one for this process."""
    global _lib
    sources = sorted(CSRC.glob("*.cu"))
    flags = [*NVCC_FLAGS, *defines]
    h = hashlib.sha256(" ".join(flags).encode())
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
        nvcc, pid = _nvcc(), os.getpid()
        # one nvcc per source, all started together, then one link
        objs = [out_dir / f"{src.stem}.{pid}.o" for src in sources]
        tmp = out_dir / f"libpnp_kernels.{pid}.so"
        try:
            procs = [subprocess.Popen(
                [nvcc, *flags, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objs)]
            outs = [(p.communicate()[0], p.returncode) for p in procs]
            log = "".join(out for out, _ in outs)
            if any(rc != 0 for _, rc in outs):
                raise RuntimeError(f"nvcc failed:\n{log}")
            proc = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}):\n{log}")
            (out_dir / "build.log").write_text(log)
            os.replace(tmp, lib_path)
        finally:
            for path in (*objs, tmp):
                path.unlink(missing_ok=True)
    if _lib is None or _lib._name != str(lib_path):
        _lib = _bind(ctypes.CDLL(str(lib_path)))
    return {"path": str(lib_path), "seconds": time.perf_counter() - t0,
            "cached": cached, "log": log}


def _bind_gj(lib):
    """Argument types of ``csrc/gj_inverse.cu``'s C interface."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gj_inverse_f32.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.gj_inverse_f32.restype = i
    for fn in (lib.gj_work_pitch, lib.gj_plan_cluster):
        fn.argtypes = [i]
        fn.restype = i
    for fn in (lib.gj_scratch_floats, lib.gj_scratch_ints):
        fn.argtypes = [i, i, i, i, i]
        fn.restype = ctypes.c_longlong
    return lib


def _bind(lib):
    _bind_gj(lib)
    _bind_spmv(lib)
    _bind_cg(lib)
    _bind_loop(lib)
    return _bind_pb(lib)


def _bind_pb(lib):
    """Argument types of ``csrc/pb_element.cu``'s C interface."""
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("pb_element_f64", "pb_element_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, d, i, d, i, i, i, i, i, p]
        fn.restype = i
    lib.pb_empty_launch.argtypes = [i, i, i, p]
    lib.pb_empty_launch.restype = i
    return lib


def _library():
    if _lib is None:
        build()
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


#: per CUDA device: its index and the function that returns its current
#: stream's handle (:func:`_device_stream`), made once
_devices: dict = {}


def _device_stream(device):
    """``(index, stream)`` of CUDA ``device``: its index and a function
    that returns its current stream's handle, an int for ctypes. The
    public ``torch.cuda.current_stream`` builds a ``Stream`` object on
    every call, several times the cost of the one lookup that a launch
    needs; torch's own generated code reads the handle the same way."""
    entry = _devices.get(device)
    if entry is None:
        d = torch.device(device)
        index = d.index if d.index is not None else torch.cuda.current_device()
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        if raw is None:
            def stream():
                return torch.cuda.current_stream(index).cuda_stream
        else:
            def stream():
                return raw(index)
        entry = _devices[device] = (index, stream)
    return entry


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


# panel widths, settled on the H100: the one-block kernel serves N up to
# SMALL_N_MAX with panels of 32 columns in shared memory, the panel path
# takes wider panels (the update's flop per byte is a quarter of the width)
SMALL_N_MAX = 512
SMALL_PANEL = 32
PANEL = 64
#: kernel 1's paths by variant number
GJ_PATH_NAMES = {0: "one_block", 1: "column_panel", 2: "cluster_panel"}


def panel_width(N: int) -> int:
    """The panel width both versions use for order N."""
    return SMALL_PANEL if N <= SMALL_N_MAX else PANEL


def gj_variant(lib, S: int, N: int) -> int:
    """The kernel variant ``lib`` (kernel 1's library) takes for an (S, N, N)
    batch: 0, one block a matrix, up to SMALL_N_MAX; above it 2, a panel a
    cluster launch, where the plan finds a cluster whose blocks hold the
    panel's rows in registers, else 1, a launch a column."""
    if N <= SMALL_N_MAX:
        return 0
    return 2 if lib.gj_scratch_floats(S, N, PANEL, 2, 0) > 0 else 1


def _gj_core_plain(W, panel=None):
    """Panel-blocked Gauss-Jordan with partial pivoting over the whole
    remaining column, in torch ops (the algorithm of ``csrc/gj_inverse.cu``):
    per panel of ``panel`` columns, the in-place steps on the panel alone
    (rows swapped whole), then one rank-``panel`` product on all other
    columns. ``panel=1`` is a column-by-column elimination. Returns the
    inverse and the pivot rows, (S, N) int64."""
    W = W.clone()
    S, N, _ = W.shape
    B = panel_width(N) if panel is None else int(panel)
    b = torch.arange(S, device=W.device)
    perm = torch.empty((S, N), dtype=torch.int64, device=W.device)
    for k0 in range(0, N, B):
        nb = min(B, N - k0)
        P = W[:, :, k0:k0 + nb]                              # a view
        for kk in range(nb):
            k = k0 + kk
            p = k + torch.argmax(P[:, k:, kk].abs(), dim=1)  # lowest on ties
            perm[:, k] = p
            row_k, row_p = W[b, k], W[b, p]
            W[b, p] = row_k
            W[b, k] = row_p
            piv = P[:, k, kk].clone()
            r = P[:, k, :] / piv[:, None]
            r[:, kk] = 1.0 / piv
            c = P[:, :, kk].clone()
            c[:, k] = 0.0
            P[:, :, kk] = 0.0
            P.baddbmm_(c[:, :, None], r[:, None, :], alpha=-1.0)
            P[:, k, :] = r
        if nb == N:
            break
        # rank-nb update of all other columns: W <- W + (G - E_K) W[K, :]
        G = P.clone()
        R = W[:, k0:k0 + nb, :].clone()
        W[:, k0:k0 + nb, :] = 0.0
        W.baddbmm_(G, R)
        W[:, :, k0:k0 + nb] = G
    # undo the row swaps as one column gather: out[:, j] = W[:, g[j]]
    g = torch.arange(N, device=W.device).repeat(S, 1)
    perm_h = perm.tolist()
    for s in range(S):
        gs = list(range(N))
        for r_ in range(N - 1, -1, -1):
            p_ = perm_h[s][r_]
            gs[r_], gs[p_] = gs[p_], gs[r_]
        g[s] = torch.tensor(gs, device=W.device)
    return torch.gather(W, 2, g[:, None, :].expand(S, N, N)), perm


def _gj_core_cuda(W, panel=None, variant=None, cluster=None):
    """Launch ``csrc/gj_inverse.cu``: the variant :func:`gj_variant`
    picks, with ``panel_width(N)``. ``panel``, ``variant`` and ``cluster``
    (variant 2's blocks a cluster; None: the plan's) override that choice
    for the card-side checks and tuning; callers leave them alone. Returns
    the inverse and the pivot rows, (S, N) int32."""
    if not W.is_cuda:
        raise ValueError("gj_inverse kernel needs a CUDA tensor")
    lib = _library()
    S, N, _ = W.shape
    if variant is None:
        variant = gj_variant(lib, S, N)
    B = panel_width(N) if panel is None else panel
    C = cluster or 0
    n_f32 = lib.gj_scratch_floats(S, N, B, variant, C)
    n_i32 = lib.gj_scratch_ints(S, N, B, variant, C)
    if n_f32 <= 0 or n_i32 <= 0:
        raise ValueError(f"gj_inverse: no kernel for S={S}, N={N}, "
                         f"panel={B}, variant={variant}, cluster={C}")
    ld = lib.gj_work_pitch(N)
    # the working copy, rows pitched to a multiple of 4 floats
    work = torch.empty((S, N, ld), dtype=torch.float32, device=W.device)
    work[:, :, :N] = W
    if ld > N:
        work[:, :, N:] = 0.0
    out = torch.empty((S, N, N), dtype=torch.float32, device=W.device)
    fscratch = torch.empty(n_f32, dtype=torch.float32, device=W.device)
    iscratch = torch.empty(n_i32, dtype=torch.int32, device=W.device)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.gj_inverse_f32(work.data_ptr(), out.data_ptr(),
                                 fscratch.data_ptr(), iscratch.data_ptr(),
                                 S, N, B, variant, C, stream)
    _check(err, "gj_inverse")
    launches["gj_inverse"] += 1
    gj_paths[GJ_PATH_NAMES[variant]] += 1
    return out, iscratch[:S * N].view(S, N)


def _equilibrated(core, A, equilibrate: bool):
    """Symmetric diagonal scaling A~ = S A S (S = 1/sqrt|diag A|) around
    the elimination, inverse unscaled as S inv(A~) S (as the reference's
    ``batched_inverse_pallas(equilibrate=True)``)."""
    if not equilibrate:
        return core(A)[0]
    d = torch.diagonal(A, dim1=1, dim2=2).abs()
    s = torch.rsqrt(torch.clamp_min(d, 1e-30))
    X = core(A * s[:, :, None] * s[:, None, :])[0]
    return X * s[:, :, None] * s[:, None, :]


def gj_inverse(A, equilibrate: bool = True):
    """Explicit inverses of a batch of f32 matrices: (S, N, N) -> (S, N, N).

    CUDA tensors launch ``csrc/gj_inverse.cu`` (the one-block kernel up to
    N = 512, the panel path above: a cluster launch a panel where a
    cluster holds the panel, else a launch a column); CPU tensors take
    :func:`gj_inverse_plain`. Any N, S up to 65,535. The span names the
    path (``GJ_PATH_NAMES``, or ``plain``)."""
    _check_square_f32(A)
    S, N = A.shape[0], A.shape[-1]
    if _route(A) == "cpu":
        core, path = _gj_core_plain, "plain"
    else:
        variant = gj_variant(_library(), S, N)
        core = lambda W: _gj_core_cuda(W, variant=variant)
        path = GJ_PATH_NAMES[variant]
    with span("kernels.gj_inverse", b=S, n=N, path=path):
        return _equilibrated(core, A, equilibrate)


def gj_inverse_plain(A, equilibrate: bool = True, panel=None):
    """Plain PyTorch version of :func:`gj_inverse` (the same panel-blocked
    algorithm; sums rounded in another order), on any device. ``panel``:
    the panel width, by default the kernel's for this N."""
    _check_square_f32(A)
    return _equilibrated(lambda W: _gj_core_plain(W, panel), A, equilibrate)


# ---------------------------------------------------------------------------
# Kernel 2: fused PB element residual + Jacobian (csrc/pb_element.cu)
# ---------------------------------------------------------------------------

#: what a call returns: the residual alone, the Jacobian alone, or both
PB_OUTPUTS = {"residual": 1, "jacobian": 2, "both": 3}
# the design settled on the H100 (tools/pb_sweep.py): threads an element,
# staged through shared memory (0 or 1), threads a block; the first two
# are the one design csrc/pb_element.cu compiles unless built with
# -DPB_ALL_DESIGNS
PB_DESIGN = (4, 0, 128)


def _check_pb_tables(shape, gradphi, qw, qy) -> None:
    if shape.ndim != 2 or shape.shape[1] not in (3, 6, 10):
        raise ValueError(f"shape must be (q, n) with n in 3, 6, 10; got "
                         f"{tuple(shape.shape)}")
    q, n = shape.shape
    E = gradphi.shape[0]
    want = {"gradphi": (E, q, n, 2), "qw": (E, q), "qy": (E, q)}
    for name, t in (("gradphi", gradphi), ("qw", qw), ("qy", qy)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != shape.dtype or t.device != shape.device:
            raise ValueError(f"{name} must match shape's dtype and device")
    if shape.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pb_residual_jacobian takes f32 or f64, got "
                         f"{shape.dtype}")


def _check_pb_ue(ue, E, n, dtype, device) -> None:
    if (tuple(ue.shape) != (E, n) or ue.dtype != dtype
            or ue.device != device):
        raise ValueError(f"ue must be {(E, n)} {dtype} on {device}, got "
                         f"{tuple(ue.shape)} {ue.dtype} on {ue.device}")


def _aligned(t):
    """``t`` contiguous and on a 16-byte boundary (the kernel's vector
    loads), copied only if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def sinh_cosh_one_exp(u):
    """sinh(u) and cosh(u) from one ``expm1``, as ``csrc/pb_element.cu``
    computes them: with m = expm1(|u|) and e = m + 1, sinh|u| =
    m (m + 2) / (2 e) and cosh u = 1 + m^2 / (2 e). No cancellation near 0
    (``(e - 1/e) / 2`` loses every digit there)."""
    m = torch.expm1(u.abs())
    h = 0.5 / (m + 1.0)
    return torch.copysign(m * ((m + 2.0) * h), u), 1.0 + m * (m * h)


class PBElement:
    """Kernel 2 prepared for one set of tables: shapes, dtypes and devices
    checked once, the tables contiguous and their pointers, the C function,
    the device index and ``8 pi l_b c0`` held, so that a call does only
    what depends on ``ue``: allocate what it returns, look up the stream,
    one C call.

    ``plan(ue, outputs)`` returns ``(r, A)``, ``None`` for the one not
    asked for (``outputs``: "residual", "jacobian" or "both"); ue (E, n),
    shape (q, n), gradphi (E, q, n, 2), qw/qy (E, q), all f64 (or all f32),
    n = 3, 6, 10 -> r (E, n), A (E, n, n). CUDA tables launch
    ``csrc/pb_element.cu`` (built at the first call); CPU tables take the
    plain version."""

    def __init__(self, shape, gradphi, qw, qy, l_b, c0, cylindrical, pi):
        _check_pb_tables(shape, gradphi, qw, qy)
        self.route = _route(shape)
        self.q, self.n = shape.shape
        self.E = gradphi.shape[0]
        self.dtype, self.device = shape.dtype, shape.device
        self.tables = tuple(_aligned(t) for t in (shape, gradphi, qw, qy))
        self.params = (l_b, c0, bool(cylindrical), pi)
        self._call = None           # bound at the first CUDA call

    def _bind(self):
        """The C function with everything that does not change from call
        to call filled in."""
        lib = _library()
        fn = (lib.pb_element_f64 if self.dtype == torch.float64
              else lib.pb_element_f32)
        shape, gradphi, qw, qy = (t.data_ptr() for t in self.tables)
        l_b, c0, cyl, pi = self.params
        E, q, n = self.E, self.q, self.n
        coef, two_pi, cyl = 8.0 * pi * l_b * c0, 2.0 * pi, int(cyl)
        index, raw_stream = _device_stream(self.device)

        def call(ue, r, A, out, design):
            return fn(ue, shape, gradphi, qw, qy, r, A, E, q, n, coef, cyl,
                      two_pi, out, *design, index, raw_stream())

        return call

    def __call__(self, ue, outputs: str = "both"):
        out = PB_OUTPUTS[outputs]
        _check_pb_ue(ue, self.E, self.n, self.dtype, self.device)
        with span("kernels.pb_residual_jacobian", b=self.E, n=self.n):
            if self.route == "cpu":
                return _pb_plain(ue, *self.tables, *self.params, out)
            return self._launch(ue, out, PB_DESIGN)

    def _launch(self, ue, out: int, design):
        """Launch the kernel for output code ``out`` (PB_OUTPUTS' values)
        in ``design`` = (threads an element, staged, threads a block);
        another design than PB_DESIGN needs a build that holds it."""
        if self._call is None:
            self._call = self._bind()
        ue = _aligned(ue)
        E, n = self.E, self.n
        r = ue.new_empty((E, n)) if out & 1 else None
        A = ue.new_empty((E, n, n)) if out & 2 else None
        err = self._call(ue.data_ptr(), r.data_ptr() if out & 1 else None,
                         A.data_ptr() if out & 2 else None, out, design)
        _check(err, "pb_residual_jacobian")
        launches["pb_residual_jacobian"] += 1
        return r, A


def _pb_plain(ue, shape, gradphi, qw, qy, l_b, c0, cylindrical, pi, out):
    """The kernel's arithmetic in torch ops: per quadrature point the
    interpolated u and grad u, sinh and cosh from one expm1, and the sums
    over the points; ``out`` as in PB_OUTPUTS' values."""
    f = qw * qy * (2.0 * pi) if cylindrical else qw
    coef = 8.0 * pi * l_b * c0
    sinh_u, cosh_u = sinh_cosh_one_exp(torch.einsum("ei,qi->eq", ue, shape))
    r = A = None
    if out & 1:
        gu = torch.einsum("ei,eqid->eqd", ue, gradphi)
        r = (torch.einsum("eqd,eqid,eq->ei", gu, gradphi, f)
             + torch.einsum("eq,qi->ei", coef * sinh_u * f, shape))
    if out & 2:
        A = (torch.einsum("eq,eqid,eqjd->eij", f, gradphi, gradphi)
             + torch.einsum("eq,qi,qj->eij", f * coef * cosh_u, shape, shape))
    return r, A


def pb_residual_jacobian_plain(ue, shape, gradphi, qw, qy, l_b, c0,
                               cylindrical, pi, outputs: str = "both"):
    """Plain PyTorch version of :func:`pb_residual_jacobian`, on any
    device: ``(r, A)``, ``None`` for the one not asked for."""
    _check_pb_tables(shape, gradphi, qw, qy)
    _check_pb_ue(ue, gradphi.shape[0], shape.shape[1], shape.dtype,
                 shape.device)
    return _pb_plain(ue, shape, gradphi, qw, qy, l_b, c0, cylindrical, pi,
                     PB_OUTPUTS[outputs])


def pb_residual_jacobian(ue, shape, gradphi, qw, qy, l_b, c0, cylindrical,
                         pi, outputs: str = "both"):
    """Fused PB element residual (E, n) and Jacobian (E, n, n), every
    argument checked: one :class:`PBElement` made and called once. A caller
    that keeps its tables keeps the :class:`PBElement` instead."""
    return PBElement(shape, gradphi, qw, qy, l_b, c0, cylindrical, pi)(
        ue, outputs)


# ---------------------------------------------------------------------------
# Kernel 3: constrained element-block SpMV (csrc/element_spmv.cu)
# ---------------------------------------------------------------------------

def _bind_spmv(lib):
    """Argument types of ``csrc/element_spmv.cu``'s C interface."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("element_spmv_f64", "element_spmv_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [p, ll, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
    return lib


@dataclasses.dataclass(frozen=True)
class IncidenceTable:
    """The element blocks' rows by dof: row i of the global matrix is the
    sum of the block rows ``entries[offsets[i]:offsets[i + 1]]``, each the
    flat index ``e * n + l`` of an element e whose local dof l is i, in
    increasing e. ``dofmap`` is the dof map as int32."""

    dofmap: torch.Tensor      # (E, n) int32
    offsets: torch.Tensor     # (ndof + 1,) int32
    entries: torch.Tensor     # (E * n,) int32


def incidence_table(dofmap, ndof: int) -> IncidenceTable:
    """Kernel 3's table for ``dofmap`` (E, n), entries in [0, ndof), on its
    device, in torch ops and without a host read: a stable sort of the
    flat dof map orders each dof's (e, l) by element."""
    E, n = dofmap.shape
    if E * n >= 2 ** 31 or ndof >= 2 ** 31:
        raise ValueError(f"element_spmv: {E} x {n} entries or {ndof} dofs "
                         "do not fit int32")
    keys, order = torch.sort(dofmap.reshape(-1), stable=True)
    rows = torch.arange(ndof + 1, dtype=keys.dtype, device=keys.device)
    offsets = torch.searchsorted(keys, rows)
    return IncidenceTable(dofmap.to(torch.int32).contiguous(),
                          offsets.to(torch.int32), order.to(torch.int32))


# id(dofmap) -> (a weak reference to it, its IncidenceTable); an entry goes
# when its dof map does
_tables: dict = {}


def table_for(dofmap, ndof: int) -> IncidenceTable:
    """The incidence table of ``dofmap``, built at its first use and kept
    as long as the dof map lives: every apply of a run on one dof map
    shares one. A dof map has one ``ndof``; another raises."""
    key = id(dofmap)
    held = _tables.get(key)
    if held is None or held[0]() is not dofmap:
        held = (weakref.ref(dofmap), incidence_table(dofmap, ndof))
        _tables[key] = held
        weakref.finalize(dofmap, _tables.pop, key, None)
    table = held[1]
    if table.offsets.shape[0] != ndof + 1:
        raise ValueError(f"element_spmv: the dof map's table has "
                         f"{table.offsets.shape[0] - 1} dofs, not {ndof}")
    return table


class ElementSpmv:
    """Kernel 3 prepared for one set of element blocks: ``op(x)`` is the
    product of the matrix they assemble to with x, and with ``free`` the
    constrained one, x on the constrained rows and their couplings masked
    out (``fem.assembly.make_operator``).

    ``A_el`` (E, n, n) with x (ndof,) and ``free`` (ndof,) or None; or
    ``A_el`` (S_A, E, n, n) with x (S, ndof) and ``free`` (S, ndof) or
    None, where S_A is S or 1 (one set of blocks serves every system, as
    the species mass matrix does); the output is shaped as x. f64 or f32,
    x in the blocks' type. CUDA tensors only: the CPU takes the plain
    version in ``fem/assembly.py``."""

    def __init__(self, A_el, dofmap, ndof: int, free=None):
        if not A_el.is_cuda:
            raise ValueError("element_spmv kernel needs CUDA tensors")
        if A_el.dtype not in (torch.float64, torch.float32):
            raise ValueError(f"element_spmv takes f64 or f32, got "
                             f"{A_el.dtype}")
        if A_el.ndim not in (3, 4):
            raise ValueError(f"element blocks must be (E, n, n) or "
                             f"(S, E, n, n), got {tuple(A_el.shape)}")
        self.batched = A_el.ndim == 4
        A4 = A_el if self.batched else A_el[None]
        S_A, E, n, n2 = A4.shape
        if n != n2 or tuple(dofmap.shape) != (E, n) \
                or dofmap.device != A_el.device:
            raise ValueError(f"blocks {tuple(A_el.shape)} and dof map "
                             f"{tuple(dofmap.shape)} on {dofmap.device} "
                             "do not match")
        self.blocks = A4.contiguous()
        self.a_stride = 0 if S_A == 1 else E * n * n
        self.S_A, self.S_f, self.mask = S_A, None, None
        if free is not None:
            S_f = free.shape[0] if self.batched and free.ndim == 2 else None
            want = (S_f, ndof) if self.batched else (ndof,)
            if free.dtype != torch.bool or free.device != A_el.device \
                    or tuple(free.shape) != want or S_A not in (1, S_f):
                raise ValueError(f"free must be bool {want} on "
                                 f"{A_el.device} for {S_A} systems' blocks, "
                                 f"got {tuple(free.shape)} {free.dtype} on "
                                 f"{free.device}")
            self.S_f = S_f
            self.mask = free.contiguous().view(torch.uint8)
        self.table = table_for(dofmap, ndof)
        self.dtype, self.device = A_el.dtype, A_el.device
        self.E, self.n, self.ndof = E, n, ndof
        self._call = None           # bound at the first call

    def _bind(self):
        lib = _library()
        fn = (lib.element_spmv_f64 if self.dtype == torch.float64
              else lib.element_spmv_f32)
        blocks, a_stride = self.blocks.data_ptr(), self.a_stride
        mask = None if self.mask is None else self.mask.data_ptr()
        t = self.table
        dofmap, offsets, entries = (t.dofmap.data_ptr(), t.offsets.data_ptr(),
                                    t.entries.data_ptr())
        n, ndof = self.n, self.ndof
        index, raw_stream = _device_stream(self.device)

        def call(x, y, S):
            return fn(blocks, a_stride, x, mask, y, dofmap, offsets, entries,
                      S, ndof, n, index, raw_stream())

        return call

    def _systems(self, x) -> int:
        S = x.shape[0] if self.batched and x.ndim == 2 else 1
        if (x.dtype != self.dtype or x.device != self.device
                or tuple(x.shape) != ((S, self.ndof) if self.batched
                                      else (self.ndof,))
                or self.S_A not in (1, S)
                or self.S_f not in (None, S)):
            raise ValueError(
                f"x must be {'(S, ' if self.batched else '('}{self.ndof}) "
                f"{self.dtype} on {self.device} for {self.S_A} systems' "
                f"blocks and {self.S_f} masks, got {tuple(x.shape)} "
                f"{x.dtype} on {x.device}")
        return S

    def __call__(self, x):
        S = self._systems(x)
        with span("kernels.element_spmv", s=S, e=self.E, n=self.n):
            if self._call is None:
                self._call = self._bind()
            x = x.contiguous()
            y = torch.empty_like(x)
            err = self._call(x.data_ptr(), y.data_ptr(), S)
            _check(err, "element_spmv")
            launches["element_spmv"] += 1
            return y


# ---------------------------------------------------------------------------
# The CG iteration's updates and convergence flag (csrc/cg_update.cu)
# ---------------------------------------------------------------------------

def _bind_cg(lib):
    """Argument types of ``csrc/cg_update.cu``'s C interface."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cg_update_f64.argtypes = [p, p, p, p, p, p, i, ll, i, p]
    lib.cg_direction_f64.argtypes = [p, p, p, p, i, ll, i, p]
    lib.krylov_unconverged_f64.argtypes = [p, p, p, i, i, p]
    for fn in (lib.cg_update_f64, lib.cg_direction_f64,
               lib.krylov_unconverged_f64):
        fn.restype = i
    return lib


def nonzero_or_one(v):
    """``v`` with 1 where it is 0: the divisor the Krylov solvers take."""
    return torch.where(v == 0.0, 1.0, v)


def cg_update_plain(x, r, p, Ap, pAp, rz) -> None:
    alpha = rz / nonzero_or_one(pAp)
    x.add_(alpha * p)
    r.sub_(alpha * Ap)


def cg_direction_plain(p, z, rz_new, rz) -> None:
    p.mul_(rz_new / nonzero_or_one(rz)).add_(z)


def krylov_unconverged_plain(ss, tol):
    return torch.any(torch.sqrt(ss).to(tol.dtype) > tol)


def _rows(vectors, scalars, name: str):
    """(rows, n) of ``vectors`` (one shape, ..., n) and ``scalars`` (one
    value a row), all contiguous f64 CUDA tensors on one device (the
    Krylov solvers' vectors are f64); raises otherwise."""
    v0 = vectors[0]
    n = v0.shape[-1] if v0.ndim else 1
    rows = v0.numel() // max(n, 1)
    every = (*vectors, *scalars)
    if not all(t.is_cuda and t.dtype == torch.float64
               and t.device == v0.device and t.is_contiguous()
               for t in every) or any(
            t.shape != v0.shape for t in vectors) or any(
            t.numel() != rows for t in scalars):
        raise ValueError(
            f"{name} takes vectors of one shape and a value a row, "
            f"contiguous f64 on one CUDA device; got "
            f"{[(tuple(t.shape), t.dtype, str(t.device)) for t in every]}")
    return rows, n


def cg_update(x, r, p, Ap, pAp, rz) -> None:
    """CG's step along p in place: x += alpha p and r -= alpha Ap with
    alpha = rz / pAp a system (1 where pAp is 0); x, r, p, Ap (..., n),
    pAp and rz one value a system. CUDA tensors launch
    ``csrc/cg_update.cu``, CPU tensors take the torch operations."""
    if _route(x) == "cpu":
        return cg_update_plain(x, r, p, Ap, pAp, rz)
    p, Ap, pAp, rz = (v.contiguous() for v in (p, Ap, pAp, rz))
    rows, n = _rows((x, r, p, Ap), (pAp, rz), "cg_update")
    index, stream = _device_stream(x.device)
    with span("kernels.cg_update", s=rows, n=n):
        _check(_library().cg_update_f64(
            x.data_ptr(), r.data_ptr(), p.data_ptr(), Ap.data_ptr(),
            pAp.data_ptr(), rz.data_ptr(), rows, n, index, stream()),
            "cg_update")
        launches["cg_update"] += 1


def cg_direction(p, z, rz_new, rz) -> None:
    """CG's new direction in place: p = p beta + z with beta = rz_new / rz
    a system (1 where rz is 0). Routed as :func:`cg_update`."""
    if _route(p) == "cpu":
        return cg_direction_plain(p, z, rz_new, rz)
    z, rz_new, rz = (v.contiguous() for v in (z, rz_new, rz))
    rows, n = _rows((p, z), (rz_new, rz), "cg_direction")
    index, stream = _device_stream(p.device)
    with span("kernels.cg_direction", s=rows, n=n):
        _check(_library().cg_direction_f64(
            p.data_ptr(), z.data_ptr(), rz_new.data_ptr(), rz.data_ptr(),
            rows, n, index, stream()), "cg_direction")
        launches["cg_direction"] += 1


def krylov_unconverged(ss, tol):
    """The device flag "some system's norm is above its tolerance": the
    norms sqrt(ss) of the squared norms ``ss`` against ``tol`` (one value
    a system each). Routed as :func:`cg_update`; the flag is a new 0-dim
    bool tensor."""
    if _route(tol) == "cpu":
        return krylov_unconverged_plain(ss, tol)
    ss, tol = ss.contiguous(), tol.contiguous()
    rows, _ = _rows((ss, tol), (), "krylov_unconverged")
    index, stream = _device_stream(tol.device)
    flag = torch.empty((), dtype=torch.bool, device=tol.device)
    with span("kernels.krylov_unconverged", s=rows):
        _check(_library().krylov_unconverged_f64(
            ss.data_ptr(), tol.data_ptr(), flag.data_ptr(), rows, index,
            stream()), "krylov_unconverged")
        launches["krylov_unconverged"] += 1
    return flag


# ---------------------------------------------------------------------------
# The graphed Krylov loop (csrc/krylov_loop.cu)
# ---------------------------------------------------------------------------

def _bind_loop(lib):
    """Argument types of ``csrc/krylov_loop.cu``'s C interface."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.krylov_loop_create.argtypes = [p, p, p, i, ctypes.POINTER(p)]
    lib.krylov_loop_create.restype = i
    lib.krylov_loop_launch.argtypes = [p, p]
    lib.krylov_loop_launch.restype = i
    lib.krylov_loop_destroy.argtypes = [p]
    lib.krylov_loop_destroy.restype = None
    return lib


class GraphLoop:
    """``graph``, a ``torch.cuda.CUDAGraph`` captured with ``keep_graph``
    and not instantiated, as the body of a device-side while loop:
    ``run(n)`` launches it on the current stream to run until the bool
    ``flag`` it writes reads False or ``n`` times (n >= 1), and returns,
    after one read, the iterations it ran and the flag's last value. The
    loop keeps ``graph`` (and so the memory its capture holds) until
    :meth:`free`."""

    def __init__(self, graph, flag):
        if not (flag.is_cuda and flag.dtype == torch.bool
                and flag.numel() == 1):
            raise ValueError(f"the loop's flag must be one CUDA bool, got "
                             f"{tuple(flag.shape)} {flag.dtype} on "
                             f"{flag.device}")
        self._lib = _library()
        self._graph, self._flag = graph, flag
        self._ctl = torch.zeros(2, dtype=torch.int32, device=flag.device)
        index, self._stream = _device_stream(flag.device)
        handle = ctypes.c_void_p()
        _check(self._lib.krylov_loop_create(
            graph.raw_cuda_graph(), flag.data_ptr(), self._ctl.data_ptr(),
            index, ctypes.byref(handle)), "krylov_loop_create")
        self._handle = handle

    def run(self, n: int):
        self._ctl.fill_(n)
        _check(self._lib.krylov_loop_launch(self._handle, self._stream()),
               "krylov_loop_launch")
        left, more = host_copy(self._ctl).tolist()
        return n - left, bool(more)

    def free(self) -> None:
        if self._handle is not None:
            self._lib.krylov_loop_destroy(self._handle)
        self._handle = self._graph = self._flag = None
