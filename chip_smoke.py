#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``pnp_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero and prints no
result line:

1. the card's name and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``pnp_tpu_torch/csrc/`` (timed);
3. kernel 1 (Gauss-Jordan inverse) against its plain PyTorch version on
   the card: on the real (2, 4801, 4801) species stage batch of the
   full-size pore case (at the presolved potential: the batch the main
   path's first step inverts), at the reference kernel's test shapes and
   on a row-permuted matrix;
4. kernel 2 (fused PB element residual + Jacobian) against its plain
   version at E = 9200 in f64;
5. the whole slice on ``pore_case(30, 17)``, CUDA against the CPU plain
   path, to 1e-9 relative;
6. the main path: ``run_instationary_pnp_from_pb`` on ``pore_case(100, 55)``
   (4,801 nodes, the dense tier at full size): PB bootstrap, then 10
   presolved steps, with every kernel launch counted.

The next-to-last line is ``{"kernels": [...]}``: per kernel its launches
in phase 6 and the error and times measured in phases 3-4. The last line is
``{"ok": true, "device": {...}}``. Needs a CUDA device and ``nvcc``; writes
the run's outputs under ``chip_smoke_out/`` (gitignored).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
MAIN_STEPS = 10
# kernel 1 against its plain version: both run the same IEEE f32 operations
# in the same order (0 expected); the bound leaves room for a rounding
# difference amplified by the stage matrices' conditioning
GJ_REL_TOL = 1e-4
# kernel 2 against its plain version: f64, sums over quadrature points and
# dofs in another order
PB_REL_TOL = 1e-12
# the slice on the card against the CPU: index_add_ on CUDA sums with
# atomics in a varying order, and cuBLAS/the kernels sum in another order
SLICE_REL_TOL = 1e-9


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def rel_err(a, b) -> float:
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def gj_checks(torch, K, contraction_ok, dev):
    """Kernel 1 at the reference kernel's test shapes and on a row-permuted
    matrix (tests/test_pallas.py:49-85)."""
    import numpy as np

    for S, N in ((2, 128), (2, 300), (1, 40)):
        rng = np.random.RandomState(0)
        A = (rng.rand(S, N, N).astype(np.float32) * 0.1
             + np.eye(N, dtype=np.float32)[None] * N * 0.05)
        A = torch.tensor(A, device=dev)
        X = K.gj_inverse(A)
        resid = float((A.double() @ X.double()
                       - torch.eye(N, dtype=torch.float64, device=dev))
                      .abs().max())
        err = rel_err(X, K.gj_inverse_plain(A))
        print(f"  gj_inverse ({S}, {N}): |AX-I| {resid:.3e}  "
              f"rel err vs plain {err:.3e}")
        check(resid < 5e-6 and err <= GJ_REL_TOL, f"gj_inverse ({S}, {N})")
    rng = np.random.RandomState(1)
    N = 256
    A0 = (np.eye(N, dtype=np.float32) * 8
          + rng.standard_normal((N, N)).astype(np.float32))
    P = np.eye(N, dtype=np.float32)[rng.permutation(N)]
    A = torch.tensor((P @ A0)[None], device=dev)
    X = K.gj_inverse(A)
    resid = float((X[0].double() @ A[0].double()
                   - torch.eye(N, dtype=torch.float64, device=dev))
                  .abs().max())
    err = rel_err(X, K.gj_inverse_plain(A))
    ok = contraction_ok(A, X)
    print(f"  gj_inverse permuted (1, {N}): |XA-I| {resid:.3e}  rel err vs "
          f"plain {err:.3e}  contraction_ok {ok}")
    check(bool(torch.isfinite(X).all()) and resid < 1e-2 and ok
          and err <= GJ_REL_TOL, "gj_inverse permuted case")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from pnp_tpu_torch.operators import kernels as K
        from pnp_tpu_torch.problems import pore_case
        from pnp_tpu_torch.solvers import direct
        from pnp_tpu_torch.workloads.common import make_scalar_context
        from pnp_tpu_torch.workloads import instationary_pnp_from_pb as W
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    t_all = time.perf_counter()

    smi = nvidia_smi()
    print("[card] nvidia-smi name, power.limit:")
    print(smi, flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build ------------------------------------------------------
    info = K.build()
    print(f"[build] {info['seconds']:.2f} s (cached {info['cached']}) "
          f"-> {os.path.relpath(info['path'], REPO)}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    sys.stdout.flush()

    # ---- 3-4. kernels against their plain versions -----------------------
    sys_big, space_big = pore_case(100, 55)
    system0 = W.build_pnp_system(sys_big, space_big, device=dev)
    # at the raw biased start the stage matrices are near-singular in the
    # smooth direction and fail the probe with any f32 inverse (LAPACK's
    # included); the main path inverts them at the presolved potential
    uphi1, _ = system0.poisson_solve(system0.uphi0, system0.ucp0,
                                     system0.ucm0)
    A32 = system0.species_dense_f32(uphi1)
    check(tuple(A32.shape) == (2, 4801, 4801), f"stage batch {A32.shape}")
    X_k = K.gj_inverse(A32)
    X_p = K.gj_inverse_plain(A32)
    gj_err = float((X_k - X_p).abs().max())
    gj_rel = rel_err(X_k, X_p)
    gj_ok = direct.contraction_ok(A32, X_k)
    del X_k, X_p
    gj_ms = cuda_ms(torch, lambda: K.gj_inverse(A32), 3)
    gj_plain_ms = cuda_ms(torch, lambda: K.gj_inverse_plain(A32), 2)
    print(f"[kernel gj_inverse] (2, 4801) stage batch: max abs err vs plain "
          f"{gj_err:.3e} (rel {gj_rel:.3e}, tol {GJ_REL_TOL:g}), "
          f"contraction_ok {gj_ok}; kernel {gj_ms:.3f} ms, plain "
          f"{gj_plain_ms:.3f} ms")
    check(gj_ok and gj_rel <= GJ_REL_TOL, "gj_inverse on the stage batch")
    gj_checks(torch, K, direct.contraction_ok, dev)
    del A32
    sys.stdout.flush()

    ctx = make_scalar_context(sys_big, space_big, component=0, quad_order=3,
                              device=dev)
    vt = ctx.vt
    args = (system0.pb[vt.dofmap], vt.shape, vt.gradphi, vt.qw, vt.qy,
            sys_big.l_b, sys_big.c0, sys_big.cylindrical, sys_big.pi)
    r_k, A_k = K.pb_residual_jacobian(*args)
    r_p, A_p = K.pb_residual_jacobian_plain(*args)
    pb_err = max(float((r_k - r_p).abs().max()), float((A_k - A_p).abs().max()))
    pb_rel = max(rel_err(r_k, r_p), rel_err(A_k, A_p))
    pb_ms = cuda_ms(torch, lambda: K.pb_residual_jacobian(*args), 50)
    pb_plain_ms = cuda_ms(torch, lambda: K.pb_residual_jacobian_plain(*args),
                          50)
    E = vt.num_elements
    print(f"[kernel pb_residual_jacobian] E={E} f64: max abs err vs plain "
          f"{pb_err:.3e} (rel {pb_rel:.3e}, tol {PB_REL_TOL:g}); kernel "
          f"{pb_ms:.4f} ms, plain {pb_plain_ms:.4f} ms", flush=True)
    check(E == 9200 and pb_rel <= PB_REL_TOL, "pb_residual_jacobian")
    del system0, ctx, args

    # ---- 5. slice parity, CUDA against CPU ------------------------------
    sys_s, space_s = pore_case(30, 17)
    run = lambda d: W.run_instationary_pnp_from_pb(
        sys_s, space_s, n_steps=3, presolve_potential=True, device=d)
    res_gpu, res_cpu = run(dev), run("cpu")
    errs = {n: rel_err(getattr(res_gpu, n).cpu(), getattr(res_cpu, n))
            for n in ("phi", "cp", "cm")}
    cur = max(rel_err(torch.tensor(a), torch.tensor(b))
              for (_, *g), (_, *c) in zip(res_gpu.current_history,
                                          res_cpu.current_history)
              for a, b in zip(g, c))
    print(f"[slice parity] pore_case(30, 17), 3 presolved steps, CUDA vs "
          f"CPU: rel err phi {errs['phi']:.3e} cp {errs['cp']:.3e} "
          f"cm {errs['cm']:.3e} currents {cur:.3e} (tol {SLICE_REL_TOL:g})",
          flush=True)
    check(max(*errs.values(), cur) <= SLICE_REL_TOL, "slice parity")

    # ---- 6. the main path ------------------------------------------------
    out_dir = os.path.join(REPO, "chip_smoke_out")
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    direct.probe_failures["count"] = 0
    res = W.run_instationary_pnp_from_pb(
        sys_big, space_big, n_steps=MAIN_STEPS, presolve_potential=True,
        output_dir=out_dir, device=dev)
    counts = dict(K.launches)
    failures = direct.probe_failures["count"]
    ndof = space_big.ndof
    finite = all(tuple(v.shape) == (ndof,) and bool(torch.isfinite(v).all())
                 for v in (res.phi, res.cp, res.cm))
    _, ip, im = res.current_history[-1]
    with open(os.path.join(out_dir, "current.dat")) as f:
        rows = [line.split() for line in f if line.strip()]
    print(f"[main] pore_case(100, 55): {ndof} dofs, "
          f"{space_big.mesh.num_tris} triangles")
    print(f"[main] PB Newton iterations {res.pb_newton_iterations}, phase A "
          f"{1e3 * res.pb_seconds:.1f} ms, setup (A-C) "
          f"{1e3 * res.setup_seconds:.1f} ms")
    print("[main] step ms " + " ".join(f"{t:.2f}" for t in res.step_ms))
    print(f"[main] refinements per step {res.refinements}")
    print(f"[main] launches {counts}, probe failures {failures}, peak "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"[main] last currents t={res.time:g} ip {ip.tolist()} "
          f"im {im.tolist()}", flush=True)
    check(finite, "non-finite or misshapen final state")
    check(all(math.isfinite(v) for _, a, b in res.current_history
              for v in (*a, *b)), "non-finite currents")
    check(len(res.current_history) == MAIN_STEPS and len(rows) == MAIN_STEPS
          and all(len(r) == 1 + 2 * sys_big.n_surfaces for r in rows),
          "current.dat rows")
    check(failures == 0, f"{failures} contraction-probe failures")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    print(f"[done] {time.perf_counter() - t_all:.1f} s")

    kernels = [
        {"name": "gj_inverse", "route": "cuda",
         "source": "pnp_tpu_torch/csrc/gj_inverse.cu",
         "replaces": "pnp_tpu/operators/pallas_kernels.py:343",
         "launches": counts["gj_inverse"], "max_abs_err": gj_err,
         "ms": gj_ms, "plain_ms": gj_plain_ms},
        {"name": "pb_residual_jacobian", "route": "cuda",
         "source": "pnp_tpu_torch/csrc/pb_element.cu",
         "replaces": "pnp_tpu/operators/pallas_kernels.py:105",
         "launches": counts["pb_residual_jacobian"], "max_abs_err": pb_err,
         "ms": pb_ms, "plain_ms": pb_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any failed phase: report it and print no result
        traceback.print_exc()
        sys.exit(1)
