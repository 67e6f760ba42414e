#!/usr/bin/env python3
"""Check and time kernel 1 (``csrc/gj_inverse.cu``) on one NVIDIA GPU over
shapes, kernel variants and panel widths:

    python3 -m pnp_tpu_torch.tools.gj_sweep [--quick]

Per case: the kernel against its plain PyTorch version (pivot rows equal,
inverse within 1e-4 of its scale; orders up to 1,000 only, the plain
version's column loop is slow), the contraction probe, the kernel's time
(CUDA events; the wrapper's copies and allocations included) and the time
of ``torch.linalg.inv`` on the same tensor. Matrices are seeded: "dominant"
needs no row swap, "permuted" swaps rows at nearly every column (the
costliest case for the swap pass). ``--quick`` builds, prints the
compiler's register report and runs the small cases only. Exits non-zero
on any failed check. ``--profile`` adds the device time by kernel name of
one call at the main path's three shapes (``torch.profiler``).
"""

from __future__ import annotations

import subprocess
import sys

import torch

from pnp_tpu_torch.operators import kernels as K
from pnp_tpu_torch.solvers.direct import contraction_ok

REL_TOL = 1e-4


def matrix(kind: str, S: int, N: int, dev):
    g = torch.Generator(device="cpu").manual_seed(N + S)
    A = torch.rand((S, N, N), generator=g) * 0.1 + torch.eye(N) * N * 0.05
    if kind == "dominant":
        return A.to(dev)
    rows = torch.stack([torch.randperm(N, generator=g) for _ in range(S)])
    return torch.gather(A, 1, rows[:, :, None].expand(S, N, N)).to(dev)


def ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def case(kind, S, N, variant, panel, dev, reps=3) -> bool:
    A = matrix(kind, S, N, dev)
    X, perm = K._gj_core_cuda(A, panel, variant)
    torch.cuda.synchronize()
    ok = contraction_ok(A, X)
    note = ""
    if N <= 1000:
        Xp, perm_p = K._gj_core_plain(A, panel)
        rel = float((X - Xp).abs().max() / Xp.abs().max())
        same = bool((perm.long() == perm_p).all())
        ok = ok and rel <= REL_TOL and same
        note = f" rel err vs plain {rel:.2e}, pivots equal {same};"
    t = ms(lambda: K._gj_core_cuda(A, panel, variant), reps)
    t_lib = ms(lambda: torch.linalg.inv(A), reps)
    lib_rel = float((X - torch.linalg.inv(A)).abs().max() / X.abs().max())
    flop = 2.0 * S * N ** 3
    print(f"{kind:9s} ({S}, {N}, {N}) variant {variant} panel {panel}:"
          f"{note} probe {'ok' if ok else 'FAILED'}; kernel {t:.3f} ms "
          f"({flop / t / 1e9:.2f} TFLOP/s), torch.linalg.inv {t_lib:.3f} ms, "
          f"rel diff {lib_rel:.2e}", flush=True)
    return ok


def profile(kind, S, N, dev) -> None:
    A = matrix(kind, S, N, dev)
    K._gj_core_cuda(A)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        K._gj_core_cuda(A)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"profile {kind} ({S}, {N}, {N}): device kernel time {total:.3f} ms")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<6d} "
              f"{e.self_device_time_total / e.count:8.2f} us  {e.key[:60]}")
    sys.stdout.flush()


def main() -> int:
    if not torch.cuda.is_available():
        print("gj_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    info = K.build()
    print(f"build {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling",
                                   "error", "warning")):
            print("  " + line.strip())
    cases = [("dominant", 1, 20, 0, 32), ("dominant", 1, 20, 1, 64),
             ("permuted", 2, 40, 0, 32), ("permuted", 2, 40, 1, 16),
             ("permuted", 2, 300, 0, 32), ("permuted", 2, 300, 1, 64),
             ("dominant", 2, 300, 1, 32), ("permuted", 3, 369, 0, 32),
             ("permuted", 1, 1000, 1, 64), ("permuted", 1, 1000, 1, 32),
             ("permuted", 1, 515, 1, 48)]
    if "--quick" not in sys.argv:
        cases += [(kind, S, N, v, p)
                  for kind in ("dominant", "permuted")
                  for S, N, v, ps in ((96, 369, 0, (16, 32)),
                                      (96, 369, 1, (32, 64)),
                                      (48, 369, 0, (32,)),
                                      (2, 4801, 1, (32, 48, 64)),
                                      (1, 12097, 1, (32, 64)))
                  for p in ps]
    good = True
    for c in cases:
        good = case(*c, dev) and good
    if "--profile" in sys.argv:
        for kind in ("dominant", "permuted"):
            for S, N in ((96, 369), (2, 4801), (1, 12097)):
                profile(kind, S, N, dev)
    print("all checks passed" if good else "CHECKS FAILED")
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
