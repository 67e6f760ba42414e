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
costliest case for the swap pass). Variant 2 (the cluster panel) is run
at every cluster size its plan takes, checked against variant 1 bit for
bit, and timed with its panel phase alone (the device time of the panel
kernels in one profiled call, ``torch.profiler``) beside variant 1's, at
the panel path's shapes (2, 3105), (2, 4801), (8, 1685) and (1, 12097).
``--quick`` builds, prints the compiler's register report and runs the
small cases only (``--quick --clusters``: and the cluster sizes). Exits
non-zero on any failed check. ``--profile`` adds the device time by
kernel name of one call at the main path's three shapes.
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


def device_ms(fn) -> dict:
    """Device time by kernel name of one call of ``fn``, ms."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def case(kind, S, N, variant, panel, dev, reps=3, cluster=None,
         library=True) -> bool:
    A = matrix(kind, S, N, dev)
    call = lambda: K._gj_core_cuda(A, panel, variant, cluster)
    X, perm = call()
    torch.cuda.synchronize()
    ok = contraction_ok(A, X)
    note = ""
    if N <= 1000:
        Xp, perm_p = K._gj_core_plain(A, panel)
        rel = float((X - Xp).abs().max() / Xp.abs().max())
        same = bool((perm.long() == perm_p).all())
        ok = ok and rel <= REL_TOL and same
        note = f" rel err vs plain {rel:.2e}, pivots equal {same};"
    if variant == 2:
        X1, perm_1 = K._gj_core_cuda(A, panel, 1)
        same = bool(torch.equal(X, X1) and torch.equal(perm, perm_1))
        ok = ok and same
        note += f" equal to variant 1 {same};"
    t = ms(call, reps)
    flop = 2.0 * S * N ** 3
    line = (f"{kind:9s} ({S}, {N}, {N}) variant {variant} panel {panel}"
            f"{'' if variant != 2 else f' cluster {cluster or 0}'}:"
            f"{note} probe {'ok' if ok else 'FAILED'}; kernel {t:.3f} ms "
            f"({flop / t / 1e9:.2f} TFLOP/s)")
    if N > 1000:
        by_name = device_ms(call)
        panel_ms = sum(v for k, v in by_name.items() if "panel" in k)
        cols = N if variant == 1 else -(-N // panel)
        line += (f", device {sum(by_name.values()):.3f} ms, panel phase "
                 f"{panel_ms:.3f} ms ({1e3 * panel_ms / N:.3f} us a column,"
                 f" {cols} panel launches)")
    if library:
        t_lib = ms(lambda: torch.linalg.inv(A), reps)
        lib_rel = float((X - torch.linalg.inv(A)).abs().max()
                        / X.abs().max())
        line += f", torch.linalg.inv {t_lib:.3f} ms, rel diff {lib_rel:.2e}"
    print(line, flush=True)
    return ok


def cluster_sizes(S: int, N: int, panel: int) -> list:
    """Every cluster size variant 2's plan takes at this shape."""
    lib = K._library()
    return [c for c in range(1, 17)
            if lib.gj_scratch_floats(S, N, panel, 2, c) > 0]


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
             ("permuted", 1, 515, 1, 48), ("dominant", 1, 20, 2, 64),
             ("permuted", 2, 300, 2, 64), ("permuted", 1, 1000, 2, 64),
             ("permuted", 1, 515, 2, 48)]
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
    if "--quick" not in sys.argv or "--clusters" in sys.argv:
        # the cluster panel at every size its plan takes, beside variant 1
        for S, N in ((2, 3105), (2, 4801), (8, 1685), (1, 12097)):
            good = case("permuted", S, N, 1, 64, dev, library=False) and good
            sizes = cluster_sizes(S, N, 64)
            print(f"({S}, {N}, {N}): cluster sizes {sizes}, the plan's "
                  f"{K._library().gj_plan_cluster(N)}, the wrapper's variant "
                  f"{K.gj_variant(K._library(), S, N)}", flush=True)
            for c in sizes:
                good = case("permuted", S, N, 2, 64, dev, cluster=c,
                            library=False) and good
    if "--profile" in sys.argv:
        for kind in ("dominant", "permuted"):
            for S, N in ((96, 369), (2, 4801), (1, 12097)):
                profile(kind, S, N, dev)
    print("all checks passed" if good else "CHECKS FAILED")
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
