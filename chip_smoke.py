#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``pnp_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero and prints no
result line:

1. the card's name and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``pnp_tpu_torch/csrc/`` (timed);
3. kernel 1 (panel-blocked Gauss-Jordan inverse) against its plain PyTorch
   version on the card: on the real (2, 4801, 4801) species stage batch of
   the full-size pore case (at the presolved potential: the batch the main
   path's first step inverts), timed beside ``torch.linalg.inv`` on the
   same tensor (``library_ms``; the port never calls it there); at the
   reference kernel's test shapes, on a row-permuted matrix, and in both
   kernel variants on orders below one panel, orders that are no multiple
   of the panel width, and a matrix whose first pivots lie in its last
   rows (far outside the first panel's diagonal block);
4. kernel 2 (fused PB element residual + Jacobian) against its plain
   version at E = 9200 in f64, in its three output variants (both, the
   residual alone, the Jacobian alone) through the prepared ``PBElement``
   the main path calls: the device time of each (profiler), the time of a
   call with the wrapper included, the share of the bound reached, and the
   floor (an empty kernel on the same grid, launched the same way);
5. the whole slice on ``pore_case(30, 17)``, CUDA against the CPU plain
   path, to 1e-9 relative;
6. the main path: ``run_instationary_pnp_from_pb`` on ``pore_case(100, 55)``
   (4,801 nodes, the dense tier at full size): PB bootstrap, then 10
   presolved steps, with every kernel launch counted, and a
   ``torch.profiler`` trace of one more step (``[dense trace]``);
7. block-RAS parity: ``pore_case(30, 17)`` forced onto the block-RAS tier,
   5 presolved steps with the factor refreshed every 4, CUDA against CPU,
   once with the mid-size Poisson inverse and once with the two-level RAS
   Poisson: iteration counts within one, fields and currents to 1e-9;
8. the block-RAS main path: ``run_instationary_pnp_from_pb`` on
   ``pore_case(160, 88)`` (12,097 nodes, 23,552 triangles), 8 presolved
   steps (two refresh windows), with every kernel launch counted;
8b. the species Krylov path: the same case with a tableau whose stage
   diagonals differ (three implicit-Euler substeps of unequal length; no
   factor serves every stage, so each stage builds its own local inverses:
   kernel 1 three times a step at (96, 369, 369)), 3 presolved steps with
   every launch counted (``[species-Krylov main]``), and the same path on
   ``pore_case(30, 17)``, CUDA against CPU, to 1e-9 with iteration counts
   within one (``[species-Krylov parity]``). ``fractional_step_theta()``
   has three stages but one stage diagonal, so it runs phase 8's factored
   path and not this one;
9. both kernels at the shapes that run gave them, on inputs built from its
   system: kernel 1 against its plain version on the (96, 369, 369)
   species RAS local batch at the presolved potential and on the
   (1, 12097, 12097) constant Poisson matrix of the mid-size tier, kernel
   2's three variants at E = 23,552;
10. a per-phase breakdown on the run's final state (species factor,
    species stages on a reused factor, Poisson re-solve), a
    ``torch.profiler`` trace of one factor step and one reuse step
    (summarised, and written under ``chip_smoke_out/block_ras/``), and the
    two-level RAS Poisson tier on the same state against the mid-size tier.

The next-to-last line is ``{"kernels": [...]}``: per kernel its launches
in phase 6 (in phase 8 as ``launches_block_ras``, in phase 8b as
``launches_species_krylov``), the error and times measured in phases 3-4
(kernel 2: the two-output variant, the one-output variants under
``variants``), its bound on this card (``bound_ms``, the
larger of bytes once in and once out over 3.35 TB/s and operations over
the peak rate of their type; ``bound_by`` says which) and ``library_ms``;
the same keys for the block-RAS run's shapes under ``block_ras_shape``
and ``poisson_shape``. The last line is ``{"ok": true, "device": {...}}``.
Needs a CUDA device and ``nvcc``; writes the runs' outputs under
``chip_smoke_out/`` (gitignored).
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
# the block-RAS tier at full size: 12,097 nodes, 23,552 triangles; blocks
# of 256 give K = 48 local sets of L = 369 dofs
RAS_CASE = (160, 88)
RAS_KW = dict(ras_block_size=256)
RAS_SHAPE = (12097, 23552, 48, 369)       # nodes, triangles, K, L
RAS_STEPS = 8
RAS_REFRESH = 4
PARITY_STEPS = 5
KRYLOV_STEPS = 3
# the mid-size and two-level Poisson tiers solve to 1e-10 relative
# residual; their solutions agree to 1e-8 (the reference's cross-tier
# bound, tests/test_block_ras.py:279)
TIER_REL_TOL = 1e-8
# kernel 1 against its plain version: the same panel-blocked elimination
# and the same pivot rows, but the rank-nb sums are rounded in another
# order (fused multiply-adds, another summation order than cuBLAS); the
# bound leaves room for that difference amplified by the stage matrices'
# conditioning
GJ_REL_TOL = 1e-4
# published peaks of one H100 SXM (NVIDIA's data sheet) for the bounds: f32
# and f64 outside the tensor cores, and the memory rate
PEAK_F32, PEAK_F64, PEAK_BYTES = 67e12, 33.5e12, 3.35e12
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


def timed(torch, fn):
    """One call of ``fn`` on the device clock: (its result, ms)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(flop: float, peak: float, nbytes: float):
    """The least time the card could take, ms, and which resource sets it."""
    t_ops, t_bytes = 1e3 * flop / peak, 1e3 * nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def gj_bound(S: int, N: int):
    """2 N^3 f32 flop a matrix; the batch read once and written once."""
    return bound(2.0 * S * N ** 3, PEAK_F32, 8.0 * S * N * N)


def pb_bound(E: int, n: int, q: int, outputs: str = "both"):
    """Per element in f64: ue, gradphi, qw, qy in, r and A out (47 values at
    n = 3, q = 4), the shape table once; per quadrature point 6n flop of
    interpolation, ~45 for sinh, cosh and the weights, 8n for the residual
    and 8n^2 for the Jacobian. A one-output variant: its own output's bytes
    and flop alone."""
    wants_r, wants_A = outputs != "jacobian", outputs != "residual"
    values = (E * (n + 2 * q * n + 2 * q + n * wants_r + n * n * wants_A)
              + q * n)
    flop = E * q * (6.0 * n + 45.0 + 8.0 * n * wants_r + 8.0 * n * n * wants_A)
    return bound(flop, PEAK_F64, 8.0 * values)


def gj_shape_check(torch, K, contraction_ok, A, label: str, reps: int,
                   plain_reps: int) -> dict:
    """Kernel 1 on the (S, N, N) f32 batch ``A``: against its plain version
    (max error, relative to the inverse's scale, within GJ_REL_TOL), the
    contraction probe, and the times of the kernel, the plain version and
    ``torch.linalg.inv`` (the library's yardstick, used nowhere in the
    port), each on this one tensor."""
    S, N, _ = A.shape
    X_k = K.gj_inverse(A)
    X_p = K.gj_inverse_plain(A)
    err = float((X_k - X_p).abs().max())
    rel = rel_err(X_k, X_p)
    ok = contraction_ok(A, X_k)
    del X_p
    lib_rel = rel_err(X_k, torch.linalg.inv(A))
    del X_k
    ms = cuda_ms(torch, lambda: K.gj_inverse(A), reps)
    lib_ms = cuda_ms(torch, lambda: torch.linalg.inv(A), reps)
    if plain_reps:
        plain_ms = cuda_ms(torch, lambda: K.gj_inverse_plain(A), plain_reps)
    else:                                   # seconds a call: time one
        plain_ms = timed(torch, lambda: K.gj_inverse_plain(A))[1]
    b_ms, b_by = gj_bound(S, N)
    print(f"[kernel gj_inverse, {label}] ({S}, {N}, {N}): max abs err vs "
          f"plain {err:.3e} (rel {rel:.3e}, tol {GJ_REL_TOL:g}), "
          f"contraction_ok {ok}; kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, torch.linalg.inv {lib_ms:.3f} ms (rel diff {lib_rel:.3e}); "
          f"bound {b_ms:.4f} ms by {b_by} ({100 * b_ms / ms:.1f} % reached)",
          flush=True)
    check(ok and rel <= GJ_REL_TOL, f"gj_inverse on the {label}")
    return {"shape": [S, N, N], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "library_rel_diff": lib_rel}


PB_VARIANTS = {"both": 3, "residual": 1, "jacobian": 2}


def pb_check(torch, K, args, E_want: int) -> dict:
    """Kernel 2's three output variants against the plain version on
    ``args`` (f64), through the prepared ``PBElement`` the main path calls:
    error, the wrapper-inclusive time (CUDA events around whole calls), the
    kernel's own device time (a profiler trace of 20 calls, by the
    instance's name) and the share of its bound that reaches; beside them
    the checked ``pb_residual_jacobian`` and the floor, an empty kernel on
    the same grid launched the same way."""
    import re

    ue, tables, params = args[0], args[1:5], args[5:]
    E, n = ue.shape
    q = tables[0].shape[0]
    check(E == E_want, f"pb_residual_jacobian: E = {E}, not {E_want}")
    plan = K.PBElement(*tables, *params)
    lib = K._library()
    index = torch.cuda.current_device()
    tpe, _, threads = K.PB_DESIGN
    blocks = -(-E // (threads // tpe))
    raw_stream = K._raw_stream_of(ue.device)
    empty = lambda: lib.pb_empty_launch(blocks, threads, index, raw_stream())
    out = {}
    for name in PB_VARIANTS:
        got = plan(ue, name)
        want = K.pb_residual_jacobian_plain(*args, outputs=name)
        check(all((g is None) == (w is None) for g, w in zip(got, want)),
              f"pb_residual_jacobian {name}: wrong outputs")
        pairs = [(g, w) for g, w in zip(got, want) if w is not None]
        b_ms, b_by = pb_bound(E, n, q, name)
        out[name] = {
            "max_abs_err": max(float((g - w).abs().max()) for g, w in pairs),
            "rel_err": max(rel_err(g, w) for g, w in pairs),
            "ms": cuda_ms(torch, lambda: plan(ue, name), 200),
            "plain_ms": cuda_ms(torch, lambda: K.pb_residual_jacobian_plain(
                *args, outputs=name), 50),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    checked_ms = cuda_ms(torch, lambda: K.pb_residual_jacobian(*args), 200)
    empty_call_ms = cuda_ms(torch, empty, 200)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for name in PB_VARIANTS:
            for _ in range(20):
                plan(ue, name)
        for _ in range(20):
            empty()
        torch.cuda.synchronize()
    device = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"pb_element_kernel<\w+, \d+, (\d+),", e.key)
        if m or "pb_empty_kernel" in e.key:
            device[int(m.group(1)) if m else 0] = (
                e.self_device_time_total / e.count / 1e3)
    check(set(device) == {0, 1, 2, 3}, "kernel 2's instances not found in "
          f"the profiler trace: {sorted(e.key[:60] for e in prof.key_averages())}")
    for name, code in PB_VARIANTS.items():
        v = out[name]
        v["device_ms"] = device[code]
        v["bound_share"] = v["bound_ms"] / v["device_ms"]
        print(f"[kernel pb_residual_jacobian] E={E} f64 {name}: max abs err "
              f"vs plain {v['max_abs_err']:.3e} (rel {v['rel_err']:.3e}, tol "
              f"{PB_REL_TOL:g}); {v['ms']:.4f} ms a call (wrapper included), "
              f"{v['device_ms']:.4f} ms on the device (profiler), plain "
              f"{v['plain_ms']:.4f} ms; bound {v['bound_ms']:.5f} ms by "
              f"{v['bound_by']} ({100 * v['bound_share']:.1f} % reached)")
        check(v["rel_err"] <= PB_REL_TOL, f"pb_residual_jacobian {name} at "
              f"E = {E}")
    print(f"[kernel pb_residual_jacobian] E={E}: the checked function "
          f"{checked_ms:.4f} ms a call; floor: an empty kernel of {blocks} "
          f"blocks x {threads} threads {device[0]:.4f} ms on the device, "
          f"{empty_call_ms:.4f} ms a call through ctypes; no single PyTorch "
          "call computes it", flush=True)
    return {"E": E, **out["both"], "checked_ms": checked_ms,
            "empty_device_ms": device[0], "empty_call_ms": empty_call_ms,
            "variants": {k: out[k] for k in ("residual", "jacobian")}}


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

    # both kernel variants (0: one block a matrix, 1: the panel path) below
    # one panel, off the panel grid, and with the first pivots in the last
    # rows (rows reversed: column 0's pivot is row N - 1, far outside the
    # first panel's diagonal block); pivot rows equal the plain version's
    for name, S, N, variant, panel, flip in (
            ("N < panel", 2, 20, 0, 32, False),
            ("N < panel", 2, 20, 1, 64, False),
            ("N mod panel", 2, 77, 0, 32, False),
            ("N mod panel", 2, 333, 1, 64, False),
            ("N mod panel", 1, 515, 1, 48, False),
            ("cross-block pivots", 2, 300, 0, 32, True),
            ("cross-block pivots", 1, 700, 1, 64, True)):
        rng = np.random.RandomState(N)
        A = (rng.rand(S, N, N).astype(np.float32) * 0.1
             + np.eye(N, dtype=np.float32)[None] * N * 0.05)
        A = torch.tensor(A[:, ::-1].copy() if flip else A, device=dev)
        X, perm = K._gj_core_cuda(A, panel, variant)
        Xp, perm_p = K._gj_core_plain(A, panel)
        err = rel_err(X, Xp)
        lib = rel_err(X, torch.linalg.inv(A))
        same = bool((perm.long() == perm_p).all())
        far = int(perm[0, 0])
        ok = contraction_ok(A, X)
        print(f"  gj_inverse {name} ({S}, {N}) variant {variant} panel "
              f"{panel}: rel err vs plain {err:.3e}, vs torch.linalg.inv "
              f"{lib:.3e}, pivot rows equal {same} (column 0's: {far}), "
              f"contraction_ok {ok}")
        check(ok and same and err <= GJ_REL_TOL and lib <= GJ_REL_TOL
              and (not flip or far >= panel), f"gj_inverse {name} ({S}, {N})")


def ras_parity(torch, W, pore_case, dev) -> None:
    """Phase 7: the block-RAS tier on the card against the CPU, in both
    Poisson tiers."""
    sys_s, space_s = pore_case(30, 17)
    for tier, pit in (("mid-size inverse", 49152), ("two-level RAS", 0)):
        run = lambda d: W.run_instationary_pnp_from_pb(
            sys_s, space_s, n_steps=PARITY_STEPS, presolve_potential=True,
            dense_poisson_threshold=0, ras_block_size=64,
            ras_refresh_every=RAS_REFRESH, poisson_inv_threshold=pit,
            device=d)
        g, c = run(dev), run("cpu")
        errs = {n: rel_err(getattr(g, n).cpu(), getattr(c, n))
                for n in ("phi", "cp", "cm")}
        cur = max(rel_err(torch.tensor(a), torch.tensor(b))
                  for (_, *x), (_, *y) in zip(g.current_history,
                                              c.current_history)
                  for a, b in zip(x, y))
        counts = {d: (r.species_iterations, r.poisson_iterations)
                  for d, r in (("cuda", g), ("cpu", c))}
        print(f"[block-RAS parity] pore_case(30, 17), {tier}, "
              f"{PARITY_STEPS} presolved steps, CUDA vs CPU: rel err phi "
              f"{errs['phi']:.3e} cp {errs['cp']:.3e} cm {errs['cm']:.3e} "
              f"currents {cur:.3e} (tol {SLICE_REL_TOL:g}); species its / "
              f"Poisson its per step: cuda {counts['cuda']} cpu "
              f"{counts['cpu']}", flush=True)
        check(g.system.poisson_tier == c.system.poisson_tier
              == ("inverse" if pit else "ras"), f"{tier}: Poisson tier")
        # a count may differ by one where a residual lands on its target:
        # the assembly sums with atomics on the card, so the f32 factors'
        # inputs differ in their last bits (measured: the mid-size tier's
        # 1e-10 Poisson refinement took 2 passes on the card, 3 on the CPU,
        # at one step of five)
        diffs = [abs(a - b) for xs, ys in zip(counts["cuda"], counts["cpu"])
                 for a, b in zip(xs, ys)]
        if any(diffs):
            print(f"[block-RAS parity] {tier}: iteration counts differ "
                  f"between CUDA and CPU at {sum(map(bool, diffs))} of "
                  f"{len(diffs)} solves")
        check(max(diffs) <= 1, f"{tier}: iteration counts differ by more "
              "than one between CUDA and CPU")
        check(max(*errs.values(), cur) <= SLICE_REL_TOL,
              f"block-RAS parity, {tier}")


def ras_main(torch, K, W, direct, pore_case, dev):
    """Phase 8: the block-RAS main path at full size, with every kernel
    launch counted. Returns the run's result and the launch counts."""
    nodes, tris, n_blocks, L = RAS_SHAPE
    sys_r, space_r = pore_case(*RAS_CASE)
    out_dir = os.path.join(REPO, "chip_smoke_out", "block_ras")
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    direct.probe_failures["count"] = 0
    res = W.run_instationary_pnp_from_pb(
        sys_r, space_r, n_steps=RAS_STEPS, presolve_potential=True,
        output_dir=out_dir, ras_refresh_every=RAS_REFRESH, device=dev,
        **RAS_KW)
    counts = dict(K.launches)
    failures = direct.probe_failures["count"]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    system = res.system
    ctx = system.block_context
    finite = all(tuple(v.shape) == (nodes,) and bool(torch.isfinite(v).all())
                 for v in (res.phi, res.cp, res.cm))
    with open(os.path.join(out_dir, "current.dat")) as f:
        rows = [line.split() for line in f if line.strip()]
    print(f"[block-RAS main] pore_case{RAS_CASE}: {nodes} dofs, {tris} "
          f"triangles; factor kind {system.factor_kind}, Poisson tier "
          f"{system.poisson_tier}, K {ctx.K} B {ctx.B} L {ctx.L}")
    print(f"[block-RAS main] PB Newton iterations "
          f"{res.pb_newton_iterations}, phase A {1e3 * res.pb_seconds:.1f} "
          f"ms, setup (A-C) {1e3 * res.setup_seconds:.1f} ms, Poisson "
          f"setup (f32 assembly, Gauss-Jordan inverse, probe) "
          f"{1e3 * res.poisson_setup_seconds:.1f} ms")
    for i, (ms, ks, kp, fresh) in enumerate(zip(
            res.step_ms, res.species_iterations, res.poisson_iterations,
            res.factor_rebuilt)):
        print(f"[block-RAS main] step {i} {'factor' if fresh else 'reuse'}"
              f" {ms:.2f} ms, species its {ks}, Poisson refinements {kp}")
    print(f"[block-RAS main] launches {counts}, probe failures {failures}, "
          f"peak memory {peak:.2f} GiB", flush=True)
    check((system.factor_kind, system.poisson_tier) == ("ras", "inverse")
          and (ctx.K, ctx.L) == (n_blocks, L), "block-RAS tier not taken")
    check(finite, "non-finite or misshapen final state")
    check(all(math.isfinite(v) for _, a, b in res.current_history
              for v in (*a, *b)), "non-finite currents")
    check(len(res.current_history) == RAS_STEPS and len(rows) == RAS_STEPS
          and all(len(r) == 1 + 2 * sys_r.n_surfaces for r in rows),
          "current.dat rows")
    check(res.factor_rebuilt == [i % RAS_REFRESH == 0
                                 for i in range(RAS_STEPS)],
          f"factor refresh schedule {res.factor_rebuilt}")
    check(failures == 0, f"{failures} contraction-probe failures")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the block-RAS path")
    return res, counts


def krylov_main(torch, K, W, direct, tableau, pore_case, dev) -> dict:
    """Phase 8b: the species Krylov path at full size (every stage its own
    local inverses), with every kernel launch counted, then its parity on
    the small case, CUDA against CPU. Returns the launch counts."""
    nodes, tris, n_blocks, L = RAS_SHAPE
    sys_r, space_r = pore_case(*RAS_CASE)
    stages = tableau.stages
    K.reset_launch_counts()
    direct.probe_failures["count"] = 0
    res = W.run_instationary_pnp_from_pb(
        sys_r, space_r, n_steps=KRYLOV_STEPS, tableau=tableau,
        presolve_potential=True, device=dev, **RAS_KW)
    counts = dict(K.launches)
    failures = direct.probe_failures["count"]
    system = res.system
    ctx = system.block_context
    print(f"[species-Krylov main] pore_case{RAS_CASE}, {tableau.name} "
          f"({stages} stages, diagonals differ): {nodes} dofs; factor kind "
          f"{system.factor_kind}, Poisson tier {system.poisson_tier}, K "
          f"{ctx.K} L {ctx.L}: each stage inverts a ({2 * ctx.K}, {ctx.L}, "
          f"{ctx.L}) batch")
    print("[species-Krylov main] step ms "
          + " ".join(f"{t:.2f}" for t in res.step_ms)
          + f"; species its per step {res.species_iterations}; Poisson "
          f"refinements {res.poisson_iterations}; setup (A-C) "
          f"{1e3 * res.setup_seconds:.1f} ms")
    print(f"[species-Krylov main] launches {counts}, probe failures "
          f"{failures}", flush=True)
    check((system.factor_kind, system.poisson_tier) == (None, "inverse")
          and system.species_factor is None
          and (ctx.K, ctx.L) == (n_blocks, L), "species Krylov path not taken")
    check(all(tuple(v.shape) == (nodes,) and bool(torch.isfinite(v).all())
              for v in (res.phi, res.cp, res.cm)),
          "non-finite or misshapen final state")
    check(len(res.current_history) == KRYLOV_STEPS
          and all(math.isfinite(v) for _, a, b in res.current_history
                  for v in (*a, *b)), "currents")
    check(res.factor_rebuilt == [True] * KRYLOV_STEPS, "factor reuse on a "
          "path that has no factor")
    check(failures == 0, f"{failures} contraction-probe failures")
    # kernel 1: phase A's Jacobian factors (at most one a Newton iteration),
    # the Poisson inverse, and one launch a stage
    setup = counts["gj_inverse"] - stages * KRYLOV_STEPS
    check(1 <= setup <= 1 + res.pb_newton_iterations,
          f"gj_inverse launched {counts['gj_inverse']} times: not "
          f"{stages} a step beside the setup's")
    check(counts["pb_residual_jacobian"] > 0, "kernel 2 was not launched")
    K.reset_launch_counts()
    system.species_step(res.phi, res.cp, res.cm)
    torch.cuda.synchronize(dev)
    check(K.launches == {"gj_inverse": stages, "pb_residual_jacobian": 0},
          f"one species step launched {K.launches}, not kernel 1 once a "
          "stage")

    sys_s, space_s = pore_case(30, 17)
    run = lambda d: W.run_instationary_pnp_from_pb(
        sys_s, space_s, n_steps=KRYLOV_STEPS, tableau=tableau,
        presolve_potential=True, dense_poisson_threshold=0,
        ras_block_size=64, device=d)
    g, c = run(dev), run("cpu")
    errs = {n: rel_err(getattr(g, n).cpu(), getattr(c, n))
            for n in ("phi", "cp", "cm")}
    cur = max(rel_err(torch.tensor(a), torch.tensor(b))
              for (_, *x), (_, *y) in zip(g.current_history,
                                          c.current_history)
              for a, b in zip(x, y))
    its = {d: (r.species_iterations, r.poisson_iterations)
           for d, r in (("cuda", g), ("cpu", c))}
    print(f"[species-Krylov parity] pore_case(30, 17), {KRYLOV_STEPS} "
          f"presolved steps, CUDA vs CPU: rel err phi {errs['phi']:.3e} cp "
          f"{errs['cp']:.3e} cm {errs['cm']:.3e} currents {cur:.3e} (tol "
          f"{SLICE_REL_TOL:g}); species its / Poisson refinements per step: "
          f"cuda {its['cuda']} cpu {its['cpu']}", flush=True)
    check(g.system.factor_kind is None and c.system.factor_kind is None,
          "species Krylov parity: a factored path was taken")
    # counts within one: atomic assembly on the card (see ras_parity)
    check(max(abs(a - b) for xs, ys in zip(its["cuda"], its["cpu"])
              for a, b in zip(xs, ys)) <= 1, "species Krylov parity: "
          "iteration counts differ by more than one")
    check(max(*errs.values(), cur) <= SLICE_REL_TOL, "species Krylov parity")
    return counts


def ras_kernel_checks(torch, K, direct, FA, V, make_scalar_context, system,
                      dev) -> dict:
    """Phase 9: both kernels at the shapes the block-RAS main path gave
    them, on inputs built from its system: kernel 1 on the (96, 369, 369)
    species RAS local batch at the presolved potential and on the
    (1, 12097, 12097) constant Poisson matrix of the mid-size tier, kernel
    2 at E = 23,552. Each version runs on the same input tensor: the
    assembly sums with atomics, so a rebuilt input could differ in its
    last bits."""
    nodes, tris, n_blocks, L = RAS_SHAPE
    sys_r, space_r = system.sys, system.space
    uphi1, _ = system.poisson_solve(system.uphi0, system.ucp0, system.ucm0)
    A = system.species_local_f32(uphi1)
    check(tuple(A.shape) == (2, n_blocks, L, L), f"RAS batch {A.shape}")
    A = A.reshape(2 * n_blocks, L, L)
    gj = gj_shape_check(torch, K, direct.contraction_ok, A,
                        "species RAS local batch", 5, 3)
    del A

    # the mid-size tier's constant Poisson matrix, assembled as the driver
    # assembles it; one timed call of each version (seconds each)
    ctx = make_scalar_context(sys_r, space_r, component=0, quad_order=3,
                              device=dev)
    vt = ctx.vt
    A_el = V.poisson_jacobian_el(vt, sys_r.cylindrical, sys_r.pi)
    P32 = FA.dense_constrained_matrix(A_el.to(torch.float32), vt.dofmap,
                                      nodes, ctx.free)[None]
    check(tuple(P32.shape) == (1, nodes, nodes), f"Poisson {P32.shape}")
    gj_poisson = gj_shape_check(torch, K, direct.contraction_ok, P32,
                                "constant Poisson matrix", 3, 0)
    del P32

    args = (system.pb[vt.dofmap], vt.shape, vt.gradphi, vt.qw, vt.qy,
            sys_r.l_b, sys_r.c0, sys_r.cylindrical, sys_r.pi)
    pb = pb_check(torch, K, args, tris)
    return {"gj": gj, "gj_poisson": gj_poisson, "pb": pb}


def trace_summary(torch, prof, wall_s: float, label: str,
                  tag: str = "block-RAS trace") -> None:
    """Device kernel time, kernel count and the costliest kernels of one
    traced step."""
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    n = sum(e.count for e in kern)
    print(f"[{tag}] {label} step: wall {1e3 * wall_s:.2f} ms "
          f"(profiled), device kernel time {dev_ms:.2f} ms "
          f"({100 * dev_ms / (1e3 * wall_s):.1f} % busy), {n} kernels")
    for e in sorted(kern, key=lambda e: e.self_device_time_total,
                    reverse=True)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:72]}")
    sys.stdout.flush()


def ras_breakdown(torch, W, PhaseTimer, maybe_trace, res, dev) -> None:
    """Phase 10: the per-phase breakdown of the block-RAS step on the main
    run's final state, a profiler trace of one factor step and one reuse
    step, and the two-level RAS Poisson tier against the mid-size tier on
    the same state."""
    system = res.system
    # bench.run_scaled's form; every piece already ran in the main run,
    # so nothing is cold
    timer = PhaseTimer()
    uphi, ucp, ucm = res.phi, res.cp, res.cm
    with timer.phase("species_factor", sync=dev):
        factor = system.species_factor(uphi)
    with timer.phase("species_step_reuse", sync=dev):
        ucp2, ucm2, sp_its = system.species_step_reuse(factor, uphi, ucp,
                                                       ucm)
    with timer.phase("poisson_solve", sync=dev):
        uphi2, po_its = system.poisson_solve(uphi, ucp2, ucm2)
    fa, sp, po = (timer.ms(n) for n in ("species_factor",
                                        "species_step_reuse",
                                        "poisson_solve"))
    print(f"[block-RAS breakdown] species_factor {fa:.2f} ms, "
          f"species_step_reuse {sp:.2f} ms ({sp_its} its), poisson_solve "
          f"{po:.2f} ms ({po_its} refinements), amortized step (species + "
          f"Poisson + factor / {RAS_REFRESH}) {sp + po + fa / RAS_REFRESH:.2f}"
          " ms", flush=True)

    trace_root = os.path.join(REPO, "chip_smoke_out", "block_ras")
    for label, fresh in (("factor", True), ("reuse", False)):
        with maybe_trace(os.path.join(trace_root, f"trace_{label}")) as prof:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            f = system.species_factor(uphi) if fresh else factor
            c2 = system.species_step_reuse(f, uphi, ucp, ucm)
            system.poisson_solve(uphi, c2[0], c2[1])
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        trace_summary(torch, prof, wall, label)

    # the two-level RAS Poisson tier, PB field carried over (no phase A)
    two = W.build_pnp_system(system.sys, system.space, pb_field=system.pb,
                             poisson_inv_threshold=0, device=dev, **RAS_KW)
    check(two.poisson_tier == "ras" and two.pb_newton_iterations == 0,
          "two-level RAS Poisson system")
    two.poisson_solve(uphi, ucp2, ucm2)
    with timer.phase("poisson_solve_two_level", sync=dev):
        uphi_2l, its_2l = two.poisson_solve(uphi, ucp2, ucm2)
    tier_err = rel_err(uphi_2l, uphi2)
    print(f"[block-RAS breakdown] two-level RAS poisson_solve "
          f"{timer.ms('poisson_solve_two_level'):.2f} ms ({its_2l} "
          f"BiCGSTAB its); against the mid-size tier rel err {tier_err:.3e} "
          f"(tol {TIER_REL_TOL:g})", flush=True)
    check(tier_err <= TIER_REL_TOL, "Poisson tiers disagree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from pnp_tpu_torch.fem import assembly as FA
        from pnp_tpu_torch.operators import kernels as K
        from pnp_tpu_torch.operators import volume as V
        from pnp_tpu_torch.problems import pore_case, substeps_tableau
        from pnp_tpu_torch.solvers import direct
        from pnp_tpu_torch.utils.profiling import PhaseTimer, maybe_trace
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
    gj = gj_shape_check(torch, K, direct.contraction_ok, A32,
                        "species stage batch", 3, 2)
    gj_checks(torch, K, direct.contraction_ok, dev)
    del A32
    sys.stdout.flush()

    ctx = make_scalar_context(sys_big, space_big, component=0, quad_order=3,
                              device=dev)
    vt = ctx.vt
    args = (system0.pb[vt.dofmap], vt.shape, vt.gradphi, vt.qw, vt.qy,
            sys_big.l_b, sys_big.c0, sys_big.cylindrical, sys_big.pi)
    pb = pb_check(torch, K, args, 9200)
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
    print(f"[main] species refinements per step {res.species_iterations}")
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
    with maybe_trace(os.path.join(out_dir, "trace_dense")) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        c2 = res.system.species_step(res.phi, res.cp, res.cm)
        res.system.poisson_solve(res.phi, c2[0], c2[1])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    trace_summary(torch, prof, wall, "dense", tag="dense trace")
    del res, c2
    print(f"[dense tier done] {time.perf_counter() - t_all:.1f} s",
          flush=True)

    # ---- 7-10. the block-RAS tier -------------------------------------------
    ras_parity(torch, W, pore_case, dev)
    ras_res, ras_counts = ras_main(torch, K, W, direct, pore_case, dev)
    kry_counts = krylov_main(torch, K, W, direct, substeps_tableau(),
                             pore_case, dev)
    ras_k = ras_kernel_checks(torch, K, direct, FA, V, make_scalar_context,
                              ras_res.system, dev)
    ras_breakdown(torch, W, PhaseTimer, maybe_trace, ras_res, dev)
    print(f"[done] {time.perf_counter() - t_all:.1f} s")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        {"name": "gj_inverse", "route": "cuda",
         "source": "pnp_tpu_torch/csrc/gj_inverse.cu",
         "replaces": "pnp_tpu/operators/pallas_kernels.py:343",
         "launches": counts["gj_inverse"], **{k: gj[k] for k in keys},
         "shape": gj["shape"], "library_rel_diff": gj["library_rel_diff"],
         "launches_block_ras": ras_counts["gj_inverse"],
         "launches_species_krylov": kry_counts["gj_inverse"],
         "block_ras_shape": ras_k["gj"],
         "poisson_shape": ras_k["gj_poisson"]},
        {"name": "pb_residual_jacobian", "route": "cuda",
         "source": "pnp_tpu_torch/csrc/pb_element.cu",
         "replaces": "pnp_tpu/operators/pallas_kernels.py:105",
         "launches": counts["pb_residual_jacobian"],
         **{k: v for k, v in pb.items() if k != "E"},
         "launches_block_ras": ras_counts["pb_residual_jacobian"],
         "launches_species_krylov": kry_counts["pb_residual_jacobian"],
         "block_ras_shape": ras_k["pb"]},
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
