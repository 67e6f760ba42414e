#!/usr/bin/env python3
"""Check and time kernel 3 (``csrc/element_spmv.cu``) on one NVIDIA GPU
against the chain it replaces, at the benchmark's two mesh sizes:

    python3 -m pnp_tpu_torch.tools.spmv_sweep

The structured pore (80, 44) at P1, refined 0 and 3 times (E = 5,888 and
376,832 elements), with the Poisson blocks (S = 1, the Poisson operator)
and a pair of per-system blocks (S = 2, the species stage operator), each
under Dirichlet masks, f64. Per case: the kernel against the plain
version (``fem.assembly.spmv_plain``: where, gather, einsum, scatter-add,
where) on the same tensors, to 1e-13 of the output's scale; the kernel's
device time back to back and with L2 flushed before each launch by a read
of 256 MB (a Krylov iteration streams the preconditioner's inverses
between two applies), the plain chain's back to back, all from CUDA
events; and the kernel's bytes bound: every
byte it needs read once (blocks, int32 dof map, incidence table, x, mask)
and y written once, over 3.35 TB/s. The last line is a JSON object.
Exits non-zero on a failed check or without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from pnp_tpu_torch.fem import assembly as FA
from pnp_tpu_torch.fem.geometry import build_volume_tables
from pnp_tpu_torch.fem.space import FunctionSpace
from pnp_tpu_torch.meshio.refine import refine_uniform
from pnp_tpu_torch.meshio.structured import pore_without_dna_mesh
from pnp_tpu_torch.operators import kernels as K
from pnp_tpu_torch.operators import volume as V

HBM_BYTES_PER_S = 3.35e12
REL_TOL = 1e-13
FLUSH_FLOATS = 64 * 2 ** 20          # 256 MB read: five times the 50 MB L2


def case_tensors(levels: int, dev):
    """The benchmark's pore (80, 44) refined ``levels`` times, P1, on
    ``dev``: its dof map and dof count, its Poisson blocks (one system), a
    pair of per-system blocks (the Poisson and the mass blocks), the masks
    of the walls and a seeded tenth of the rest (differing between the two
    systems) and seeded x (2, ndof). The card tests use it too."""
    mesh = pore_without_dna_mesh(80, 44)
    if levels:
        mesh = refine_uniform(mesh, levels)
    space = FunctionSpace(mesh, 1)
    vt = build_volume_tables(space, 2, dev)
    A = V.poisson_jacobian_el(vt, True, np.pi)
    pair = torch.stack([A, V.mass_jacobian_el(vt, 1.0, True, np.pi)])
    rng = np.random.RandomState(levels)
    y = np.asarray(space.dof_coords)[:, 1]
    wall = (y <= y.min() + 1e-12) | (y >= y.max() - 1e-12)
    free = torch.as_tensor(~(wall | (rng.rand(2, space.ndof) < 0.1)),
                           device=dev)
    x = torch.tensor(rng.standard_normal((2, space.ndof)), device=dev)
    return vt.dofmap, space.ndof, A, pair, free, x


def bound_bytes(S: int, E: int, n: int, ndof: int, item: int,
                S_A: int | None = None, masked: bool = True) -> int:
    """Kernel 3's bytes an apply of S systems: S_A systems' blocks (S
    unless given; 1 where one set serves every system), the int32 dof map
    and incidence table, x and the mask (if ``masked``) read once, y
    written once."""
    S_A = S if S_A is None else S_A
    return (S_A * E * n * n * item + 4 * (2 * E * n + ndof + 1)
            + S * ndof * (2 * item + masked))


def device_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of ``fn`` over ``reps`` calls. Without ``flush``:
    back to back, queued behind a sleep kernel so that the host's call
    time does not show, one pair of CUDA events around all. With
    ``flush``: run before each call, CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    if flush is None:
        torch.cuda._sleep(100_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps
    pairs = []
    for _ in range(reps):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def run_case(levels: int, S: int, tensors, flush) -> dict:
    dofmap, ndof, A, pair, free, x = tensors
    blocks = A if S == 1 else pair
    mask, xs = (free[0], x[0]) if S == 1 else (free, x)
    E, n = dofmap.shape
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    K.incidence_table(dofmap, ndof)
    t1.record()
    torch.cuda.synchronize()
    table_ms = t0.elapsed_time(t1)
    op = FA.make_constrained_operator(blocks, dofmap, ndof, mask)
    n0 = K.launches["element_spmv"]
    got = op(xs)
    launches = K.launches["element_spmv"] - n0
    want = FA.spmv_plain(blocks, xs, dofmap, ndof, mask)
    err = float((got - want).abs().max() / want.abs().max())
    repeat = bool(torch.equal(got, op(xs)))
    reps = 200 if E < 100_000 else 100
    kernel = device_ms(lambda: op(xs), reps)
    kernel_cold = device_ms(lambda: op(xs), reps, flush)
    plain = device_ms(lambda: FA.spmv_plain(blocks, xs, dofmap, ndof, mask),
                      reps)
    nbytes = bound_bytes(S, E, n, ndof, blocks.element_size())
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    out = dict(levels=levels, E=E, ndof=ndof, S=S, launches=launches,
               rel_err=err, bitwise_repeat=repeat, table_ms=table_ms,
               kernel_ms=kernel, kernel_cold_ms=kernel_cold, plain_ms=plain,
               bound_ms=bound, bound_bytes=nbytes,
               reached_pct=100.0 * bound / kernel,
               reached_cold_pct=100.0 * bound / kernel_cold,
               ok=err <= REL_TOL and repeat and launches == 1)
    print(f"E = {E:7d} S = {S}: kernel {kernel * 1e3:8.2f} us "
          f"(L2 flushed {kernel_cold * 1e3:8.2f}), plain chain "
          f"{plain * 1e3:8.2f} us, bound {bound * 1e3:6.2f} us (bytes "
          f"{nbytes / 1e6:.2f} MB): {out['reached_pct']:.1f} % "
          f"({out['reached_cold_pct']:.1f} % flushed); rel err {err:.1e}, "
          f"bitwise repeat {repeat}, launches {launches}, table "
          f"{table_ms:.3f} ms", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("spmv_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    info = K.build()
    print(f"build {info['seconds']:.2f} s")
    ours = False                 # ptxas' report of kernel 3's instances
    for line in info["log"].splitlines():
        if "Compiling entry function" in line:
            ours = "element_spmv" in line
        if ours and any(w in line for w in ("Compiling", "registers",
                                            "spill")):
            print("  " + line.strip())
    # a read, not a write, so that no dirty line is written back inside
    # the next call's window
    buf = torch.ones(FLUSH_FLOATS, dtype=torch.float32, device=dev)
    results = []
    for levels in (0, 3):
        tensors = case_tensors(levels, dev)
        for S in (1, 2):
            results.append(run_case(levels, S, tensors, buf.sum))
    good = all(r["ok"] for r in results)
    print("all checks passed" if good else "CHECKS FAILED")
    print(json.dumps({"ok": good, "card": card, "cases": results}))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
