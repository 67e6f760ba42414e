#!/usr/bin/env python3
"""Check and time kernel 2 (``csrc/pb_element.cu``) on one NVIDIA GPU over
shapes and designs:

    python3 -m pnp_tpu_torch.tools.pb_sweep [--quick] [--parent DIR]

It builds the kernels with every design compiled in (``-DPB_ALL_DESIGNS``)
and prints the compiler's register and spill report of every instance.
Then, on the PB tables of ``pore_case(100, 55)`` (E = 9,200) and
``pore_case(160, 88)`` (E = 23,552) with a seeded field, f64, for each
output variant (both, residual, Jacobian) and each design (threads an
element 1 or 4, staging through shared memory off or on, 64, 128 or 256
threads a block): the kernel against its plain PyTorch version (1e-12 of
the output's scale) and its time on the device (``torch.profiler``, by
kernel name). Beside them: the settled design's calls with the wrapper
included (CUDA events around back-to-back calls of the prepared
``PBElement`` and of the checked ``pb_residual_jacobian``, and the host's
own time a call), the bound from the bytes, and the floor: an empty kernel
on the same grid, launched the same way. ``--quick`` checks every design
at a small E (P1-P3, f64 and f32) and times nothing. ``--parent DIR``
times the checked function of another checkout of this repository (the
commit before a redesign) in the same run, in turns: parent, this
tree, this tree, parent. Exits non-zero on any failed check.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import torch

from pnp_tpu_torch.operators import kernels as K
from pnp_tpu_torch.problems import pore_case
from pnp_tpu_torch.workloads.common import make_scalar_context

REL_TOL = 1e-12
PEAK_BYTES = 3.35e12
CASES = ((100, 55), (160, 88))
DESIGNS = [(tpe, staged, threads) for tpe in (1, 4) for staged in (0, 1)
           for threads in (64, 128, 256)]
SETTLED = K.PB_DESIGN
KERNEL_NAME = re.compile(r"pb_element_kernel<(\w+), (\d+), (\d+), (\d+), "
                         r"(?:\(bool\))?(\w+)>")
MANGLED = re.compile(r"pb_element_kernelI([df])Li(\d+)ELi(\d+)ELi(\d+)"
                     r"ELb([01])EE")

# the checked function of a checkout, timed as this script times its own:
# one JSON line per case (run with that checkout as the working directory)
PARENT_SNIPPET = r"""
import json, sys, time, torch
from pnp_tpu_torch.operators import kernels as K
from pnp_tpu_torch.problems import pore_case
from pnp_tpu_torch.workloads.common import make_scalar_context
dev = torch.device("cuda")
K.build()
for case in json.loads(sys.argv[1]):
    sys_c, space = pore_case(*case)
    ctx = make_scalar_context(sys_c, space, component=0, quad_order=3,
                              device=dev)
    vt = ctx.vt
    g = torch.Generator().manual_seed(0)
    u = (torch.rand(space.ndof, generator=g, dtype=torch.float64) * 4
         - 2).to(dev)
    args = (u[vt.dofmap], vt.shape, vt.gradphi, vt.qw, vt.qy, sys_c.l_b,
            sys_c.c0, sys_c.cylindrical, sys_c.pi)
    call = lambda: K.pb_residual_jacobian(*args)
    for _ in range(10):
        call()
    ms, us = [], []
    for _ in range(7):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(100):
            call()
        us.append(1e6 * (time.perf_counter() - t0) / 100)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b) / 100)
    ms.sort()
    us.sort()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(50):
            call()
        torch.cuda.synchronize()
    own = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "pb_element_kernel" in e.key]
    n = sum(e.count for e in own)
    print(json.dumps({"E": args[0].shape[0], "call_ms": ms[3],
                      "call_ms_least": ms[0], "host_us": us[3],
                      "host_us_least": us[0], "device_ms":
                      sum(e.self_device_time_total for e in own) / n / 1e3}),
          flush=True)
"""


def event_ms(fn, reps: int = 100, batches: int = 7):
    """ms a call over ``reps`` back-to-back calls (CUDA events) and the
    host's own microseconds a call: the median of ``batches`` batches and,
    in brackets when printed, the least (the host's speed varies from batch
    to batch on a shared machine; the least is what the code costs)."""
    for _ in range(10):
        fn()
    ms, us = [], []
    for _ in range(batches):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us.append(1e6 * (time.perf_counter() - t0) / reps)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b) / reps)
    ms.sort()
    us.sort()
    return {"call_ms": ms[batches // 2], "call_ms_least": ms[0],
            "host_us": us[batches // 2], "host_us_least": us[0]}


def show(t: dict) -> str:
    return (f"{t['call_ms']:.5f} ms a call (least {t['call_ms_least']:.5f}), "
            f"host {t['host_us']:.2f} us (least {t['host_us_least']:.2f})")


def call_parts(plan, ue) -> None:
    """What a prepared call is made of, on the host's clock: each part
    alone, the least of 7 batches of 200."""
    def least(fn):
        best = float("inf")
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            best = min(best, 1e6 * (time.perf_counter() - t0) / 200)
        return best

    E, n = ue.shape
    plan(ue, "both")
    r, A = (torch.empty((E, n), dtype=ue.dtype, device=ue.device),
            torch.empty((E, n, n), dtype=ue.dtype, device=ue.device))
    design = SETTLED
    parts = {
        "checks on ue": lambda: (K._check_pb_ue(
            ue, plan.E, plan.n, plan.dtype, plan.device), K._aligned(ue)),
        "two torch.empty": lambda: (
            torch.empty((E, n), dtype=ue.dtype, device=ue.device),
            torch.empty((E, n, n), dtype=ue.dtype, device=ue.device)),
        "two new_empty": lambda: (ue.new_empty((E, n)),
                                  ue.new_empty((E, n, n))),
        "stream lookup": K._device_stream(ue.device)[1],
        "the C call (launch included)": lambda: plan._call(
            ue.data_ptr(), r.data_ptr(), A.data_ptr(), 3, design),
    }
    torch.cuda.synchronize()
    print(f"E={E}: a prepared call's parts, host us: " + ", ".join(
        f"{name} {least(fn):.2f}" for name, fn in parts.items()), flush=True)
    torch.cuda.synchronize()


def device_ms(fns, reps: int = 20) -> dict:
    """Mean device ms of this package's kernels while ``fns`` run ``reps``
    times each, by kernel name (``torch.profiler``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # a trace taken right after another process traced the card came back
    # without device events once: try again before giving up
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for fn in fns:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        found = {e.key: e.self_device_time_total / e.count / 1e3
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and ("pb_element_kernel" in e.key
                      or "pb_empty_kernel" in e.key)}
        if found:
            return found
    raise RuntimeError("the profiler's trace holds no kernel of this package")


def design_of(key: str):
    """(outputs, threads an element, staged) from a kernel's name."""
    m = KERNEL_NAME.search(key)
    return (int(m.group(3)), int(m.group(4)),
            int(m.group(5) in ("true", "1"))) if m else None


def pb_bytes(E: int, n: int, q: int, out: int, size: int = 8) -> float:
    """Bytes once in and once out for one call of an output variant."""
    values = E * (n + 2 * q * n + 2 * q) + q * n
    values += E * n * (out & 1) + E * n * n * (out >> 1 & 1)
    return float(size * values)


def fits(n: int, q: int, size: int, design) -> bool:
    """Whether a staged design's block fits a block's 227 KB of shared
    memory (``staged_values`` in the source; r and A reuse the inputs'
    bytes and are smaller). The C side refuses one that does not."""
    tpe, staged, threads = design
    odd = lambda v: v | 1
    per_element = odd(2 * n * q) + 2 * odd(q) + odd(n)
    return not staged or size * per_element * (threads // tpe) <= 227 * 1024


def register_report(log: str) -> bool:
    """ptxas' registers, stack and spills of every kernel-2 instance; False
    if one spills."""
    clean, name, stack = True, None, ""
    for line in log.splitlines():
        m = MANGLED.search(line)
        if m and "Compiling entry function" in line:
            name = (f"{'f64' if m.group(1) == 'd' else 'f32'} n={m.group(2)} "
                    f"out={m.group(3)} tpe={m.group(4)} staged={m.group(5)}")
        elif name and "bytes stack frame" in line:
            stack = line.strip()
        elif name and "Used" in line and "registers" in line:
            spills = "0 bytes spill stores, 0 bytes spill loads" not in stack
            clean = clean and not spills
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"  ptxas {name}: {regs} registers; {stack}"
                  f"{'  <-- SPILLS' if spills else ''}")
            name = None
    return clean


def tables(case, dev):
    sys_c, space = pore_case(*case)
    ctx = make_scalar_context(sys_c, space, component=0, quad_order=3,
                              device=dev)
    vt = ctx.vt
    g = torch.Generator().manual_seed(0)
    u = (torch.rand(space.ndof, generator=g, dtype=torch.float64) * 4
         - 2).to(dev)
    params = (sys_c.l_b, sys_c.c0, sys_c.cylindrical, sys_c.pi)
    return u[vt.dofmap], (vt.shape, vt.gradphi, vt.qw, vt.qy), params


def agrees(plan, ue, tabs, params, outputs, design, tol) -> bool:
    r, A = plan._launch(ue, K.PB_OUTPUTS[outputs], design)
    torch.cuda.synchronize()
    r_p, A_p = K.pb_residual_jacobian_plain(ue, *tabs, *params,
                                            outputs=outputs)
    ok = True
    for got, want in ((r, r_p), (A, A_p)):
        if want is None:
            ok = ok and got is None
        else:
            rel = float((got - want).abs().max() / want.abs().max())
            ok = ok and rel <= tol
    if not ok:
        print(f"MISMATCH outputs {outputs} design {design}", flush=True)
    return ok


def quick(dev) -> bool:
    """Every design against the plain version at a small, ragged E."""
    good = True
    for n, q in ((3, 4), (6, 6), (10, 12)):
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
            g = torch.Generator().manual_seed(n)
            E = 1000 + n
            rnd = lambda *s: torch.rand(*s, generator=g, dtype=torch.float64)
            tabs = tuple(t.to(dtype).to(dev) for t in (
                rnd(q, n), rnd(E, q, n, 2) * 6 - 3, rnd(E, q) * 0.04 + 0.01,
                rnd(E, q) + 0.1))
            ue = (rnd(E, n) * 4 - 2).to(dtype).to(dev)
            params = (0.7, 0.06, True, 3.141592653589793)
            plan = K.PBElement(*tabs, *params)
            size = 8 if dtype == torch.float64 else 4
            for outputs in K.PB_OUTPUTS:
                for design in DESIGNS:
                    if not fits(n, q, size, design):
                        continue
                    good = agrees(plan, ue, tabs, params, outputs, design,
                                  tol) and good
    print(f"quick: every design, P1-P3, f64 and f32: "
          f"{'agree' if good else 'FAILED'}", flush=True)
    return good


def sweep_case(case, dev, lib) -> bool:
    ue, tabs, params = tables(case, dev)
    E, n = ue.shape
    q = tabs[0].shape[0]
    plan = K.PBElement(*tabs, *params)
    good = True
    times = {}
    for outputs in K.PB_OUTPUTS:
        for design in DESIGNS:
            good = agrees(plan, ue, tabs, params, outputs, design,
                          REL_TOL) and good
    # device times: one trace per block size (the name carries the rest)
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = torch.cuda.current_device()
    for threads in (64, 128, 256):
        fns = [lambda o=o, d=d: plan._launch(ue, o, d)
               for o in K.PB_OUTPUTS.values()
               for d in DESIGNS if d[2] == threads]
        blocks = -(-E // (threads // SETTLED[0]))
        fns.append(lambda: lib.pb_empty_launch(blocks, threads, index,
                                               stream))
        for key, ms in device_ms(fns).items():
            if "pb_empty_kernel" in key:
                times[("empty", threads)] = ms
            else:
                times[(*design_of(key), threads)] = ms
    for outputs, out in K.PB_OUTPUTS.items():
        b_ms = 1e3 * pb_bytes(E, n, q, out) / PEAK_BYTES
        print(f"E={E} n={n} q={q} f64, {outputs}: bound {b_ms:.5f} ms "
              f"(bytes)")
        for tpe, staged, threads in DESIGNS:
            ms = times[(out, tpe, staged, threads)]
            mark = "  <-- settled" if (tpe, staged, threads) == SETTLED else ""
            print(f"  tpe {tpe} staged {staged} threads {threads:3d}: "
                  f"{ms:.5f} ms on the device ({100 * b_ms / ms:.1f} % of "
                  f"the bound reached){mark}")
    for threads in (64, 128, 256):
        print(f"E={E}: empty kernel, {threads} threads a block: "
              f"{times[('empty', threads)]:.5f} ms on the device")
    # wrapper-inclusive: the prepared call, the checked function, the floor
    for outputs in K.PB_OUTPUTS:
        t = event_ms(lambda: plan(ue, outputs))
        print(f"E={E}: PBElement call, {outputs}: {show(t)}")
    t = event_ms(lambda: K.pb_residual_jacobian(ue, *tabs, *params))
    print(f"E={E}: checked pb_residual_jacobian, both: {show(t)}")
    blocks = -(-E // (SETTLED[2] // SETTLED[0]))
    raw_stream = K._device_stream(dev)[1]
    t = event_ms(lambda: lib.pb_empty_launch(blocks, SETTLED[2], index,
                                             raw_stream()))
    print(f"E={E}: empty kernel through ctypes with the stream lookup: "
          f"{show(t)}", flush=True)
    call_parts(plan, ue)
    return good


def this_tree(dev) -> None:
    """This tree's checked function and prepared call, as the parent's
    snippet times the parent's."""
    for case in CASES:
        ue, tabs, params = tables(case, dev)
        plan = K.PBElement(*tabs, *params)
        row = {"E": ue.shape[0]}
        for label, fn in (("checked", lambda: K.pb_residual_jacobian(
                ue, *tabs, *params)),
                ("prepared", lambda: plan(ue, "both")),
                ("prepared_residual", lambda: plan(ue, "residual")),
                ("prepared_jacobian", lambda: plan(ue, "jacobian"))):
            dms = device_ms([fn], 50)
            row[label] = {**event_ms(fn),
                          "device_ms": sum(dms.values()) / len(dms)}
        print("this tree: " + json.dumps(row), flush=True)


def parent(directory: str) -> None:
    out = subprocess.run(
        [sys.executable, "-c", PARENT_SNIPPET, json.dumps(CASES)],
        cwd=directory, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"the parent's timing failed:\n{out.stderr}")
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            print("parent:    " + line, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("pb_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    info = K.build(defines=("-DPB_ALL_DESIGNS",))
    print(f"build with every design {info['seconds']:.2f} s")
    good = register_report(info["log"])
    if not good:
        print("an instance spills")
    good = quick(dev) and good
    if "--quick" not in sys.argv:
        lib = K._library()
        for case in CASES:
            good = sweep_case(case, dev, lib) and good
    if "--parent" in sys.argv:
        directory = sys.argv[sys.argv.index("--parent") + 1]
        for turn in ("parent", "this", "this", "parent"):
            parent(directory) if turn == "parent" else this_tree(dev)
    print("all checks passed" if good else "CHECKS FAILED")
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
