"""The program's own spans in a cell's traced run: which code of
``pnp_tpu_torch`` leaves the card waiting.

    python3 benchmark/spans.py --workload CELL --seed N --seconds S

From the root of a checkout, on the card. It runs the cell as
``run.py --trace 1`` does (the same set-up, window, traced segment and
check, with the same result). Around the traced segment it runs more
segments of the traffic's length: before it, segments with the
program's recorder (``pnp_tpu_torch.utils.profiling.recording``) off
and on, without a profiler (:func:`on_cost`); after it, one inside the
recorder under ``torch.profiler`` on the card (:func:`recorded_segment`).
The recorder's spans are ranges on the profiler's clock, so each is set
beside the device's activity (:func:`attribute`), and each idle gap is
named by the innermost program span open when it began
(:func:`name_gaps`). The last line of standard output is one JSON
object: the run's result and, under ``program``, the recorded segment's
numbers (:func:`program_numbers`), idle gaps and spans, and the on/off
segments' times. Like ``run.py`` it runs on ``cuda:0``, refuses a
machine without the cell's devices, and prints no result if the run
loaded a forbidden module. :func:`run` on the CPU (the tests) runs the
recorded segment without the profiler: the counts and host times are
read, the device's numbers are None. It is not the benchmark's command
and no cell runs it; it goes when the harness reads the program's spans
itself.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import trace  # noqa: E402

_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_SPECIES = ("pnp.species_factor", "pnp.species_step")


def _measure(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _busy(events) -> list:
    """The union of the device's activity, sorted intervals in us."""
    return trace._union([(e["ts"], e["ts"] + e["dur"]) for e in events
                         if e.get("cat") in trace._DEVICE_CATS])


def _intersect(a, b) -> float:
    """Length of the overlap of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def attribute(events, busy, names) -> dict:
    """Per program span name in ``names``, over a Chrome trace's complete
    events (``ph`` "X", times in us; ``busy``: :func:`_busy` of them):
    ``count``, ``host_s`` (the union of its intervals, so a span nested
    in one of its own name counts once), ``busy_s`` and ``idle_s``
    (device activity and its absence inside that union) and
    ``launched_s`` (device time of the kernels and copies launched from
    its thread while it was open, by correlation id)."""
    by_corr = defaultdict(float)
    for e in events:
        if e.get("cat") not in trace._DEVICE_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr[corr] += e["dur"]
    launches = sorted((e for e in events if e.get("cat") in _LAUNCH_CATS),
                      key=lambda e: e["ts"])
    launch_ts = [e["ts"] for e in launches]
    spans = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in names:
            spans[e["name"]].append(e)
    out = {}
    for name, evs in spans.items():
        union = trace._union([(e["ts"], e["ts"] + e["dur"]) for e in evs])
        seen, launched = set(), 0.0
        for e in evs:
            lo = bisect.bisect_left(launch_ts, e["ts"])
            hi = bisect.bisect_right(launch_ts, e["ts"] + e["dur"])
            for c in launches[lo:hi]:
                corr = c.get("args", {}).get("correlation")
                if c.get("tid") == e.get("tid") and corr not in seen:
                    seen.add(corr)
                    launched += by_corr.get(corr, 0.0)
        host = _measure(union)
        inside = _intersect(union, busy)
        out[name] = {"count": len(evs), "host_s": host * 1e-6,
                     "busy_s": inside * 1e-6,
                     "idle_s": (host - inside) * 1e-6,
                     "launched_s": launched * 1e-6}
    return out


def name_gaps(events, busy, names, layer_names=(), top: int = 12,
              by_op: bool = True) -> list:
    """The ``top`` largest sums of device idle time, [name, seconds], over
    the gaps of ``busy`` between device activity, with ``events`` and
    ``busy`` as :func:`attribute` takes them, ``events`` sorted by start:
    each gap is named ``<innermost program span>:<host op>`` at its
    start, the program span one of ``names`` (else the innermost of
    ``layer_names``, else ``segment``), the host op the innermost one
    running (else ``python``); without ``by_op``, by the span alone."""
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    prog = [e for e in notes if e["name"] in names]
    layers = [e for e in notes if e["name"] in layer_names]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    prog_ts, layer_ts, op_ts = ([e["ts"] for e in evs]
                                for evs in (prog, layers, ops))
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        where = (trace._covering(prog_ts, prog, e0)
                 or trace._covering(layer_ts, layers, e0))
        op = trace._covering(op_ts, ops, e0)
        name = where["name"] if where else "segment"
        if by_op:
            name += f":{op['name'][:trace._NAME_CHARS] if op else 'python'}"
        gaps[name] += (s1 - e0) * 1e-6
    return [[k, v] for k, v in sorted(gaps.items(),
                                      key=lambda kv: -kv[1])[:top]]


def program_numbers(rec, steps: int, attributed=None) -> dict:
    """The recorded segment's numbers a step: ``host_syncs_per_step``
    (the recorder's count), ``sync_wait_ms`` (host time inside
    ``host.sync`` and ``host.copy`` spans), and from :func:`attribute`'s
    ``attributed`` (None without a trace) ``poisson_idle_ms`` and
    ``species_idle_ms`` (device idle while the host is inside
    ``pnp.poisson_solve``, or inside ``pnp.species_factor`` and
    ``pnp.species_step``, which never overlap) and ``gj_inverse_ms``
    (device time of the kernels launched inside ``kernels.gj_inverse``)."""
    summary = rec.summary()
    wait = sum(summary.get(n, {}).get("host_s", 0.0)
               for n in ("host.sync", "host.copy"))
    out = {"host_syncs_per_step": rec.counters.host_syncs / steps,
           "sync_wait_ms": 1e3 * wait / steps,
           "poisson_idle_ms": None, "species_idle_ms": None,
           "gj_inverse_ms": None}
    if attributed is not None:
        def ms(names, key):
            return 1e3 * sum(attributed.get(n, {}).get(key, 0.0)
                             for n in names) / steps
        out.update(poisson_idle_ms=ms(["pnp.poisson_solve"], "idle_s"),
                   species_idle_ms=ms(_SPECIES, "idle_s"),
                   gj_inverse_ms=ms(["kernels.gj_inverse"], "launched_s"))
    return out


def recorded_segment(stepper, state0, n_steps: int, device) -> dict:
    """One segment of ``n_steps`` inside the program's recorder, under
    ``torch.profiler`` on the card (with the harness's layer ranges)."""
    import torch
    from pnp_tpu_torch.utils.profiling import recording

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    with recording() as rec:
        if device.type == "cuda":
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                stepper.segment(state0, n_steps, ranges=True)
                sync()
                wall_s = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            stepper.segment(state0, n_steps, ranges=True)
            wall_s = time.perf_counter() - t0
    out = {"steps": n_steps, "wall_s": wall_s,
           "numbers": program_numbers(rec, n_steps),
           "spans": rec.summary()}
    if device.type == "cuda":
        from benchmark.harness import LAYER_RANGES
        names = {s.name for s in rec.spans}
        events = sorted((e for e in trace._events(prof)
                         if e.get("ph") == "X"), key=lambda e: e["ts"])
        busy = _busy(events)
        out["spans"] = attribute(events, busy, names)
        out["numbers"] = program_numbers(rec, n_steps, out["spans"])
        out["busy_s"] = _measure(busy) * 1e-6
        out["idle_gaps"] = name_gaps(events, busy, names, LAYER_RANGES)
        out["idle_by_span"] = name_gaps(events, busy, names, LAYER_RANGES,
                                        top=len(names) + 4, by_op=False)
    return out


def on_cost(stepper, state0, n_steps: int, device) -> dict:
    """The recorder's cost without a profiler: twice a segment with
    recording off, then one inside ``recording()``; each one's synced
    wall seconds, under ``off_s`` and ``on_s``."""
    import torch
    from pnp_tpu_torch.utils.profiling import recording

    def timed():
        t0 = time.perf_counter()
        stepper.segment(state0, n_steps)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    out = {"off_s": [], "on_s": []}
    for _ in range(2):
        out["off_s"].append(timed())
        with recording():
            out["on_s"].append(timed())
    return out


def run(root, workload: str, seed: int, seconds: float, device,
        t_start: float) -> dict:
    """``run.py --trace 1``'s run of ``workload``, with :func:`on_cost`'s
    segments before its traced one and the recorded segment
    (:func:`recorded_segment`) after it; the result under ``program``."""
    from benchmark import harness

    real = harness._profile_segment
    recorded = {}

    def both(stepper, state0, n_steps, dev, K):
        # before any profiler: one leaves the process's launches slower
        cost = on_cost(stepper, state0, n_steps, dev)
        first = real(stepper, state0, n_steps, dev, K)
        recorded.update(recorded_segment(stepper, state0, n_steps, dev))
        recorded["on_cost"] = cost
        if first is not None:
            recorded["first_wall_s"] = first["wall_s"]
        return first

    harness._profile_segment = both
    try:
        result = harness.run_cell(root, workload, seed, seconds, True,
                                  device, t_start)
    finally:
        harness._profile_segment = real
    result["program"] = recorded
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    from benchmark.harness import Cell, CellError, forbidden_loaded
    try:
        cell = Cell.load(ROOT, args.workload)
    except (CellError, OSError, KeyError, ValueError) as e:
        print(f"spans: {e}", file=sys.stderr)
        return 2
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"spans: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 3
    result = run(ROOT, args.workload, args.seed, args.seconds, "cuda:0",
                 T_START)
    bad = forbidden_loaded()
    if bad:
        print(f"spans: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
