"""Reading a ``torch.profiler`` trace of one segment: the device's busy
time, its kernels, the kernels launched inside named host ranges, and
where the device sat idle.

The trace is exported as Chrome JSON under ``TMPDIR`` (the only place
the benchmark writes one), read back and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

#: device activities that occupy the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_NAME_CHARS = 120


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _covering(starts, evs, t):
    """The shortest of ``evs`` (sorted by start) that covers time ``t``;
    looks back over the 400 that start last before it."""
    i = bisect.bisect_right(starts, t)
    best = None
    for e in evs[max(0, i - 400):i]:
        if e["ts"] + e["dur"] >= t and (best is None
                                        or e["dur"] < best["dur"]):
            best = e
    return best


def analyse(prof, range_prefixes=("gj_inverse",), layer_names=()) -> dict:
    """Summary of a profiled stretch: ``busy_s`` (union of device
    activity), ``kernels`` (device kernel count), ``ranges`` {prefix:
    [(range name, device seconds of the kernels launched inside it)]},
    ``device_ops`` and ``idle_gaps`` (the ten largest, [name, seconds]).
    An idle gap is named by the innermost of ``layer_names`` ranges and
    the innermost host operation running when it began."""
    events = [e for e in _events(prof) if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_corr = defaultdict(float)
    for e in dev:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr[corr] += e["dur"]

    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime",
                                                  "cuda_driver",
                                                  "user_annotation")]
    host.sort(key=lambda e: e["ts"])
    launches = [e for e in host if e.get("cat") in ("cuda_runtime",
                                                    "cuda_driver")]
    launch_ts = [e["ts"] for e in launches]
    ranges = {p: [] for p in range_prefixes}
    for e in host:
        if e.get("cat") != "user_annotation":
            continue
        for p in range_prefixes:
            if e["name"].startswith(p):
                lo = bisect.bisect_left(launch_ts, e["ts"])
                hi = bisect.bisect_right(launch_ts, e["ts"] + e["dur"])
                us = sum(by_corr.get(c["args"].get("correlation"), 0.0)
                         for c in launches[lo:hi]
                         if c.get("tid") == e.get("tid"))
                ranges[p].append((e["name"], us * 1e-6))

    per_name = defaultdict(float)
    for e in kernels:
        per_name[e["name"][:_NAME_CHARS]] += e["dur"] * 1e-6
    device_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]

    ops = [e for e in host if e.get("cat") == "cpu_op"]
    op_ts = [e["ts"] for e in ops]
    layers = [e for e in host if e.get("cat") == "user_annotation"
              and e["name"] in layer_names]
    layer_ts = [e["ts"] for e in layers]
    gaps = defaultdict(float)
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        layer = _covering(layer_ts, layers, e0)
        op = _covering(op_ts, ops, e0)
        name = (f"{layer['name'] if layer else 'segment'}:"
                f"{op['name'][:_NAME_CHARS] if op else 'python'}")
        gaps[name] += (s1 - e0) * 1e-6
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(e - s for s, e in busy) * 1e-6,
            "kernels": len(kernels), "ranges": ranges,
            "device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": [[k, v] for k, v in idle_gaps]}
