"""Phase timers, the span recorder, the host-sync counter and a profiler
hook (port of ``pnp_tpu.utils.profiling``).

:class:`PhaseTimer` reads the host clock around a named phase and, before
it stops the clock, synchronises the device of the tensors it is given:
PyTorch returns before a CUDA device finishes, so an unsynchronised host
clock measures the enqueue. :func:`maybe_trace` wraps ``torch.profiler``
(CPU and, where present, CUDA activity) and writes a Chrome trace.

The recorder: the solvers and the driver open :func:`span` around their
phases and solves, and read every device scalar they branch on through
:func:`host_read` (and every array they copy to the host through
:func:`host_copy`). Outside :func:`recording` (the default) a span is one
bool test and a shared no-op context: no clock read, no profiler range,
no device sync. Inside it each span is kept with its parent, its host
clock interval (``time.perf_counter_ns``) and its attributes, and opens a
``torch.profiler.record_function`` of its name, so that a running
profiler puts it on the timeline of the device's activity; each host read
or copy is a ``host.sync`` or ``host.copy`` span and adds one to
``counters.host_syncs``; :func:`count` adds one to another counter. The
recorder never synchronises: a span's duration is host time, and what the
device did inside it comes from the trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class Counters:
    """What the recorder counts: ``host_syncs``, the blocking device-to-host
    reads and copies (:func:`host_read`, :func:`host_copy`);
    ``amg_builds``, the AMG preconditioner's coarse matrices built and
    factored (one a Krylov solve under ``CG_AMG_SSOR``)."""

    host_syncs: int = 0
    amg_builds: int = 0


#: the recorder's counts; incremented only inside :func:`recording`, which
#: resets them on entry
counters = Counters()

_on = False          # inside recording()
_spans = None        # the current recording's spans, in start order
_open = []           # the spans open now, innermost last


class Span:
    """One recorded span: ``name``, ``id`` (its index in the recording),
    ``parent`` (the enclosing open span's id, or None), ``start_ns`` and
    ``end_ns`` on ``time.perf_counter_ns``, ``attrs``."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "attrs",
                 "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = self.parent = self.start_ns = self.end_ns = None

    def set(self, **attrs) -> None:
        """Add attributes known only at the span's end."""
        self.attrs.update(attrs)

    def __enter__(self):
        self.id = len(_spans)
        self.parent = _open[-1].id if _open else None
        _spans.append(self)
        _open.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _open.pop()
        return False


class _NoSpan:
    """The shared context :func:`span` returns outside a recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A context around a named stretch of host code: recorded, with
    ``attrs``, inside :func:`recording`; the shared no-op context
    otherwise. ``with span(...) as s: ... s.set(k=v)`` adds attributes
    at the end."""
    if not _on:
        return _NO_SPAN
    return Span(name, attrs)


def is_recording() -> bool:
    """Whether a :func:`recording` is open."""
    return _on


def count(name: str) -> None:
    """Add one to the counter ``name`` inside :func:`recording`; nothing
    outside it."""
    if _on:
        setattr(counters, name, getattr(counters, name) + 1)


def host_read(t):
    """The Python value of a one-element tensor (``t.item()``: a bool,
    int or float): the one way the solvers read a device scalar to decide
    a branch. Inside :func:`recording`, a ``host.sync`` span and one
    count."""
    if not _on:
        return t.item()
    with Span("host.sync", {}):
        value = t.item()
    counters.host_syncs += 1
    return value


def host_copy(t):
    """``t`` as a numpy array on the host. Inside :func:`recording`, a
    ``host.copy`` span and one count."""
    if not _on:
        return t.detach().cpu().numpy()
    with Span("host.copy", {}):
        out = t.detach().cpu().numpy()
    counters.host_syncs += 1
    return out


@dataclasses.dataclass
class Recording:
    """What :func:`recording` recorded: every span in start order and the
    counters (live while recording, a copy after)."""

    spans: list
    counters: Counters

    def summary(self) -> dict:
        """Per span name: ``count`` and ``host_s``, the total host
        seconds."""
        out = {}
        for s in self.spans:
            if s.end_ns is None:
                continue
            d = out.setdefault(s.name, {"count": 0, "host_s": 0.0})
            d["count"] += 1
            d["host_s"] += 1e-9 * (s.end_ns - s.start_ns)
        return out

    def to_json(self) -> dict:
        return {"spans": self.summary(),
                "counters": dataclasses.asdict(self.counters)}


@contextlib.contextmanager
def recording():
    """Record spans and counts over the body; yields the
    :class:`Recording`. Resets :data:`counters` on entry."""
    global _on, _spans
    for f in dataclasses.fields(counters):
        setattr(counters, f.name, 0)
    rec = Recording(spans=[], counters=counters)
    _spans, _on = rec.spans, True
    try:
        yield rec
    finally:
        _on, _spans = False, None
        rec.counters = dataclasses.replace(counters)


def _devices(obj):
    """CUDA devices of a tensor, a device, or a (nested) tuple/list."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.is_cuda else set()
    if isinstance(obj, torch.device):
        return {obj} if obj.type == "cuda" else set()
    if isinstance(obj, (tuple, list)):
        return set().union(*(_devices(o) for o in obj)) if obj else set()
    return set()


def synchronize(obj) -> None:
    """Wait for every CUDA device that ``obj``'s tensors live on."""
    for dev in _devices(obj):
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulating named-phase wall timer with device sync."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the body; ``sync`` (tensors or a device) is synchronised
        before the clock stops."""
        synchronize(sync)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def ms(self, name: str) -> float:
        """Mean milliseconds of one call of phase ``name``."""
        return 1e3 * self.totals[name] / max(self.counts[name], 1)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"  {name:<28s} {self.totals[name]:10.3f}s "
                         f"x{self.counts[name]}")
        return "\n".join(lines)


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]):
    """``torch.profiler`` trace when a directory is given, recorded (the
    program's spans are ranges on its timeline): written there as
    ``trace.json``, with ``spans.json`` beside it (:meth:`Recording.to_json`:
    per span name the count and host seconds, and the counters); the
    profiler object is yielded. No-op otherwise."""
    if not trace_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with recording() as rec:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    with open(os.path.join(trace_dir, "spans.json"), "w") as f:
        json.dump(rec.to_json(), f, indent=1)
