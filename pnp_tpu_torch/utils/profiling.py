"""Phase timers, throughput counters and a profiler hook (port of
``pnp_tpu.utils.profiling``).

:class:`PhaseTimer` reads the host clock around a named phase and, before
it stops the clock, synchronises the device of the tensors it is given:
PyTorch returns before a CUDA device finishes, so an unsynchronised host
clock measures the enqueue. :func:`maybe_trace` wraps ``torch.profiler``
(CPU and, where present, CUDA activity) and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class Counters:
    dofs_assembled: int = 0
    krylov_iterations: int = 0
    newton_iterations: int = 0
    steps: int = 0

    def dofs_per_sec(self, elapsed: float) -> float:
        return self.dofs_assembled / max(elapsed, 1e-12)


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
    """``torch.profiler`` trace when a directory is given (written there as
    ``trace.json``; the profiler object is yielded), no-op otherwise."""
    if not trace_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
