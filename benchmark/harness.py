"""One run of one benchmark cell of ``pnp_tpu_torch``: the pore transient's
production stepping, timed over a window, traced on request, and checked
against the plain reference in ``reference/``.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration, whose
file holds the mesh, the physics and the solver as run, and a traffic mix,
``traffic/<name>.json``: the segment length, the species-factor refresh,
the cadences, the warm-up and the band the seed draws the outflow bias
from. ``limits/<cell>.json`` holds the number of steps the reference
follows and each compared number's limit. A per-layer metric is read by
``metrics/<name>.py``'s ``read(record)``, which returns a number or None.
A new cell or metric is new files only.

Set-up: the kernels' load or build (into the program's ``_build/`` inside
the checkout), the mesh, ``Sysparams``, the ``FunctionSpace``,
``build_pnp_system`` (phases A to C), the Poisson presolve, and a warm-up
segment of one refresh window. The window then runs segments of the
traffic's length, each from the presolved start state, each step as
``run_instationary_pnp_from_pb``'s loop does it (factor on the refresh,
species stages, Poisson on its cadence, a device sync, the currents read
to the host on the output cadence), until ``--seconds`` have passed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import trace
from benchmark.reference import compare, pnp as reference

#: top-level modules that no run may load (compared whole: the port's
#: ``pnp_tpu_torch`` is not ``pnp_tpu``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pnp_tpu")
#: host ranges the traced segment opens around the harness's calls
LAYER_RANGES = ("species", "poisson", "currents")


class CellError(ValueError):
    """The benchmark's files do not define the cell asked for."""


@dataclasses.dataclass
class Cell:
    """A cell's definition, read from the files under ``root``."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    data: Path                      # the benchmark's directory

    @classmethod
    def load(cls, root: Path, name: str) -> "Cell":
        root = Path(root)
        spec = json.loads((root / "BENCHMARK.json").read_text())
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        w = work[name]
        conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
        data = root / spec["paths"][0]

        def read(path: Path) -> dict:
            if not path.is_file():
                raise CellError(f"{path} is missing")
            return json.loads(path.read_text())

        def applies(m):
            return name in m.get("workloads", [name])

        return cls(name=name, chips=int(w["chips"]),
                   config=read(root / conf["file"]),
                   traffic=read(data / "traffic" / f"{w['traffic']}.json"),
                   limits=read(data / "limits" / f"{name}.json"),
                   end_to_end=[m for m in spec["end_to_end"] if applies(m)],
                   per_layer=[m for m in spec["per_layer"] if applies(m)],
                   data=data)

    def bias(self, seed: int) -> float:
        """The outflow bias of this seed, uniform in the traffic's band."""
        lo, hi = self.traffic["bias_band"]
        return lo + (hi - lo) * float(np.random.default_rng(
            abs(int(seed))).random())

    def system(self) -> dict:
        """The configuration's ``system`` with the traffic's overrides."""
        return {**self.config["system"],
                **self.traffic.get("system_overrides", {})}

    def surfaces(self, bias: float) -> list:
        surf = [dict(s) for s in self.config["surfaces"]]
        surf[self.config["bias_surface"]]["coulombPotential"] = bias
        return surf


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Segment:
    """What a segment's steps produced and took."""

    step_s: list = dataclasses.field(default_factory=list)
    species_s: list = dataclasses.field(default_factory=list)
    poisson_s: list = dataclasses.field(default_factory=list)
    species_its: list = dataclasses.field(default_factory=list)
    poisson_its: list = dataclasses.field(default_factory=list)
    currents: list = dataclasses.field(default_factory=list)  # (i, I+, I-)
    snapshot: tuple = None          # host (phi, c+, c-) after ``snap_at``
    finite: bool = True


class Stepper:
    """The driver's step loop over a built ``PnpSystem``."""

    def __init__(self, system, sysp, traffic: dict, device, calc_ion_flux):
        self.system, self.device = system, device
        self.pfreq = int(sysp.potentialUpdateFreq)
        self.ofreq = int(sysp.outputFreq)
        self.refresh = int(traffic["ras_refresh_every"])
        # as run_instationary_pnp_from_pb: a reused factor on block-RAS,
        # a fresh one every step on the dense tier
        self.reuse = self.refresh > 1 and system.factor_kind == "ras"
        self.calc_ion_flux = calc_ion_flux

    def segment(self, state, n_steps: int, deadline=None, snap_at=None,
                spans: bool = False, ranges: bool = False) -> Segment:
        """``n_steps`` steps from ``state``, or fewer if the host clock
        passes ``deadline`` first (checked before each step). ``spans``
        syncs around the species and the Poisson calls and times each;
        ``ranges`` opens profiler ranges around them."""
        sysm, dev = self.system, self.device
        uphi, ucp, ucm = state
        seg = Segment()
        factor = None

        def rng(name):
            return (torch.profiler.record_function(name) if ranges
                    else contextlib.nullcontext())

        for i in range(n_steps):
            t0 = time.perf_counter()
            if deadline is not None and t0 >= deadline:
                break
            with rng("species"):
                if self.reuse:
                    if i % self.refresh == 0:
                        factor = sysm.species_factor(uphi)
                    ucp, ucm, k = sysm.species_step_reuse(factor, uphi, ucp,
                                                          ucm)
                else:
                    ucp, ucm, k = sysm.species_step(uphi, ucp, ucm)
            if spans:
                _sync(dev)
                t1 = time.perf_counter()
                seg.species_s.append(t1 - t0)
            kp = 0
            with rng("poisson"):
                if i % self.pfreq == 0:
                    uphi, kp = sysm.poisson_solve(uphi, ucp, ucm)
            _sync(dev)
            if spans:
                seg.poisson_s.append(time.perf_counter() - t1)
            if i % self.ofreq == 0:
                with rng("currents"):
                    ip, im = self.calc_ion_flux(sysm.ionflux_tables, uphi,
                                                ucp, ucm)
                    seg.currents.append((i, ip.cpu().numpy(),
                                         im.cpu().numpy()))
            seg.step_s.append(time.perf_counter() - t0)
            seg.species_its.append(int(k))
            seg.poisson_its.append(int(kp))
            if snap_at == i + 1:        # to the host: the device's peak
                seg.snapshot = tuple(      # must not grow with the window
                    v.cpu().numpy() for v in (uphi, ucp, ucm))
        seg.finite = bool(torch.isfinite(uphi).all() & torch.isfinite(
            ucp).all() & torch.isfinite(ucm).all())
        return seg


@dataclasses.dataclass
class Record:
    """What the per-layer readers read."""

    species_s: list
    poisson_s: list
    species_its: list
    poisson_its: list
    pb_s: float
    poisson_setup_s: float
    traced: dict = None             # trace.analyse's summary, with
                                    # "wall_s" and "steps" of the segment


def _reader(data: Path, metric: str):
    path = data / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _card(device) -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or torch.cuda.get_device_name(device)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def forbidden_loaded() -> list:
    """The forbidden top-level modules this process holds."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def run_cell(root, workload: str, seed: int, seconds: float, traced: bool,
             device, t_start: float) -> dict:
    """One run of ``workload`` on ``device``; returns the result's dict.
    ``t_start``: the process's start on the host clock (set-up counts
    from it)."""
    from pnp_tpu_torch.config import Surface, Sysparams
    from pnp_tpu_torch.fem.space import FunctionSpace
    from pnp_tpu_torch.meshio.mesh import Mesh
    from pnp_tpu_torch.operators import kernels as K
    from pnp_tpu_torch.postprocess.ionflux import calc_ion_flux
    from pnp_tpu_torch.workloads.instationary_pnp_from_pb import (
        build_pnp_system)
    from benchmark import meshgen

    cell = Cell.load(root, workload)
    device = torch.device(device)
    tr = cell.traffic
    bias = cell.bias(seed)
    system_conf = cell.system()
    surfaces = cell.surfaces(bias)
    n_ref = int(cell.limits["reference_steps"])
    seg_steps = int(tr["segment_steps"])
    if not 0 < n_ref <= seg_steps:
        raise CellError(f"reference_steps {n_ref} outside the segment")

    # ---- set-up ------------------------------------------------------------
    if device.type == "cuda":
        torch.cuda.set_device(device)
        K.build()
        torch.cuda.reset_peak_memory_stats(device)
    mesh = meshgen.build(cell.config["mesh"])
    sysp = Sysparams(**system_conf,
                     surfaces=[Surface(**s) for s in surfaces])
    sysp.n_surfaces = len(surfaces)
    space = FunctionSpace(Mesh(**mesh), int(system_conf.get("degree", 1)))
    system = build_pnp_system(sysp, space, device=device)
    state0 = (system.poisson_solve(system.uphi0, system.ucp0,
                                   system.ucm0)[0], system.ucp0, system.ucm0)
    stepper = Stepper(system, sysp, tr, device, calc_ion_flux)
    stepper.segment(state0, int(tr["warmup_steps"]))
    _sync(device)
    t_window = time.perf_counter()
    setup_s = t_window - t_start

    # ---- window -------------------------------------------------------------
    deadline = t_window + seconds
    segments = []
    while time.perf_counter() < deadline:
        segments.append(stepper.segment(state0, seg_steps, deadline,
                                        snap_at=n_ref, spans=traced))
    window_s = time.perf_counter() - t_window
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    step_s = [s for seg in segments for s in seg.step_s]
    steps = len(step_s)
    failed = sum(len(seg.step_s) for seg in segments if not seg.finite)

    result = {"correct": False, "attempted": steps, "failed": failed,
              "metrics": {}, "device": {
                  "platform": "gpu" if device.type == "cuda" else
                  device.type,
                  "kind": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else device.type),
                  "count": 1, "memory_peak_bytes": peak}}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not traced:
        e2e = {"step_ms": 1e3 * window_s / max(steps, 1),
               "step_ms_p95": 1e3 * float(np.percentile(step_s, 95)),
               "peak_gib": None if peak is None else peak / 2 ** 30,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                                "unit": units[m["name"]]}
    else:
        record = Record(
            species_s=[s for g in segments for s in g.species_s],
            poisson_s=[s for g in segments for s in g.poisson_s],
            species_its=[k for g in segments for k in g.species_its],
            poisson_its=[k for g in segments for k in g.poisson_its],
            pb_s=system.pb_seconds,
            poisson_setup_s=system.poisson_setup_seconds)
        record.traced = _profile_segment(stepper, state0, seg_steps, device,
                                         K)
        for m in cell.per_layer:
            value = _reader(cell.data, m["name"])(record)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": units[m["name"]]}
        if record.traced is not None:
            result["device"]["busy_s"] = record.traced["busy_s"]
            result["device"]["window_s"] = record.traced["wall_s"]
            result["breakdown"] = {
                "device_ops": record.traced["device_ops"],
                "idle_gaps": record.traced["idle_gaps"]}
    result["card"] = _card(device)

    # ---- the check ----------------------------------------------------------
    program = {"pb": system.pb.cpu().numpy(),
               "segments": [{"state": seg.snapshot,
                             "currents": [c for c in seg.currents
                                          if c[0] < n_ref]}
                            for seg in segments if seg.snapshot is not None]}
    del system, state0, stepper, segments
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference.run(mesh, system_conf, surfaces, n_ref, device=device)
    numbers = compare.numbers(program, ref)
    result["run"] = {"bias": bias,
                     "segments_compared": len(program["segments"]),
                     "setup_s": setup_s, "window_s": window_s,
                     "reference_s": time.perf_counter() - t_ref}
    checks = {k: {"value": v, "limit": cell.limits["limits"][k]}
              for k, v in numbers.items()}
    result["correct"] = bool(
        program["segments"] and failed == 0
        and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                for c in checks.values()))
    result["checks"] = checks
    return result


def _profile_segment(stepper, state0, n_steps, device, K):
    """One segment under ``torch.profiler`` with ranges around the layers
    and around each ``kernels.gj_inverse`` call (named by its batch and
    order); None off the card."""
    if device.type != "cuda":
        return None
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    inner = K.gj_inverse

    def gj_ranged(A, *args, **kwargs):
        with torch.profiler.record_function(
                f"gj_inverse b={A.shape[0]} n={A.shape[-1]}"):
            return inner(A, *args, **kwargs)

    K.gj_inverse = gj_ranged
    try:
        _sync(device)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            stepper.segment(state0, n_steps, ranges=True)
            _sync(device)
            wall_s = time.perf_counter() - t0
    finally:
        K.gj_inverse = inner
    out = trace.analyse(prof, ("gj_inverse",), LAYER_RANGES)
    out["wall_s"] = wall_s
    out["steps"] = n_steps
    return out

