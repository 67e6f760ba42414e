"""The measurement entry point: production PNP steps on the pore case and
its refined ladder (the port's counterpart of the repository's root
``bench.py``).

    python3 -m pnp_tpu_torch.bench [--device D]
    python3 -m pnp_tpu_torch.bench --scaled LEVELS N_MEAS [--device D]
    python3 -m pnp_tpu_torch.bench --drybuild [--device D]

The case is built in code: ``pore_case(80, 44)`` (3,105 nodes, 5,888
triangles; the reference's flagship ``pore.msh`` has 3,048 and 6,094),
refined ``L`` times by ``refine_uniform`` at P1: L1 12,097 nodes, L2
47,745, L3 189,697. L0 takes the dense tier, L1 the block-RAS tier with
the mid-size Poisson inverse, L2 the very-large Poisson inverse, L3 the
two-level RAS Poisson (above ``poisson_inv_threshold``).

Without flags it prints one JSON line as soon as the headline is measured
(``"scaled": []``) and the line again after each level, so the last line
holds everything: the headline ``pore_pnp_production_step_dofs_per_s_per_chip``
(3 * ndof field dofs advanced per fused step, species stages plus the
Poisson re-solve, after the PB Newton bootstrap), the headline step's
phases, and under ``scaled`` the levels 1-3, each run by ``--scaled L N``
in a process of its own so that no level's memory stays beside another's.
``--drybuild`` builds L0, runs one step and prints ``DRYBUILD-OK``.

One change from the root script: every run solves Poisson once, untimed,
before its first step (``run_scaled`` there already did). From the raw
biased start the pore case diverges within six steps in both packages,
and its dense-tier stage matrices fail the contraction probe with any f32
inverse. Not carried over: the retries, the sections that turn a failed
phase or level into ``null``, the iteration cap lowered for a TPU's
watchdog (``pore_sysparams``' own cap of 3,000 holds, so
``config_overrides`` is empty), the substitute step time for a lazily
dispatching backend, and ``vs_baseline``: ``BENCH_BASELINE.json`` holds a
TPU figure, so it is ``null``. A failure raises; a level that fails or
runs past its time limit makes the script exit non-zero after the lines
it has printed.

Every function runs on ``device``: the current CUDA device by default (it
raises without one), ``"cpu"`` on request. On the card a run first builds
(or loads) the kernels and starts CUDA and cuBLAS, outside every timer;
the first launch of each of PyTorch's own kernels still falls in phase A
of a fresh process. ``base`` (the unrefined
``(nx, ny)``) and the keyword arguments passed on to ``build_pnp_system``
let the tests run it small; the command line has neither.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

from .fem.space import FunctionSpace
from .meshio.refine import refine_uniform
from .meshio.structured import pore_without_dna_mesh
from .operators import kernels as K
from .problems import pore_sysparams
from .utils.device import resolve_device
from .utils.profiling import synchronize
from .workloads.instationary_pnp_from_pb import build_pnp_system

BASE = (80, 44)
CASE = "pore_case(80, 44) + refine_uniform(L)"
METRIC = "pore_pnp_production_step_dofs_per_s_per_chip"
HEADLINE_MEAS = 10
#: (levels, timed steps) of the ladder, each in its own process
LADDER = ((1, 4), (2, 4), (3, 2))
#: each level's time limit, s: tens of times what the level's process
#: takes on an H100 (10-30 s, PERF.md), so a level that finishes does not
#: come near it
LEVEL_TIMEOUT_S = {1: 300, 2: 600, 3: 900}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(levels: int = 0, base=BASE):
    """(Sysparams, P1 FunctionSpace) of the pore case on the ``base``
    structured pore refined ``levels`` times."""
    mesh = pore_without_dna_mesh(*base)
    if levels:
        mesh = refine_uniform(mesh, levels)
    return pore_sysparams(), FunctionSpace(mesh, 1)


def _start(device) -> None:
    """Pay a process's one-time costs on the card before any timer runs:
    the kernels' build (or the load of a built library: seconds on a fresh
    checkout), the CUDA context and cuBLAS' handles; then reset the peak
    memory."""
    if device.type != "cuda":
        return
    K.build()
    for dtype in (torch.float32, torch.float64):
        a = torch.ones((8, 8), dtype=dtype, device=device)
        a @ a
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)


def _peak_gib(device):
    """Peak device memory since the last reset, GiB (None on the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def _launches_since(before: dict) -> dict:
    """Kernel launches since ``before`` (a copy of ``kernels.launches``)."""
    return {k: n - before[k] for k, n in K.launches.items()}


def _finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _presolved(system):
    """The start state with Poisson solved once (untimed)."""
    uphi, _ = system.poisson_solve(system.uphi0, system.ucp0, system.ucm0)
    return uphi, system.ucp0, system.ucm0


def run_headline(n_meas: int = HEADLINE_MEAS, base=BASE, device=None,
                 **build_kw):
    """The headline on L0: build (phase A included), presolve, 2 warm-up
    fused steps, ``n_meas`` timed ones. Returns (the result's dict, the
    state after the timed steps)."""
    device = resolve_device(device)
    sys_, space = _load(0, base)
    _start(device)
    before = dict(K.launches)
    t0 = time.perf_counter()
    system = build_pnp_system(sys_, space, device=device, **build_kw)
    state = _presolved(system)
    synchronize(device)
    setup_s = time.perf_counter() - t0
    for _ in range(2):
        state = system.fused_step(*state)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_meas):
        state = system.fused_step(*state)
    synchronize(device)
    elapsed = time.perf_counter() - t0
    if not _finite(*state):
        raise FloatingPointError("headline: non-finite state")

    # the step's two halves, each timed alone after one warm call
    uphi = state[0]
    ucp, ucm, _ = system.species_step(*state)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_meas):
        ucp, ucm, _ = system.species_step(uphi, ucp, ucm)
    synchronize(device)
    species_ms = 1e3 * (time.perf_counter() - t0) / n_meas
    uphi, _ = system.poisson_solve(uphi, ucp, ucm)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_meas):
        uphi, _ = system.poisson_solve(uphi, ucp, ucm)
    synchronize(device)
    poisson_ms = 1e3 * (time.perf_counter() - t0) / n_meas
    out = {"value": 3 * space.ndof * n_meas / elapsed,
           "nodes": space.ndof, "triangles": space.mesh.num_tris,
           "poisson_tier": system.poisson_tier,
           "pb_newton_iterations": system.pb_newton_iterations,
           "pb_s": system.pb_seconds, "setup_s": setup_s,
           "phases": {"species_ms": species_ms, "poisson_ms": poisson_ms,
                      "fused_step_ms": 1e3 * elapsed / n_meas},
           "peak_gib": _peak_gib(device),
           "launches": _launches_since(before)}
    return out, state


def run_scaled(levels: int, n_meas: int = 4, refresh: int = 4, base=BASE,
               device=None, **build_kw):
    """One level of the ladder with factor-amortized stepping: build (phase
    A included), presolve, one warm-up step, then a timed block of
    ``n_meas`` ``fused_step_reuse`` steps with the species factor built
    at its start and every ``refresh`` steps; then the species factor,
    the species stages on it and the Poisson re-solve, each timed alone
    after one warm call. Returns (the result's dict, the state after the
    timed block)."""
    device = resolve_device(device)
    sys_, space = _load(levels, base)
    _start(device)
    before = dict(K.launches)
    t0 = time.perf_counter()
    system = build_pnp_system(sys_, space, device=device, **build_kw)
    state = _presolved(system)
    synchronize(device)
    setup_s = time.perf_counter() - t0

    def block(state, n):
        for i in range(n):
            if i % refresh == 0:
                factor = system.species_factor(state[0])
            state = system.fused_step_reuse(factor, *state)
        return state

    state = block(state, 1)
    synchronize(device)
    t0 = time.perf_counter()
    state = block(state, n_meas)
    synchronize(device)
    elapsed = time.perf_counter() - t0
    if not _finite(*state):
        raise FloatingPointError(f"scaled L{levels}: non-finite state")

    uphi, ucp, ucm = state
    factor = system.species_factor(uphi)
    ucp2, ucm2, _ = system.species_step_reuse(factor, uphi, ucp, ucm)
    uphi2, _ = system.poisson_solve(uphi, ucp2, ucm2)
    synchronize(device)
    t0 = time.perf_counter()
    factor = system.species_factor(uphi2)
    synchronize(device)
    factor_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ucp2, ucm2, species_its = system.species_step_reuse(factor, uphi2, ucp2,
                                                        ucm2)
    synchronize(device)
    species_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    uphi2, poisson_its = system.poisson_solve(uphi2, ucp2, ucm2)
    synchronize(device)
    poisson_ms = 1e3 * (time.perf_counter() - t0)
    out = {"levels": levels, "nodes": space.ndof,
           "triangles": space.mesh.num_tris,
           "dofs_per_s": 3 * space.ndof * n_meas / elapsed,
           "step_ms": 1e3 * elapsed / n_meas, "ras_refresh_every": refresh,
           "phases": {"species_factor_ms": factor_ms,
                      "species_ms": species_ms,
                      "species_stage_iters": int(species_its),
                      "poisson_ms": poisson_ms,
                      "poisson_iters": int(poisson_its)},
           "poisson_tier": system.poisson_tier,
           "pb_newton_iterations": system.pb_newton_iterations,
           "pb_s": system.pb_seconds,
           "poisson_setup_s": system.poisson_setup_seconds,
           "setup_s": setup_s, "peak_gib": _peak_gib(device),
           "launches": _launches_since(before)}
    return out, state


def run_drybuild(base=BASE, device=None, **build_kw):
    """Build L0, run one presolved fused step, check the state is finite
    and print ``DRYBUILD-OK``. Returns the state."""
    device = resolve_device(device)
    sys_, space = _load(0, base)
    system = build_pnp_system(sys_, space, device=device, **build_kw)
    state = system.fused_step(*_presolved(system))
    if not _finite(*state):
        raise FloatingPointError("drybuild: non-finite state")
    print("DRYBUILD-OK", flush=True)
    return state


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card (its first line
    where there are several), or the device type off the card."""
    if device.type != "cuda":
        return device.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run_level(levels: int, n_meas: int, device=None) -> dict:
    """``--scaled levels n_meas`` in a process of its own, within
    ``LEVEL_TIMEOUT_S[levels]``; its stderr passes through. Raises if it
    fails or runs out of time."""
    cmd = [sys.executable, "-u", "-m", "pnp_tpu_torch.bench", "--scaled",
           str(levels), str(n_meas)]
    if device is not None:
        cmd += ["--device", str(device)]
    proc = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE, text=True,
                          timeout=LEVEL_TIMEOUT_S[levels])
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("SCALED-JSON:")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"scaled L{levels}: exit {proc.returncode}, "
                           f"output {proc.stdout[-2000:]!r}")
    return json.loads(lines[-1][len("SCALED-JSON:"):])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m pnp_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--drybuild", action="store_true",
                   help="build L0, run one step, print DRYBUILD-OK")
    p.add_argument("--scaled", nargs=2, type=int, metavar=("LEVELS", "N"),
                   help="run one level of the ladder, N timed steps")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    if args.drybuild:
        run_drybuild(device=args.device)
        return 0
    if args.scaled:
        out, _ = run_scaled(*args.scaled, device=args.device)
        print("SCALED-JSON:" + json.dumps(out), flush=True)
        return 0
    device = resolve_device(args.device)
    head, _ = run_headline(device=device)
    if device.type == "cuda":
        torch.cuda.empty_cache()     # the levels run in their own processes
    line = {"metric": METRIC, "value": head.pop("value"), "unit": "DOF/s",
            "vs_baseline": None, "config_overrides": {}, "case": CASE,
            "card": card_name(device), "phases": head.pop("phases"),
            **head, "scaled": []}
    print(json.dumps(line), flush=True)
    for levels, n_meas in LADDER:
        line["scaled"].append(run_level(levels, n_meas, args.device))
        print(json.dumps(line), flush=True)
    return 0


def null_or_nonfinite(obj, path="") -> list:
    """The paths in a parsed JSON value that are null or non-finite
    numbers (``vs_baseline`` is null by design and not listed)."""
    if isinstance(obj, dict):
        return [q for k, v in obj.items() if k != "vs_baseline"
                for q in null_or_nonfinite(v, f"{path}.{k}")]
    if isinstance(obj, list):
        return [q for i, v in enumerate(obj)
                for q in null_or_nonfinite(v, f"{path}[{i}]")]
    if obj is None or (isinstance(obj, float) and not math.isfinite(obj)):
        return [path]
    return []


if __name__ == "__main__":
    sys.exit(main())
