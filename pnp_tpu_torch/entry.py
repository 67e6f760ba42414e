"""The step entry point and the multi-shard dry run (the port's counterpart
of the repository's root ``__graft_entry__.py``).

    python3 -m pnp_tpu_torch.entry [--device D]
    python3 -m pnp_tpu_torch.entry --large [N] [--device D]

:func:`entry` returns the full production step (both species'
Alexander-2 stages, then the Poisson re-solve) on the bench's L0 case,
``pore_case(80, 44)`` (3,105 nodes, the dense tier), with its arguments;
the command runs it once and prints the shapes. :func:`dryrun_multichip`
runs the owner-partitioned driver with ``n`` shards, the port's
counterpart of ``n`` devices (the meaning of ``-n K`` on the command
line): the shards are a leading batch axis on the one device. It runs the
distributed phase A on L0, one fused step, one more through
``scan_steps``, and then :func:`dryrun_multichip_large` on L1 (12,097
nodes, a zero PB field), where the Poisson operator takes two-level
Schwarz. ``--large`` runs that alone, with ``N`` shards (default 8).

Every run starts from the state with Poisson solved once, as in
:mod:`.bench`: at the raw biased start the dense tier's f32 stage
inverses fail the contraction probe (on the card as on the CPU), which
raises, and the pore case diverges within six steps. The probe is never
caught here.

Each function runs on ``device``: the current CUDA device by default
(raises without one), ``"cpu"`` on request; ``base`` (the unrefined
``(nx, ny)``) lets the tests run it small.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .bench import BASE, _finite, _load
from .utils.device import resolve_device
from .workloads import distributed_pnp as TD
from .workloads.instationary_pnp_from_pb import build_pnp_system


def entry(device=None, base=BASE):
    """(fn, example_args): ``PnpSystem.fused_step`` on L0, built with a
    zero PB field (the same step; phase A is skipped), and the presolved
    start state ``(uphi, ucp, ucm)``."""
    device = resolve_device(device)
    sys_, space = _load(0, base)
    system = build_pnp_system(
        sys_, space, device=device,
        pb_field=torch.zeros(space.ndof, dtype=torch.float64))
    uphi, _ = system.poisson_solve(system.uphi0, system.ucp0, system.ucm0)
    return system.fused_step, (uphi, system.ucp0, system.ucm0)


def dryrun_multichip(n: int, device=None, base=BASE) -> dict:
    """The owner-partitioned pipeline on L0 over ``n`` shards, its
    distributed phase A included: a presolved fused step and one more
    through ``scan_steps``, both checked finite; then
    :func:`dryrun_multichip_large` on L1. Prints an OK line with the
    plan's sizes and returns them with the final state ``(uphi, uc)`` and
    the large run's result under ``"large"``."""
    device = resolve_device(device)
    sys_, space = _load(0, base)
    system = TD.build_dist_pnp_system(sys_, space, n, device=device)
    uphi, _, _ = system.poisson_solve(system.uphi0, system.uc0)
    uphi, uc = system.fused_step(uphi, system.uc0)
    if not _finite(uphi, uc):
        raise FloatingPointError("dryrun_multichip: non-finite state")
    uphi, uc = system.scan_steps((uphi, uc), 1)
    if not _finite(uphi, uc):
        raise FloatingPointError("dryrun_multichip: non-finite state")
    ctx = system.ctx
    out = {"n": n, "ndof": space.ndof, "E": space.mesh.num_tris,
           "Kb": ctx.Kb, "B_N": ctx.plan.B_N, "B_H": ctx.plan.B_H,
           "pb_newton": system.pb_newton_iterations}
    print(f"dryrun_multichip: OK on {n} shards ("
          + ", ".join(f"{k}={out[k]}" for k in list(out)[1:]) + ")",
          flush=True)
    out["state"] = (uphi, uc)
    out["large"] = dryrun_multichip_large(n, device=device, base=base)
    return out


def dryrun_multichip_large(n: int, levels: int = 1, device=None,
                           base=BASE) -> dict:
    """The owner-partitioned driver on the case refined ``levels`` times
    with a zero PB field, where the Poisson operator must take two-level
    Schwarz (above ``distributed_pnp.TWO_LEVEL_DOFS``): one presolved
    fused step, checked finite. Returns ``ndof``, the tier and the state."""
    device = resolve_device(device)
    sys_, space = _load(levels, base)
    system = TD.build_dist_pnp_system(sys_, space, n, device=device,
                                      pb_field=np.zeros(space.ndof))
    if system.poisson_tier != "two_level":
        raise RuntimeError(
            f"dryrun_multichip_large: {space.ndof} dofs took the "
            f"{system.poisson_tier!r} Poisson tier, not two-level Schwarz")
    uphi, _, _ = system.poisson_solve(system.uphi0, system.uc0)
    uphi, uc = system.fused_step(uphi, system.uc0)
    if not _finite(uphi, uc):
        raise FloatingPointError("dryrun_multichip_large: non-finite state")
    print(f"dryrun_multichip_large: OK on {n} shards (ndof={space.ndof}, "
          "two-level Schwarz Poisson)", flush=True)
    return {"n": n, "ndof": space.ndof, "poisson_tier": system.poisson_tier,
            "state": (uphi, uc)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m pnp_tpu_torch.entry",
                                description=__doc__.splitlines()[0])
    p.add_argument("--large", nargs="?", type=int, const=8, default=None,
                   metavar="N", help="run the large dry run alone on N "
                   "shards (default 8)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)
    if args.large is not None:
        dryrun_multichip_large(args.large, device=args.device)
        return 0
    fn, example_args = entry(device=args.device)
    out = fn(*example_args)
    print("entry step OK:", [tuple(o.shape) for o in out], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
