#!/usr/bin/env python3
"""The owner-partitioned driver as P processes (the port's counterpart of
``tools/multiproc_smoke.py``, the reference binary's ``mpirun -np P``):

    python -m pnp_tpu_torch.tools.multiproc_smoke --procs 2 --backend gloo \\
        --device cpu [--out result.npz]

The launcher spawns P copies of itself with ``--worker`` (new processes,
never a fork: the parent may hold CUDA), each with torchrun's variables
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``)
for a free localhost port, and prints every worker's output prefixed
``[rank r]``. A worker that fails makes the launcher stop the others (after
GRACE_S seconds to fail on their own), write the last TAIL_LINES lines of
every rank that did not exit 0 to its standard error, and exit non-zero; so
does the ``--timeout``. Its last line gives the exit code and the seconds
from the launch to the last rank's exit.

Each worker starts the process group (``initialize_distributed``; one
``--procs 1`` rank starts a one-rank group of the backend, so that its
collectives run), takes its :class:`RankLayout` of ``--shards`` shards and
runs ``run_distributed_pnp_from_pb`` on a case built in code
(``--case one_wall|pore``, ``--nx``, ``--ny``). The coordinator writes the
global fields, the PB field, currents, iteration counts, step times, the
Poisson tier and every rank's kernel launches to the ``--out`` ``.npz``.
``--task exchange`` instead holds the exchange itself on
``rect_mesh(24, 16)``: seeded global inputs, every rank's results of the
forward and backward exchange, the element gather and scatter, the
env-element gather, the Schwarz local matrices it assembles, an SpMV and
the reduced dots, gathered to the
coordinator's ``.npz`` in shard order.

``--task sharded`` instead runs the single-device driver on element-sharded
tables (``run_instationary_pnp_from_pb(device_mesh=layout)``,
:mod:`pnp_tpu_torch.parallel.sharding`): every rank holds whole dof
vectors and K / P element shards, and each scatter ends in one
``all_reduce``. The coordinator writes the fields, currents, counts and
step times, and every rank's final fields (``rank_fields``, (P, 3, ndof)),
which replicated vectors make bitwise equal. ``--solver`` sets its linear
solver variant (default: the case's, ``BCGS_SSORk``; ``CG_AMG_SSOR`` needs
a shard count that divides the element count).

``--fail-probe-on-rank R`` makes every contraction-probe verdict on rank R
a failure (a fault injected to show that all ranks then raise together).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from pnp_tpu_torch import problems
from pnp_tpu_torch.config import LINEAR_SOLVERS
from pnp_tpu_torch.meshio.structured import rect_mesh
from pnp_tpu_torch.fem.space import FunctionSpace
from pnp_tpu_torch.operators import kernels as KN
from pnp_tpu_torch.parallel import distributed as PD
from pnp_tpu_torch.parallel.dist import build_dist_context
from pnp_tpu_torch.solvers import direct
from pnp_tpu_torch.solvers import schwarz as SW
from pnp_tpu_torch.workloads import distributed_pnp as TD
from pnp_tpu_torch.workloads.instationary_pnp_from_pb import (
    run_instationary_pnp_from_pb)

EXCHANGE_SEED = 11
#: seconds the other ranks get to fail on their own after one failed
GRACE_S = 10.0
#: lines of a failed rank's output repeated on the launcher's stderr
TAIL_LINES = 40
# the checkout's root, put on the workers' path
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl where each rank has a card")
    ap.add_argument("--device", default=None,
                    help="'cpu', or default the rank's CUDA device")
    ap.add_argument("--task", choices=("run", "exchange", "sharded"),
                    default="run")
    ap.add_argument("--case", choices=("one_wall", "pore"),
                    default="one_wall")
    ap.add_argument("--nx", type=int, default=40)
    ap.add_argument("--ny", type=int, default=4)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--presolve", action="store_true")
    ap.add_argument("--solver", choices=LINEAR_SOLVERS, default=None,
                    help="--task sharded's linear solver variant "
                    "(default: the case's)")
    ap.add_argument("--refresh", type=int, default=1,
                    help="ras_refresh_every")
    ap.add_argument("--pb-field", default=None,
                    help="an .npz whose 'pb' is the global PB field")
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-freq", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--two-level-dofs", type=int, default=None,
                    help="set distributed_pnp.TWO_LEVEL_DOFS")
    ap.add_argument("--fail-probe-on-rank", type=int, default=None)
    ap.add_argument("--out", default=None, help="the coordinator's .npz")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--port", type=int, default=0, help="0: a free one")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    return ap


# ---- the launcher ---------------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _relay(proc, rank: int, tail) -> None:
    for line in proc.stdout:
        tail.append(line)
        sys.stdout.write(f"[rank {rank}] {line}")
        sys.stdout.flush()


def launch(argv, procs: int, port: int = 0, timeout: float = 600.0) -> int:
    """Run ``argv`` (a command) as ``procs`` ranks on localhost, each with
    torchrun's variables; relay their output line by line. Returns 0 when
    every rank exits 0; else the first failing rank's code (124 at the
    timeout), after the others were given GRACE_S seconds and then
    killed."""
    port = port or free_port()
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                           if p)
    base = {**os.environ, "PYTHONPATH": path, "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port), "WORLD_SIZE": str(procs),
            "LOCAL_WORLD_SIZE": str(procs), "PYTHONUNBUFFERED": "1"}
    running = []
    tails = [collections.deque(maxlen=TAIL_LINES) for _ in range(procs)]
    for r in range(procs):
        p = subprocess.Popen(
            argv, env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        t = threading.Thread(target=_relay, args=(p, r, tails[r]),
                             daemon=True)
        t.start()
        running.append((p, t))
    t0 = time.monotonic()
    rc, failed_at, grace = 0, None, GRACE_S
    while True:
        codes = [p.poll() for p, _ in running]
        if all(c is not None for c in codes):
            break
        now = time.monotonic()
        bad = [c for c in codes if c not in (None, 0)]
        if bad and failed_at is None:
            rc, failed_at = bad[0], now
        if now - t0 > timeout and failed_at is None:
            rc, failed_at, grace = 124, now, 0.0
        if failed_at is not None and now - failed_at >= grace:
            for p, _ in running:
                if p.poll() is None:
                    p.kill()
        time.sleep(0.05)
    for p, t in running:
        p.wait()
        t.join(timeout=5)
    if rc == 0:
        rc = next((c for c in (p.returncode for p, _ in running) if c), 0)
    for r, (p, _) in enumerate(running):
        if p.returncode:
            sys.stderr.write(f"[rank {r}] exit {p.returncode}; its last "
                             f"{len(tails[r])} lines:\n" + "".join(
                                 f"[rank {r}] {line}" for line in tails[r]))
    sys.stderr.flush()
    return rc


# ---- the worker -----------------------------------------------------------

def start(args) -> PD.RankLayout:
    """Start this rank's process group from torchrun's variables and
    return its layout of ``args.shards`` shards."""
    torch.set_num_threads(1)
    if args.procs > 1:
        if not PD.initialize_distributed(backend=args.backend):
            raise RuntimeError("initialize_distributed started no group")
    else:
        PD.start_process_group(
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", 1, 0,
            PD.resolve_backend(args.backend, 1))
    return PD.global_device_mesh(args.shards, device=args.device)


def build_case(args):
    make = problems.one_wall_case if args.case == "one_wall" \
        else problems.pore_case
    return make(args.nx, args.ny)


def _fail_every_probe(A32, X):
    return torch.zeros(A32.shape[0], dtype=torch.bool, device=A32.device)


def run(args, layout, **kw):
    """This rank's part of the run: ``(result, launches by kernel)``; the
    launch counts are this rank's, reset just before the run. ``kw`` goes
    to the driver as it is."""
    sys_, space = build_case(args)
    if args.two_level_dofs is not None:
        TD.TWO_LEVEL_DOFS = args.two_level_dofs
    if args.fail_probe_on_rank == layout.rank:
        direct.contraction_verdicts = _fail_every_probe
    pb = np.load(args.pb_field)["pb"] if args.pb_field else None
    KN.reset_launch_counts()
    direct.probe_failures["count"] = 0
    res = TD.run_distributed_pnp_from_pb(
        sys_, space, layout, n_steps=args.steps, output_dir=args.output_dir,
        checkpoint_path=args.checkpoint,
        checkpoint_freq=args.checkpoint_freq, resume=args.resume,
        presolve_potential=args.presolve, pb_field=pb,
        ras_refresh_every=args.refresh, **kw)
    return res, dict(KN.launches)


def result_arrays(res, counts, layout) -> dict:
    """The run's numbers as arrays (every rank calls it: it gathers the PB
    field and every rank's launch counts)."""
    system = res.system
    names = sorted(counts)
    mine = torch.tensor([float(counts[n]) for n in names], dtype=torch.float64,
                        device=layout.device)
    launches = torch.stack(PD.gather_ranks(mine)).cpu().numpy()
    hist = res.current_history
    return dict(
        phi=res.phi, cp=res.cp, cm=res.cm, pb=system.to_global(system.pb),
        times=np.array([h[0] for h in hist]),
        ip=np.array([h[1] for h in hist]), im=np.array([h[2] for h in hist]),
        step_ms=np.array(res.step_ms),
        species_iterations=np.array(res.species_iterations),
        poisson_iterations=np.array(res.poisson_iterations),
        poisson_converged=np.array(res.poisson_converged),
        factor_rebuilt=np.array(res.factor_rebuilt),
        pb_newton_iterations=res.pb_newton_iterations,
        pb_jacobian_builds=res.pb_jacobian_builds,
        poisson_tier=system.poisson_tier, n_ranks=res.n_ranks,
        n_shards=res.n_shards, setup_seconds=res.setup_seconds,
        pb_seconds=res.pb_seconds, kernel_names=np.array(names),
        launches=launches, time=res.time)


def run_sharded(args, layout):
    """This rank's part of the single-device driver on element-sharded
    tables, its own phase A included: ``(result, launches by kernel)``,
    the counts reset just before the run."""
    sys_, space = build_case(args)
    if args.solver is not None:
        sys_ = dataclasses.replace(sys_, linearSolver=args.solver)
    KN.reset_launch_counts()
    res = run_instationary_pnp_from_pb(
        sys_, space, n_steps=args.steps, output_dir=args.output_dir,
        device_mesh=layout, presolve_potential=args.presolve)
    return res, dict(KN.launches)


def sharded_arrays(res, counts, layout) -> dict:
    """The sharded run's numbers as arrays, with every rank's final fields
    and launch counts (every rank calls it: it gathers)."""
    names = sorted(counts)
    mine = torch.tensor([float(counts[n]) for n in names], dtype=torch.float64,
                        device=layout.device)
    fields = torch.stack([res.phi, res.cp, res.cm])
    hist = res.current_history
    return dict(
        phi=res.phi.cpu().numpy(), cp=res.cp.cpu().numpy(),
        cm=res.cm.cpu().numpy(),
        rank_fields=torch.stack(PD.gather_ranks(fields)).cpu().numpy(),
        times=np.array([h[0] for h in hist]),
        ip=np.array([h[1] for h in hist]), im=np.array([h[2] for h in hist]),
        step_ms=np.array(res.step_ms),
        species_iterations=np.array(res.species_iterations),
        poisson_iterations=np.array(res.poisson_iterations),
        pb_newton_iterations=res.pb_newton_iterations,
        poisson_tier=res.system.poisson_tier, n_ranks=layout.world_size,
        n_shards=layout.n_shards, kernel_names=np.array(names),
        launches=torch.stack(PD.gather_ranks(mine)).cpu().numpy())


def exchange_case(layout):
    """The exchange check's case and its seeded global inputs (the same on
    every rank and in a caller that holds them against one process)."""
    space = FunctionSpace(rect_mesh(24, 16, 2.0, 1.0), 1)
    ctx = build_dist_context(space, layout)
    plan = ctx.plan
    rng = np.random.RandomState(EXCHANGE_SEED)
    n = ctx.n
    inputs = dict(
        x=rng.standard_normal((2, space.ndof)),
        y_halo=rng.standard_normal((2, plan.K, plan.B_H)),
        re=rng.standard_normal((2, plan.K * plan.B_E, n)),
        A_el=rng.standard_normal((space.mesh.num_tris, n, n)))
    return space, ctx, inputs


def exchange_results(ctx, inputs) -> dict:
    """This rank's results of every exchange on the seeded inputs (each
    (S, K_l, ...) or (S, K_l * B, ...)), and the reduced dots. The env
    blocks of padded env rows are zeroed: each form fills them from
    another element, and the assembly drops them (their every dof is the
    drop slot); the local matrices hold the whole env gather."""
    lay, plan = ctx.layout, ctx.plan
    dev = ctx.device
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    rows = lay.shards
    x = t(np.stack([ctx.partition(v) for v in inputs["x"]]))
    y_halo = t(inputs["y_halo"][:, rows])
    re = t(inputs["re"].reshape(2, plan.K, plan.B_E, ctx.n)[:, rows]
           .reshape(2, -1, ctx.n))
    A_el = t(ctx.partition_elem(inputs["A_el"]))
    A2 = torch.stack([A_el, 2.0 * A_el])
    xk = x.reshape(2, ctx.K_local, plan.B_N)
    dot = ctx.allreduce_sum(torch.sum(x * x, dim=-1, keepdim=True))
    free = t(np.stack([ctx.pad_mask_flat()] * 2))
    env_dofmap, _ = ctx.env_tables()
    real = (env_dofmap < plan.B_N + plan.B_H).any(dim=2)     # (K_l, B_E2)
    return dict(
        forward=ctx._forward_b(xk), backward=ctx._backward_b(y_halo),
        gather=ctx.gather_elem(x), scatter=ctx.scatter_elem(re),
        env=torch.where(real[None, :, :, None, None], ctx.env_blocks(A2),
                        0.0),
        local=SW.build_local_matrices(ctx, A2, free),
        spmv=ctx.spmv(A2, x), dot=dot)


def exchange_task(layout) -> dict:
    """Every rank's exchange results, joined in shard order (the dots: the
    coordinator's, which every rank holds)."""
    _, ctx, inputs = exchange_case(layout)
    got = exchange_results(ctx, inputs)
    out = {"dot": got.pop("dot").cpu().numpy()}
    for name, v in got.items():
        out[name] = torch.cat(PD.gather_ranks(v), dim=1).cpu().numpy()
    return out


def worker(args) -> int:
    layout = start(args)
    try:
        print(f"rank {layout.rank} of {layout.world_size} ({layout.backend}):"
              f" shards {layout.shards.start}..{layout.shards.stop - 1} of "
              f"{layout.n_shards} on {layout.device}", flush=True)
        if args.task == "exchange":
            arrays = exchange_task(layout)
        elif args.task == "sharded":
            res, counts = run_sharded(args, layout)
            arrays = sharded_arrays(res, counts, layout)
            print(f"rank {layout.rank}: {res.steps} steps on element "
                  f"shards, Poisson tier {res.system.poisson_tier}, PB "
                  f"Newton {res.pb_newton_iterations}, species its "
                  f"{res.species_iterations}, Poisson its "
                  f"{res.poisson_iterations}, step ms "
                  + " ".join(f"{t:.1f}" for t in res.step_ms)
                  + f", launches {counts}", flush=True)
        else:
            res, counts = run(args, layout)
            arrays = result_arrays(res, counts, layout)
            print(f"rank {layout.rank}: {res.steps} steps, Poisson tier "
                  f"{res.system.poisson_tier}, PB Newton "
                  f"{res.pb_newton_iterations}, species its "
                  f"{res.species_iterations}, Poisson its "
                  f"{res.poisson_iterations}, step ms "
                  + " ".join(f"{t:.1f}" for t in res.step_ms)
                  + f", launches {counts}", flush=True)
        if args.out and layout.rank == 0:
            np.savez(args.out, **arrays)
        PD.barrier(layout)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.worker:
        return worker(args)
    cmd = [sys.executable, "-m", "pnp_tpu_torch.tools.multiproc_smoke",
           "--worker", *(argv if argv is not None else sys.argv[1:])]
    t0 = time.monotonic()
    rc = launch(cmd, args.procs, args.port, args.timeout)
    print(f"multiproc_smoke: {args.procs} ranks, exit {rc} after "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
