"""Command-line launcher (port of ``pnp_tpu.cli``):
``python3 -m pnp_tpu_torch [flags] CONFIG``.

Parity: reference ``bin/dune_pnp.py`` (:1-43): selects the linear-solver
variant (-s), polynomial degree (-p) and parallel width (-n), then runs a
config. There the choice picked a pre-compiled binary
(``dune_pnp_<SOLVER>_<P>``) and an ``mpirun -np N`` launch; here the same
flags are runtime config. ``-n K`` above 1 runs the production workload on
the owner-partitioned driver with K shards on the chosen device
(:func:`.workloads.distributed_pnp.run_distributed_pnp_from_pb`).

Extra flags expose the additional capability surface (workload selection,
output dir, checkpointing, profiling), and ``--device`` chooses where the
run takes place: the current CUDA device by default, ``cpu`` on request.
Without a CUDA device and without ``--device cpu`` the command fails.
"""

from __future__ import annotations

import argparse
import time

from .config import read_config, LINEAR_SOLVERS

WORKLOADS = (
    "instationary_pnp_from_pb",   # the shipped binary's workload
    "stationary_pnp",
    "stationary_pnp_from_pb",
    "instationary_pnp",
    "stationary_diffusion",
    "pb",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pnp_tpu_torch",
        description="PNP electrokinetics solver on PyTorch + CUDA "
                    "(dune-pnp capability surface)")
    p.add_argument("config", help="INI config file (reference .cfg format)")
    p.add_argument("-s", "--solver", choices=LINEAR_SOLVERS, default=None,
                   help="linear solver variant (default: config/BCGS_SSORk)")
    p.add_argument("-p", "--degree", type=int, choices=(1, 2, 3), default=None,
                   help="polynomial degree (default: config/1)")
    p.add_argument("-n", "--num-devices", type=int, default=1,
                   help="shards to partition the mesh over (the production "
                        "workload; all on the chosen device)")
    p.add_argument("-w", "--workload", choices=WORKLOADS,
                   default="instationary_pnp_from_pb")
    p.add_argument("-o", "--output-dir", default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="override nSteps from the config")
    p.add_argument("--checkpoint", default=None, help="checkpoint file path")
    p.add_argument("--checkpoint-freq", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace here, with "
                        "the program's spans, and spans.json beside it")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device; "
                        "'cpu' runs on the CPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    sys_cfg = read_config(args.config)
    if args.solver:
        sys_cfg.linearSolver = args.solver
    if args.degree:
        sys_cfg.degree = args.degree
    if args.num_devices < 1:
        raise ValueError(f"-n must be at least 1, not {args.num_devices}")

    from .fem.space import FunctionSpace
    from .meshio import read_gmsh
    from .utils.device import resolve_device
    from .utils.profiling import maybe_trace

    device = resolve_device(args.device)
    mesh = read_gmsh(sys_cfg.meshfile)
    space = FunctionSpace(mesh, sys_cfg.degree)
    print(f"[pnp_tpu_torch] mesh {sys_cfg.meshfile}: {mesh.num_nodes} nodes, "
          f"{mesh.num_tris} triangles, {mesh.num_boundary_edges} boundary "
          f"edges; P{sys_cfg.degree} -> {space.ndof} dofs/field; device "
          f"{device}")

    t0 = time.perf_counter()
    with maybe_trace(args.profile_dir):
        _run(args, sys_cfg, space, device, t0)
    print(f"[pnp_tpu_torch] total wall {time.perf_counter() - t0:.2f}s")
    return 0


def _run(args, sys_cfg, space, device, t0) -> None:
    if args.workload == "pb":
        from .workloads.pb import solve_pb
        res = solve_pb(sys_cfg, space, device=device)
        print(f"[pnp_tpu_torch] PB Newton: {res.iterations} its, defect "
              f"{res.defect:.3e} (reduction "
              f"{res.defect / res.initial_defect:.3e})")
    elif args.workload == "stationary_diffusion":
        from .workloads.stationary_diffusion import run_stationary_diffusion
        u, res = run_stationary_diffusion(sys_cfg, space,
                                          output_dir=args.output_dir,
                                          device=device)
        print(f"[pnp_tpu_torch] linear solve: {int(res.iterations)} its, "
              f"relres {float(res.relres):.3e}")
    elif args.workload in ("stationary_pnp", "stationary_pnp_from_pb"):
        from .workloads.stationary_pnp import run_stationary_pnp
        res = run_stationary_pnp(sys_cfg, space,
                                 from_pb=args.workload.endswith("from_pb"),
                                 device=device)
        print(f"[pnp_tpu_torch] PNP Newton: {res.iterations} its, converged="
              f"{res.converged}")
    elif args.workload == "instationary_pnp":
        from .workloads.instationary_pnp import run_instationary_pnp
        res = run_instationary_pnp(sys_cfg, space, n_steps=args.steps,
                                   device=device)
        print(f"[pnp_tpu_torch] explicit run: {res.steps} steps, "
              f"dt={res.dt:.3e}, t={res.time:.3e}")
    elif args.num_devices > 1:
        from .workloads.distributed_pnp import run_distributed_pnp_from_pb
        res = run_distributed_pnp_from_pb(
            sys_cfg, space, args.num_devices, n_steps=args.steps,
            output_dir=args.output_dir, checkpoint_path=args.checkpoint,
            checkpoint_freq=args.checkpoint_freq, resume=args.resume,
            device=device)
        dofs = 3 * space.ndof * res.steps
        dt = time.perf_counter() - t0
        print(f"[pnp_tpu_torch] {res.steps} steps on {res.n_shards} shards "
              f"in {dt:.2f}s ({dofs / dt:,.0f} assembled-solved DOFs/s)")
    else:
        from .workloads.instationary_pnp_from_pb import \
            run_instationary_pnp_from_pb
        res = run_instationary_pnp_from_pb(
            sys_cfg, space, n_steps=args.steps, output_dir=args.output_dir,
            checkpoint_path=args.checkpoint,
            checkpoint_freq=args.checkpoint_freq, resume=args.resume,
            device=device)
        dofs = 3 * space.ndof * res.steps
        dt = time.perf_counter() - t0
        print(f"[pnp_tpu_torch] {res.steps} steps in {dt:.2f}s "
              f"({dofs / dt:,.0f} assembled-solved DOFs/s)")


if __name__ == "__main__":
    raise SystemExit(main())
