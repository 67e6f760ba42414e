#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``pnp_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero and prints no
result line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``pnp_tpu_torch/csrc/`` (timed);
3. kernel 1 (panel-blocked Gauss-Jordan inverse) against its plain PyTorch
   version on the card: on the real (2, 4801, 4801) species stage batch of
   the full-size pore case (at the presolved potential: the batch the main
   path's first step inverts), timed beside ``torch.linalg.inv`` on the
   same tensor (``library_ms``; the port never calls it there); at the
   reference kernel's test shapes, on a row-permuted matrix, and in both
   kernel variants on orders below one panel, orders that are no multiple
   of the panel width, and a matrix whose first pivots lie in its last
   rows (far outside the first panel's diagonal block);
4. kernel 2 (fused PB element residual + Jacobian) against its plain
   version at E = 9200 in f64, in its three output variants (both, the
   residual alone, the Jacobian alone) through the prepared ``PBElement``
   the main path calls: the device time of each (profiler), the time of a
   call with the wrapper included, the share of the bound reached, and the
   floor (an empty kernel on the same grid, launched the same way);
4b. the Krylov kernels (``csrc/cg_update.cu``: ``cg_update``,
   ``cg_direction``, ``krylov_unconverged``) against the torch operations
   they replace, on the same CUDA tensors bit for bit, at 189,697 values a
   system (the AMG cell's size), one and two systems, a call timed back to
   back (``[cg kernels]``);
4c. the graphed Krylov loop (``csrc/krylov_loop.cu``) against the eager
   loop (``[graph loop]``): CG under the two-level AMG on constrained
   Laplace systems on the bench's pore mesh refined 3 times (189,697
   nodes), one system to 1e-10, two restarted every 15 to 1e-10 and the
   same cut at 40 iterations: the same count, relative residuals, bits and
   launches, and the loops, captures and iterations run that the segments
   call for;
5. the whole slice on ``pore_case(30, 17)``, CUDA against the CPU plain
   path, to 1e-9 relative;
6. the main path: ``run_instationary_pnp_from_pb`` on ``pore_case(100, 55)``
   (4,801 nodes, the dense tier at full size): PB bootstrap, then 10
   presolved steps, with every kernel launch counted, and a
   ``torch.profiler`` trace of one more step (``[dense trace]``);
7. block-RAS parity: ``pore_case(30, 17)`` forced onto the block-RAS tier,
   5 presolved steps with the factor refreshed every 4, CUDA against CPU,
   once with the mid-size Poisson inverse and once with the two-level RAS
   Poisson: iteration counts within one, fields and currents to 1e-9;
8. the block-RAS main path: ``run_instationary_pnp_from_pb`` on
   ``pore_case(160, 88)`` (12,097 nodes, 23,552 triangles), 8 presolved
   steps (two refresh windows), with every kernel launch counted;
8b. the species Krylov path: the same case with a tableau whose stage
   diagonals differ (three implicit-Euler substeps of unequal length; no
   factor serves every stage, so each stage builds its own local inverses:
   kernel 1 three times a step at (96, 369, 369)), 3 presolved steps with
   every launch counted (``[species-Krylov main]``), and the same path on
   ``pore_case(30, 17)``, CUDA against CPU, to 1e-9 with iteration counts
   within one (``[species-Krylov parity]``). ``fractional_step_theta()``
   has three stages but one stage diagonal, so it runs phase 8's factored
   path and not this one;
9. both kernels at the shapes that run gave them, on inputs built from its
   system: kernel 1 against its plain version on the (96, 369, 369)
   species RAS local batch at the presolved potential, on the (48, 369,
   369) local batch of phase A's PB Jacobian and on the (1, 12097, 12097)
   constant Poisson matrix of the mid-size tier, kernel 2's three variants
   at E = 23,552;
10. a per-phase breakdown on the run's final state (species factor,
    species stages on a reused factor, Poisson re-solve), a
    ``torch.profiler`` trace of one factor step and one reuse step
    (summarised, and written under ``chip_smoke_out/block_ras/``), and the
    two-level RAS Poisson tier on the same state against the mid-size tier;
11. the very-large Poisson tier (``[very-large main]``):
    ``run_instationary_pnp_from_pb`` on ``pore_case(320, 176)`` (47,745
    nodes, 94,208 triangles) with default thresholds, 4 presolved steps on
    one species factor: one (1, 47745, 47745) f32 inverse by kernel 1, kept
    equilibrated; the tier, 0 probe failures, a finite state, setup
    seconds, peak memory, step ms (factor and reuse apart) and refinements
    a step. The run's inverse is held by the probe against the f64 element
    operator and by ||A (X b) - b|| on a seeded b, then the two-level RAS
    Poisson re-solves the same state and the two answers agree to 1e-8.
    Then both kernels at the shapes this run gave them, as in phase 9:
    kernel 1 on the (374, 374, 374) species and (187, 374, 374) PB local
    batches, kernel 2 at E = 94,208 and, with the run freed, kernel 1 with
    ``equilibrate=False`` on the (1, 47745, 47745) equilibrated Poisson
    matrix assembled anew, against its plain version and beside
    ``torch.linalg.inv`` (one timed call of each: the kernel's time alone,
    and its share of the run's Poisson setup); ``[dist plan]``: the host
    seconds of the owner-partitioned plan's loops on this mesh at K = 8.
    Its parity
    (``[very-large parity]``): ``pore_case(30, 17)`` with the tier forced,
    CUDA against CPU to 1e-9;
10b. the owner-partitioned driver, K = 8 shards as a batch axis on the
    card (``[dist main]``): ``run_distributed_pnp_from_pb`` on
    ``pore_case(160, 88)`` with its own distributed phase A (kernel 2 at E
    = K B_E = 23,552, kernel 1 at (8, L, L) per Newton assembly, L =
    1,685), two-level Schwarz Poisson, 8 presolved steps with the species
    factor (kernel 1 at (16, L, L)) refreshed every 4, every launch
    counted; held against phase 8's single-device run (PB field to 1e-8,
    fields and currents to 2e-4 of max + 1). ``[dist parity]``: the same
    driver on the card against the CPU to 1e-9 on ``one_wall_case(40,
    4)`` (4 steps) and ``pore_case(30, 17)`` (3 presolved steps, PB field
    given). ``[dist kernels]``: kernel 1 at (16, L, L) and (8, L, L) on
    that run's Schwarz batches (equal pivot rows, 1e-4, beside
    ``torch.linalg.inv``), kernel 2 at E = 23,552 on its partitioned
    tables. ``[dist trace]``: a profiler trace of one reuse step
    (``chip_smoke_out/dist/trace_reuse/``). ``[P2]``: the production
    driver at P2 on the dense tier (``one_wall_case(64, 10)``, 2,709
    dofs), 3 presolved steps on the card against the CPU to 1e-9, kernel 2
    at n = 6 at that run's E;
10c. the same driver as processes (``[procs gloo]``): ``pore_case(160,
    88)`` as 2 ranks x 4 shards, both on the one card over gloo (launched
    by ``pnp_tpu_torch.tools.multiproc_smoke.launch``, each rank
    ``chip_smoke.py --procs-worker``): whether gloo takes CUDA tensors in
    its three collectives, then each rank's part of a distributed phase A,
    one-level Schwarz Poisson (the reference's rule under several
    processes), 8 presolved steps with the species factor refreshed every
    4, every launch counted on each rank; the exchange's and the sum's ms
    a call; a profiled reuse step of rank 0; kernel 1 on rank 0's (8, L,
    L) species and (4, L, L) PB Jacobian Schwarz batches and kernel 2 at E
    = K_l B_E = 11,776, against their plain versions; held against the
    batch-axis driver in this process forced to one level: its own phase
    A (the same PB Newton count, the PB field to 1e-8), then each of the
    ranks' steps again from the ranks' state before it (the run's
    ``record_states``), fields and currents to 1e-8 of max + 1 (the
    species only where a one-level Poisson solve stopped unconverged at
    its cap, by the runs' converged flags; at least 6 of the 8 steps held
    in full).
    ``[procs nccl]``: one rank over NCCL (every collective a copy), 2
    steps from that PB field, against the batch-axis driver, both under
    PyTorch's deterministic algorithms, to 1e-12;
10d. element sharding (``[sharded]``): ``run_instationary_pnp_from_pb``
    with ``device_mesh=8`` on ``pore_case(160, 88)``: the element tables
    in 8 shards on the card, dof vectors whole, each scatter's partials
    summed over the shard axis; no dense tier and no block-RAS on sharded
    tables, so the Poisson re-solve is BiCGSTAB under Chebyshev-Jacobi(3)
    and the species stages the species Krylov path; phase A unsharded
    (kernel 1 on the PB Jacobian's (48, 369, 369) RAS batch, kernel 2 at E
    = 23,552); 4 presolved steps, every launch counted and kernel 1's
    inputs kept as the run gave them; held against K = 1 on the card and,
    on ``pore_case(80, 44)`` (2 steps), against the CPU, to SHARD_TOL of
    max + 1; step ms, iteration counts, peak GiB and one traced step's
    busy share (``chip_smoke_out/sharded/trace_step/``); kernel 1 on the
    kept batch (equal pivot rows) and kernel 2 at E = 23,552 against
    their plain versions. ``[sharded procs]``: the same driver as 2 gloo
    ranks x 4 shards on the one card (each rank its own phase A, rank 0's
    PB field replicated; every scatter one ``all_reduce``), 2 steps: the
    ranks' final fields bitwise equal, held against one process to
    SHARD_TOL, the all-reduces a BiCGSTAB iteration and one gloo
    all-reduce's ms. ``[sharded nccl]``: one NCCL rank x 8 shards, 2
    steps, bitwise equal to one process (both under PyTorch's
    deterministic algorithms);
10e. element sharding under ``CG_AMG_SSOR`` (``[sharded amg]``): the same
    driver and case, 8 element shards of its 23,552 triangles, CG under
    the two-level aggregation AMG on both Krylov paths (the aggregations
    of the whole dof map, each coarse matrix summed from the shards'
    element blocks); phase A unsharded under the same variant (kernel 2
    alone: no RAS batch, so kernel 1 is launched no time, which is
    checked); 4 presolved steps, every launch counted, held against the
    unsharded driver on the card (the same Krylov tier above 8,192 dofs)
    and, on ``pore_case(80, 44)`` (2 steps), against the CPU, to
    SHARD_TOL of max + 1; step ms, iterations, phase A seconds, peak GiB;
    ``[sharded amg trace]``: one traced step
    (``chip_smoke_out/sharded_amg/trace_step/``); kernel 2 at E = 23,552
    against its plain version. ``[sharded amg procs]`` and ``[sharded amg
    nccl]``: ``[sharded procs]`` and ``[sharded nccl]`` under this
    variant (the all-reduces a CG iteration and around it);
12. the mid-size species tier (``[mid-species main]``): ``pore_case(160,
    88)`` with ``species_inv_threshold=16384``, 8 presolved steps, a
    refresh every 4 (kernel 1 at (2, 12097, 12097) each refresh): factor
    and reuse step ms and refinements beside phase 8's RAS numbers, the
    kind of each window; its parity on ``pore_case(30, 17)``; and kernel 1
    on the (2, 12097, 12097) stage batch at the final potential against
    its plain version and beside ``torch.linalg.inv``;
13. the other workloads (``[workloads]``) at full width: stationary
    diffusion on a one-wall ``rect_mesh(320, 32)`` (10,593 nodes) and on
    ``pore_case(160, 88)``, the monolithic stationary PNP from PB on the
    one-wall case (3 x 10,593 unknowns), 20 explicit instationary steps on
    ``pore_case(160, 88)``, each on the card against the same call with
    ``device="cpu"`` to 1e-9, with kernel 2's launches counted and kernel
    2 against its plain version at the one-wall shape (planar, E =
    20,480); and ``python3 -m pnp_tpu_torch`` from a ``.msh`` and a
    ``.cfg`` of the one-wall case written to ``chip_smoke_out/cli/`` (the
    production workload on the block-RAS tier; the pore case's raw biased
    start diverges and the command line has no presolve switch), 4 steps
    on the card and with ``--device cpu``, their checkpoints against each
    other and against the library call, to 1e-9; ``CG_AMG_SSOR`` (CG under
    the two-level aggregation AMG): the diffusion solve and ``solve_pb`` on
    the one-wall case, on the card against the CPU to 1e-9.
14. the port's measurement and step entry points (``[bench]``): on the
    card, every launch counted, ``bench.run_drybuild``,
    ``bench.run_headline`` with 3 timed steps on the bench's L0
    (``pore_case(80, 44)``, 3,105 nodes, the dense tier), ``bench.run_scaled``
    on L1 (its refinement, 12,097 nodes), one call of ``entry.entry()``'s
    step, ``entry.dryrun_multichip(8)`` with its ``dryrun_multichip_large``
    on L1; each again with ``device="cpu"``, final states to 1e-9 (the
    large dry run to 1e-8: the rounding of its f32 Schwarz inverses alone
    moves it by up to 3.0e-9), the scaled level's iteration counts within
    one, no result value null or non-finite; then kernel 1 on L0's (2,
    3105, 3105) stage batch at the presolved potential, kernel 2 at E =
    5,888 and kernel 3 at E = 5,888 in the three forms the main path calls
    (:func:`spmv_checks`: the constrained Poisson operator, the constrained
    species stage pair, the shared mass product), each against its plain
    version and beside one CSR ``torch.mv`` of the same operator.

``python3 chip_smoke.py --level-kernels L`` (L >= 1) checks and times the
three kernels at the shapes the bench's level L gives them (phase 9's
checks and :func:`spmv_checks` on that level's system; L3: E = 376,832);
``python3 -m pnp_tpu_torch.bench`` runs the ladder itself.

The next-to-last line is ``{"kernels": [...]}``: per kernel its launches
in phase 6 (in phase 8 as ``launches_block_ras``, in phase 8b as
``launches_species_krylov``), the error and times measured in phases 3-4
(kernel 2: the two-output variant, the one-output variants under
``variants``), its bound on this card (``bound_ms``, the
larger of bytes once in and once out over 3.35 TB/s and operations over
the peak rate of their type; ``bound_by`` says which) and ``library_ms``;
the same keys for the block-RAS run's shapes under ``block_ras_shape``,
``block_ras_pb_shape`` and ``poisson_shape``, for the very-large run's
under ``poisson_large_shape``, ``very_large_species_shape``,
``very_large_pb_shape`` and (kernel 2) ``very_large_shape``, for the
mid-size species tier's under ``mid_species_shape`` and the one-wall
workloads' under ``workloads_shape``, for the distributed run's under
``dist_species_shape``, ``dist_pb_shape`` and (kernel 2) ``dist_shape``,
the P2 run's (kernel 2) under ``p2_shape``, rank 0 of ``[procs gloo]``'s
under ``procs_species_shape``, ``procs_pb_shape`` and (kernel 2)
``procs_shape``; ``launches_very_large``, ``launches_mid_species``,
``launches_workloads``, ``launches_dist``, ``launches_p2``,
``launches_procs_gloo`` (a list, by rank) and ``launches_procs_nccl``
count those paths' runs; ``[bench]``'s L0 shapes are under ``bench_shape``
and its launches under ``launches_bench``; ``[sharded]``'s under
``sharded_shape`` and ``launches_sharded``, with
``launches_sharded_procs`` (by rank) and ``launches_sharded_nccl``;
``[sharded amg]``'s (kernel 2) under ``sharded_amg_shape``, and its
launches under ``launches_sharded_amg`` (kernel 1: 0),
``launches_sharded_amg_procs`` and ``launches_sharded_amg_nccl``. Kernel 3's
error and times are those of ``[bench]``'s L0 Poisson operator, its three
forms under ``bench_shape``, and its launches are counted on every path
but the ranks'. The Krylov kernels' error (0: bitwise) and times are
phase 4b's, one system at the top and two under ``pair_shape``, and their
launches are counted on every path as ``launches_<path>``: every path
checks the kernels it runs (``check_launched``). The last line is ``{"ok": true, "device": {...}}``.
Needs a CUDA device and ``nvcc``; writes the runs' outputs under
``chip_smoke_out/`` (gitignored).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import types

REPO = os.path.dirname(os.path.abspath(__file__))
MAIN_STEPS = 10
# the block-RAS tier at full size: 12,097 nodes, 23,552 triangles; blocks
# of 256 give K = 48 local sets of L = 369 dofs
RAS_CASE = (160, 88)
RAS_KW = dict(ras_block_size=256)
RAS_SHAPE = (12097, 23552, 48, 369)       # nodes, triangles, K, L
RAS_STEPS = 8
RAS_REFRESH = 4
PARITY_STEPS = 5
KRYLOV_STEPS = 3
# the very-large Poisson tier at full size: 47,745 nodes, 94,208 triangles
LARGE_CASE = (320, 176)
LARGE_SHAPE = (47745, 94208)
LARGE_STEPS = 4
# ||A (X b) - b|| / ||b|| of the very-large tier's f32 inverse on a seeded
# b, against the f64 element operator: one apply of an inverse that the
# 1e-10 refinement needs to contract by a few decades a pass
LARGE_RESIDUAL_TOL = 1e-3
MID_SPECIES_STEPS = 8
MID_SPECIES_THRESHOLD = 16384
# the other workloads at full width: the explicit run and the diffusion
# solve on RAS_CASE, the monolithic Newton solve (which converges on the
# one-wall case only) on a 5 x 0.5 rect_mesh of 10,593 nodes, 20,480
# triangles; the command line on that case written to a .msh
WALL_CASE = (320, 32)
WORKLOAD_STEPS = 20
# the diffusion solve's residual reduction: two solves that each stop at a
# reduction r differ by ~150 r on the pore case (measured: 1.4e-10 at 1e-12),
# so SLICE_REL_TOL between the card and the CPU asks for 1e-13
DIFFUSION_REDUCTION = 1e-13
CLI_STEPS = 4
# the mid-size and two-level Poisson tiers solve to 1e-10 relative
# residual; their solutions agree to 1e-8 (the reference's cross-tier
# bound, tests/test_block_ras.py:279)
TIER_REL_TOL = 1e-8
# kernel 1 against its plain version: the same panel-blocked elimination
# and the same pivot rows, but the rank-nb sums are rounded in another
# order (fused multiply-adds, another summation order than cuBLAS); the
# bound leaves room for that difference amplified by the stage matrices'
# conditioning
GJ_REL_TOL = 1e-4
# published peaks of one H100 SXM (NVIDIA's data sheet) for the bounds: f32
# and f64 outside the tensor cores, and the memory rate
PEAK_F32, PEAK_F64, PEAK_BYTES = 67e12, 33.5e12, 3.35e12
# kernel 2 against its plain version: f64, sums over quadrature points and
# dofs in another order
PB_REL_TOL = 1e-12
# kernel 3 against its plain version: f64, each row's few products summed
# in the incidence table's order, not the scatter's
SPMV_REL_TOL = 1e-13
# the slice on the card against the CPU: index_add_ on CUDA sums with
# atomics in a varying order, and cuBLAS/the kernels sum in another order
SLICE_REL_TOL = 1e-9
# the owner-partitioned driver: K shards on the card, RAS_CASE at full
# size (B_N 1,578, B_H 107: L = 1,685), two-level Schwarz Poisson
DIST_K = 8
DIST_STEPS = 8
# the distributed run against phase 8's single-device block-RAS run of the
# same case: fields and currents within 2e-4 of max + 1, the reference's
# own stage-slack bound between its distributed and single-chip drivers
# (tests/test_dist_driver.py:139-149); the PB fields of the two phase A's
# (each Newton to newtonReduction 1e-9) to 1e-8 relative
DIST_SLACK = 2e-4
DIST_PB_TOL = 1e-8
# the rank path (``[procs gloo]``): 2 ranks x 4 shards on the one card over
# gloo, each step held against the batch-axis driver's step from the ranks'
# own state before it (one level both): fields and currents within 1e-8 of
# max + 1 (the ranks add the dots' partial sums in another order). Not two
# whole runs: at this size the one-level BiCGSTAB count has a tail (of 80
# step solves in five runs on an H100, 6 took 1,443-3,000 iterations and 3
# stopped at the 3,000 cap against 59-118 for the rest), so two runs whose
# sums differ in the last bits part wherever one solve stops at its cap
# (2.7e-4 of max + 1 in one run). Where the ranks' or the replay's
# Poisson solve of a step stopped unconverged at its cap (the run results'
# converged flags), that step's potential and currents are reported, not
# held, and its species held all the same; at least PROCS_MIN_HELD steps
# must be held in full (at that rate, 3 capped of 80, three or more
# exempted steps of 8 come about once in 50-300 runs; a fault that caps
# the ranks' Poisson solves fails);
# ``[procs nccl]``: one rank, every collective a copy, 1e-12
PROCS_RANKS = 2
PROCS_TOL = 1e-8
PROCS_MIN_HELD = DIST_STEPS - 2
NCCL_STEPS = 2
PROCS_NCCL_TOL = 1e-12
# a launch takes 70-125 s on an H100; a step whose Poisson solve runs to
# the 3,000 cap takes 45-70 s more, and seven such steps still end inside
PROCS_TIMEOUT_S = 600
# the profiled reuse step's Poisson solve stops after this many iterations
# (the run's take 58-128): one in the one-level tail (up to 3,000) gives
# the profiler 40 times the events and rank 0 minutes of work on them
# (once past the launch's limit on an H100)
PROCS_TRACE_MAXITER = 150
EXCHANGE_REPS = 20
ALLREDUCE_REPS = 50
# element sharding (``[sharded]``): the single-device driver on K element
# shards of pore_case(160, 88) (dof vectors whole, each scatter's partials
# summed), BCGS_SSORk as BiCGSTAB under Chebyshev-Jacobi(3); K = 8 held
# against K = 1 on the card, the card against the CPU (on pore_case(80,
# 44)) and the ranks against one process, each to SHARD_TOL of max + 1.
# The runs differ by the order of their sums alone, but each Poisson
# re-solve stops at a relative residual of 1e-10 after 84-190 BiCGSTAB
# iterations whose count moves by up to 14 with that order: on the CPU
# (no atomics) K = 8 and K = 1 differ by 2.9e-9 of max + 1 in phi at
# pore_case(80, 44) and by 1.6e-8 in the currents at pore_case(160, 88);
# on an H100 the ranks and one process by 3.1e-8. 1e-6 stands 30 times
# above that and far below what a scatter left unreduced or summed twice
# moves (a factor near K: order one)
SHARD_K = DIST_K
SHARD_STEPS = 4
SHARD_TOL = 1e-6
SHARD_PARITY_CASE = (80, 44)
SHARD_PARITY_STEPS = 2
SHARD_PROCS_STEPS = 2
# the kernels each solver variant's sharded path launches: under
# CG_AMG_SSOR phase A builds no RAS batch (its Newton runs CG under AMG),
# so kernel 1 has no caller there; kernel 3 serves phase A's operators on
# the whole dof map (the sharded step's SpMVs keep the shards' scatter)
PATH_KERNELS = {"BCGS_SSORk": ("gj_inverse", "pb_residual_jacobian",
                               "element_spmv", "krylov_unconverged"),
                "CG_AMG_SSOR": ("pb_residual_jacobian", "element_spmv",
                                "cg_update", "cg_direction",
                                "krylov_unconverged")}
# kernels 1-3, which the paths below launch (or, where said, must not)
STEP_KERNELS = ("gj_inverse", "pb_residual_jacobian", "element_spmv")
# a pore path under BCGS_SSORk: kernels 1-3 and the Krylov flag of every
# BiCGSTAB on the card (PB Newton's at least); CG's updates run only where
# a solve is CG, under CG_AMG_SSOR (PATH_KERNELS) and CG_Jacobi
BCGS_PATH = PATH_KERNELS["BCGS_SSORk"]
# the Krylov kernels (csrc/cg_update.cu) and the graphed loop
# (csrc/krylov_loop.cu) at the AMG cell's size: the bench's pore case
# refined 3 times, 189,697 nodes; the loop's solves (systems, restart
# period, residual reduction, iteration limit): the Poisson re-solve's CG,
# the species stages' CG restarted every 15, and that one cut inside a
# segment
CG_LEVELS = 3
CG_NODES = 189_697
CG_REPS = 200
CG_LOOP_SOLVES = ((1, 0, 1e-10, 2000), (2, 15, 1e-10, 2000),
                  (2, 15, 1e-14, 40))
# the P2 production run on the dense tier (2,709 dofs, 1,280 triangles)
P2_CASE = (64, 10)
P2_STEPS = 3
# the bench's ladder (pnp_tpu_torch/bench.py): L0 is pore_case(80, 44),
# 3,105 nodes and 5,888 triangles (the dense tier), L1 its refinement,
# 12,097 nodes (block-RAS, the mid-size Poisson inverse); the multi-shard
# dry run's shard count
BENCH_SHAPE = (3105, 5888)
BENCH_HEADLINE_MEAS = 3
BENCH_SCALED = (1, 2)                     # levels, timed steps
BENCH_SHARDS = 8
# the large dry run (L1, 8 shards, two-level Schwarz, a zero PB field): its
# Krylov solves stop at their tolerances under f32 local inverses, and the
# inverses' rounding alone moves its state by 2.3e-9 and 3.0e-9 relative
# (measured on the CPU with the plain version at two other panel widths;
# the L0 dry run moves by 0.8e-10 and 2.1e-10), so the card is held to it
# at the two Poisson tiers' bound
BENCH_DIST_LARGE_TOL = TIER_REL_TOL


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def check_launched(counts, want, path: str, none=()) -> None:
    """Each kernel of ``want`` launched on ``path``, each of ``none`` not;
    ``counts``: a count a kernel, or a list of them (one a rank)."""
    for name in (*want, *none):
        got = counts[name] if isinstance(counts[name], list) else [
            counts[name]]
        check(all((n > 0) == (name in want) for n in got),
              f"kernel {name} launched {counts[name]} times on the {path} "
              "path")


def rel_err(a, b) -> float:
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(torch, fn):
    """One call of ``fn`` on the device clock: (its result, ms)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(flop: float, peak: float, nbytes: float):
    """The least time the card could take, ms, and which resource sets it."""
    t_ops, t_bytes = 1e3 * flop / peak, 1e3 * nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def gj_bound(S: int, N: int):
    """2 N^3 f32 flop a matrix; the batch read once and written once."""
    return bound(2.0 * S * N ** 3, PEAK_F32, 8.0 * S * N * N)


def pb_bound(E: int, n: int, q: int, outputs: str = "both"):
    """Per element in f64: ue, gradphi, qw, qy in, r and A out (47 values at
    n = 3, q = 4), the shape table once; per quadrature point 6n flop of
    interpolation, ~45 for sinh, cosh and the weights, 8n for the residual
    and 8n^2 for the Jacobian. A one-output variant: its own output's bytes
    and flop alone."""
    wants_r, wants_A = outputs != "jacobian", outputs != "residual"
    values = (E * (n + 2 * q * n + 2 * q + n * wants_r + n * n * wants_A)
              + q * n)
    flop = E * q * (6.0 * n + 45.0 + 8.0 * n * wants_r + 8.0 * n * n * wants_A)
    return bound(flop, PEAK_F64, 8.0 * values)


def gj_shape_check(torch, K, contraction_ok, A, label: str, reps: int,
                   plain_reps: int, equilibrate: bool = True) -> dict:
    """Kernel 1 on the (S, N, N) f32 batch ``A``: against its plain version
    (max error, relative to the inverse's scale, within GJ_REL_TOL), the
    contraction probe, and the times of the kernel, the plain version and
    ``torch.linalg.inv`` (the library's yardstick, used nowhere in the
    port), each on this one tensor. ``equilibrate`` goes to both versions
    as the caller on the main path passes it."""
    S, N, _ = A.shape
    # seconds a call where a count of reps is 0: the checked call is the
    # timed one
    X_k, ms = timed(torch, lambda: K.gj_inverse(A, equilibrate))
    X_p, plain_ms = timed(torch, lambda: K.gj_inverse_plain(A, equilibrate))
    err = float((X_k - X_p).abs().max())
    rel = rel_err(X_k, X_p)
    ok = contraction_ok(A, X_k)
    del X_p
    X_l, lib_ms = timed(torch, lambda: torch.linalg.inv(A))
    lib_rel = rel_err(X_k, X_l)
    del X_k, X_l
    if reps:
        ms = cuda_ms(torch, lambda: K.gj_inverse(A, equilibrate), reps)
        lib_ms = cuda_ms(torch, lambda: torch.linalg.inv(A), reps)
    if plain_reps:
        plain_ms = cuda_ms(torch, lambda: K.gj_inverse_plain(A, equilibrate),
                           plain_reps)
    b_ms, b_by = gj_bound(S, N)
    print(f"[kernel gj_inverse, {label}] ({S}, {N}, {N})"
          + ("" if equilibrate else " equilibrate=False")
          + f": max abs err vs "
          f"plain {err:.3e} (rel {rel:.3e}, tol {GJ_REL_TOL:g}), "
          f"contraction_ok {ok}; kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, torch.linalg.inv {lib_ms:.3f} ms (rel diff {lib_rel:.3e}); "
          f"bound {b_ms:.4f} ms by {b_by} ({100 * b_ms / ms:.1f} % reached)",
          flush=True)
    check(ok and rel <= GJ_REL_TOL, f"gj_inverse on the {label}")
    return {"shape": [S, N, N], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "library_rel_diff": lib_rel}


PB_VARIANTS = {"both": 3, "residual": 1, "jacobian": 2}


def pb_check(torch, K, args, E_want: int) -> dict:
    """Kernel 2's three output variants against the plain version on
    ``args`` (f64), through the prepared ``PBElement`` the main path calls:
    error, the wrapper-inclusive time (CUDA events around whole calls), the
    kernel's own device time (a profiler trace of 20 calls, by the
    instance's name) and the share of its bound that reaches; beside them
    the checked ``pb_residual_jacobian`` and the floor, an empty kernel on
    the same grid launched the same way."""
    import re

    ue, tables, params = args[0], args[1:5], args[5:]
    E, n = ue.shape
    q = tables[0].shape[0]
    check(E == E_want, f"pb_residual_jacobian: E = {E}, not {E_want}")
    plan = K.PBElement(*tables, *params)
    lib = K._library()
    index, raw_stream = K._device_stream(ue.device)
    tpe, _, threads = K.PB_DESIGN
    blocks = -(-E // (threads // tpe))
    empty = lambda: lib.pb_empty_launch(blocks, threads, index, raw_stream())
    out = {}
    for name in PB_VARIANTS:
        got = plan(ue, name)
        want = K.pb_residual_jacobian_plain(*args, outputs=name)
        check(all((g is None) == (w is None) for g, w in zip(got, want)),
              f"pb_residual_jacobian {name}: wrong outputs")
        pairs = [(g, w) for g, w in zip(got, want) if w is not None]
        b_ms, b_by = pb_bound(E, n, q, name)
        out[name] = {
            "max_abs_err": max(float((g - w).abs().max()) for g, w in pairs),
            "rel_err": max(rel_err(g, w) for g, w in pairs),
            "ms": cuda_ms(torch, lambda: plan(ue, name), 200),
            "plain_ms": cuda_ms(torch, lambda: K.pb_residual_jacobian_plain(
                *args, outputs=name), 50),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    checked_ms = cuda_ms(torch, lambda: K.pb_residual_jacobian(*args), 200)
    empty_call_ms = cuda_ms(torch, empty, 200)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def traced(order):
        """Device ms a launch by instance (0: the empty kernel), from one
        profiler trace of the variants in ``order``, and the trace's
        keys."""
        with torch.profiler.profile(activities=acts) as prof:
            # the tracer can lose the kernels launched while it still asks
            # for its first activity buffer: one launch of each instance
            # and a sync first (a launch it keeps counts like the others)
            empty()
            for name in order:
                plan(ue, name)
            torch.cuda.synchronize()
            for name in order:
                for _ in range(20):
                    plan(ue, name)
                torch.cuda.synchronize()
            for _ in range(20):
                empty()
            torch.cuda.synchronize()
        device = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            m = re.search(r"pb_element_kernel<\w+, \d+, (\d+),", e.key)
            if m or "pb_empty_kernel" in e.key:
                device[int(m.group(1)) if m else 0] = (
                    e.self_device_time_total / e.count / 1e3)
        return device, sorted(e.key[:60] for e in prof.key_averages())

    # a trace that lost an instance's events (seen in one run of ten, and
    # in three traces in a row of one run: the first variant's) is taken
    # again with the variants in another order, keeping what each trace
    # saw; the kernels ran and were checked above
    device, names = {}, list(PB_VARIANTS)
    for attempt in range(3):
        seen, keys = traced(names[attempt:] + names[:attempt])
        for code, ms in seen.items():
            device.setdefault(code, ms)
        if set(device) == {0, 1, 2, 3}:
            break
        print(f"[kernel pb_residual_jacobian] E={E}: profiler trace "
              f"{attempt + 1} lacks instances, has {sorted(seen)}",
              flush=True)
    check(set(device) == {0, 1, 2, 3}, "kernel 2's instances not found in "
          f"three profiler traces: {keys}")
    for name, code in PB_VARIANTS.items():
        v = out[name]
        v["device_ms"] = device[code]
        v["bound_share"] = v["bound_ms"] / v["device_ms"]
        print(f"[kernel pb_residual_jacobian] E={E} f64 {name}: max abs err "
              f"vs plain {v['max_abs_err']:.3e} (rel {v['rel_err']:.3e}, tol "
              f"{PB_REL_TOL:g}); {v['ms']:.4f} ms a call (wrapper included), "
              f"{v['device_ms']:.4f} ms on the device (profiler), plain "
              f"{v['plain_ms']:.4f} ms; bound {v['bound_ms']:.5f} ms by "
              f"{v['bound_by']} ({100 * v['bound_share']:.1f} % reached)")
        check(v["rel_err"] <= PB_REL_TOL, f"pb_residual_jacobian {name} at "
              f"E = {E}")
    print(f"[kernel pb_residual_jacobian] E={E}: the checked function "
          f"{checked_ms:.4f} ms a call; floor: an empty kernel of {blocks} "
          f"blocks x {threads} threads {device[0]:.4f} ms on the device, "
          f"{empty_call_ms:.4f} ms a call through ctypes; no single PyTorch "
          "call computes it", flush=True)
    return {"E": E, **out["both"], "checked_ms": checked_ms,
            "empty_device_ms": device[0], "empty_call_ms": empty_call_ms,
            "variants": {k: out[k] for k in ("residual", "jacobian")}}


def spmv_csr(torch, blocks, dofmap, ndof: int, S: int, free=None):
    """The operator of ``blocks`` (S_A, E, n, n), S_A S or 1, on S systems
    as one (S ndof, S ndof) CSR matrix, block diagonal over the systems;
    with ``free`` (S, ndof) the constrained operator: the masked couplings
    explicit zeros, ones on the constrained rows' diagonal."""
    E, n = dofmap.shape
    dev = blocks.device
    rows = dofmap[None] + ndof * torch.arange(S, device=dev)[:, None, None]
    shape = (S, E, n, n)
    r = rows[:, :, :, None].expand(shape).reshape(-1)
    c = rows[:, :, None, :].expand(shape).reshape(-1)
    v = blocks.expand(shape).reshape(-1)
    if free is not None:
        f = free.reshape(-1)
        v = torch.where(f[r] & f[c], v, 0.0)
        fixed = torch.nonzero(~f)[:, 0]
        r, c = torch.cat([r, fixed]), torch.cat([c, fixed])
        v = torch.cat([v, v.new_ones(fixed.shape[0])])
    coo = torch.sparse_coo_tensor(torch.stack([r, c]), v,
                                  (S * ndof, S * ndof)).coalesce()
    return coo.to_sparse_csr()


def spmv_checks(torch, K, system, dev, tag: str = "") -> dict:
    """Kernel 3 in the three forms the main path calls, at the shapes it
    gives them on ``system``'s mesh, on blocks assembled as the workload
    assembles them at the presolved potential: the constrained Poisson
    operator (one system: the Poisson re-solve's Krylov and refinement
    applies), the constrained species stage pair (two systems, blocks and
    masks of their own: the species stages' applies) and the mass product
    (two systems, one set of blocks: the stages' history terms). Each
    against the plain version (``fem.assembly.spmv_plain``) on the same
    tensors to SPMV_REL_TOL of the output's scale, one launch an apply,
    two applies bitwise equal; device times back to back
    (``tools.spmv_sweep.device_ms``) of the kernel, the plain chain and one
    ``torch.mv`` of the same operator as a CSR matrix (``library_ms``:
    cuSPARSE, used nowhere in the port); the bound from
    ``spmv_sweep.bound_bytes``. Returns the entries by form."""
    from pnp_tpu_torch.fem import assembly as FA
    from pnp_tpu_torch.fem import constraints as C
    from pnp_tpu_torch.fem.geometry import build_volume_tables
    from pnp_tpu_torch.operators import volume as V
    from pnp_tpu_torch.operators.common import interp_grad
    from pnp_tpu_torch.timestepping.tableaux import alexander2
    from pnp_tpu_torch.tools import spmv_sweep as SS
    from pnp_tpu_torch.workloads.common import make_scalar_context

    sys_r, space = system.sys, system.space
    ndof, pi = space.ndof, sys_r.pi
    uphi1, _ = system.poisson_solve(system.uphi0, system.ucp0, system.ucm0)
    ctx = make_scalar_context(sys_r, space, component=0, quad_order=3,
                              device=dev)
    vt2 = build_volume_tables(space, max(2, 2 * space.degree), dev)
    vt5 = build_volume_tables(space, max(5, 2 * space.degree + 1), dev)
    free_pair = torch.stack([
        torch.as_tensor(C.free_dof_mask(space, sys_r, c), device=dev)
        for c in (1, 2)])
    tab = alexander2()
    a01, b01 = float(tab.A[0][1]), float(tab.B[0][1])
    gphi = interp_grad(uphi1[vt2.dofmap], vt2.gradphi)
    K_pair = torch.stack([V.drift_diffusion_jacobian_el(gphi, vt2, z, False,
                                                        pi)
                          for z in (1.0, -1.0)])
    M_el = V.mass_jacobian_el(vt5, 1.0, False, pi)
    c_pair = torch.stack([system.ucp0, system.ucm0])
    forms = {
        "poisson": (V.poisson_jacobian_el(ctx.vt, sys_r.cylindrical, pi),
                    ctx.vt.dofmap, ctx.free, uphi1),
        "species_pair": (a01 * M_el[None] + (system.dt * b01) * K_pair,
                         vt2.dofmap, free_pair, c_pair),
        "mass": (M_el[None], vt2.dofmap, None, c_pair)}
    del K_pair, gphi
    out = {}
    for name, (blocks, dofmap, free, x) in forms.items():
        E, n = dofmap.shape
        S = x.shape[0] if x.ndim == 2 else 1
        S_A = blocks.shape[0] if blocks.ndim == 4 else 1
        op = FA.make_operator(blocks, dofmap, ndof, free)
        plain = lambda: FA.spmv_plain(blocks, x, dofmap, ndof, free)
        n0 = K.launches["element_spmv"]
        got = op(x)
        launches = K.launches["element_spmv"] - n0
        repeat = bool(torch.equal(got, op(x)))
        want = plain()
        err, rel = float((got - want).abs().max()), rel_err(got, want)
        csr = spmv_csr(torch, blocks if blocks.ndim == 4 else blocks[None],
                       dofmap, ndof, S,
                       None if free is None else free.reshape(S, ndof))
        xf = x.reshape(-1)
        lib = lambda: torch.mv(csr, xf)
        lib_rel = rel_err(lib().reshape(got.shape), want)
        reps = 200 if E < 100_000 else 100
        ms = SS.device_ms(lambda: op(x), reps)
        plain_ms = SS.device_ms(plain, reps)
        lib_ms = SS.device_ms(lib, reps)
        nbytes = SS.bound_bytes(S, E, n, ndof, blocks.element_size(), S_A,
                                free is not None)
        b_ms, b_by = bound(2.0 * S * E * n * n, PEAK_F64, nbytes)
        print(f"[kernel element_spmv, {tag}{name}] S = {S} (blocks of "
              f"{S_A}), E = {E}, n = {n}, {ndof} dofs: max abs err vs plain "
              f"{err:.3e} (rel {rel:.3e}, tol {SPMV_REL_TOL:g}), launches "
              f"{launches}, bitwise repeat {repeat}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, torch.mv on CSR {lib_ms:.4f} ms "
              f"(rel diff {lib_rel:.3e}); bound {b_ms:.5f} ms by {b_by} "
              f"({100 * b_ms / ms:.1f} % reached)", flush=True)
        check(rel <= SPMV_REL_TOL and launches == 1 and repeat,
              f"element_spmv {tag}{name}")
        out[name] = {"shape": [S, E, n], "systems_of_blocks": S_A,
                     "masked": free is not None, "max_abs_err": err,
                     "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "library_rel_diff": lib_rel}
        del csr
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cg_kernel_checks(torch, K, dev) -> dict:
    """Phase 4b: the Krylov kernels (``csrc/cg_update.cu``) against the
    torch operations they replace (``kernels.*_plain``), on the same CUDA
    tensors, bit for bit, at CG_NODES values a system, for one and two
    systems (a zero where a divisor is taken, the flag both ways), one
    launch a call; the time a call back to back (``cuda_ms``: at this size
    the host's call, wrapper included, sets it, not the device) beside the
    plain versions' and the bytes' bound. Returns an entry a kernel, the
    one-system shape at the top and the pair's under ``pair_shape``."""
    n = CG_NODES
    out = {name: {} for name in ("cg_update", "cg_direction",
                                 "krylov_unconverged")}
    for S in (1, 2):
        g = torch.Generator(device=dev).manual_seed(S)
        rand = lambda shape: torch.randn(shape, generator=g,
                                         dtype=torch.float64, device=dev)
        x, r, p, Ap, z = (rand((S, n)) for _ in range(5))
        pAp, rz, rz_new = (rand((S, 1)) for _ in range(3))
        pAp[0], rz[-1] = 0.0, 0.0
        want = [v.clone() for v in (x, r, p)]
        K.cg_update_plain(want[0], want[1], p, Ap, pAp, rz)
        K.cg_direction_plain(want[2], z, rz_new, rz)
        before = dict(K.launches)
        K.cg_update(x, r, p, Ap, pAp, rz)
        K.cg_direction(p, z, rz_new, rz)
        same = {"cg_update": torch.equal(x, want[0])
                and torch.equal(r, want[1]),
                "cg_direction": torch.equal(p, want[2])}
        ss = (r * r).sum(-1, keepdim=True)
        flags = []
        for scale in (0.5, 2.0):
            tol = torch.sqrt(ss) * scale
            tol[0] = torch.sqrt(ss[0])
            got = K.krylov_unconverged(ss, tol)
            flags.append(bool(got) == bool(
                K.krylov_unconverged_plain(ss, tol)) == (scale < 1 and S > 1))
        same["krylov_unconverged"] = all(flags)
        launched = {k: K.launches[k] - before[k] for k in out}
        tol = torch.sqrt(ss) * 2.0
        calls = {
            "cg_update": (lambda: K.cg_update(x, r, p, Ap, pAp, rz),
                          lambda: K.cg_update_plain(x, r, p, Ap, pAp, rz),
                          48.0, 4.0),
            "cg_direction": (lambda: K.cg_direction(p, z, rz_new, rz),
                             lambda: K.cg_direction_plain(p, z, rz_new, rz),
                             24.0, 2.0),
            "krylov_unconverged": (lambda: K.krylov_unconverged(ss, tol),
                                   lambda: K.krylov_unconverged_plain(ss, tol),
                                   16.0 / n, 2.0 / n)}
        for name, (kernel, plain, bytes_a, flop_a) in calls.items():
            ms, plain_ms = (cuda_ms(torch, fn, CG_REPS)
                            for fn in (kernel, plain))
            bound_ms, bound_by = bound(flop_a * S * n, PEAK_F64,
                                       bytes_a * S * n)
            entry = {"shape": [S, n], "max_abs_err": 0.0 if same[name]
                     else None, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}
            print(f"[cg kernels] {name} S = {S}, n = {n}: bitwise "
                  f"{same[name]}, launches {launched[name]}; kernel "
                  f"{1e3 * ms:.2f} us, torch ops {1e3 * plain_ms:.2f} us, "
                  f"bound {1e3 * bound_ms:.2f} us ({bound_by})", flush=True)
            check(same[name], f"{name} (S = {S}) against its plain version")
            check(launched[name] == (2 if name == "krylov_unconverged"
                                     else 1), f"{name} launches")
            if S == 1:
                out[name].update(entry)
            else:
                out[name]["pair_shape"] = entry
    return out


def graph_loop_check(torch, K, dev) -> None:
    """Phase 4c: the graphed Krylov loop (``csrc/krylov_loop.cu``) against
    the eager loop, at the AMG cell's size: CG under the two-level AMG on
    constrained Laplace systems (a second system at twice the operator, a
    boundary pinned on every other dof) on the bench's pore mesh refined
    CG_LEVELS times, each solve of CG_LOOP_SOLVES eager and graphed. The
    graphed solve gives the eager one's iterations, converged flag,
    relative residuals, x bit for bit and every kernel's launches; it
    records one capture, a loop for the first segment and one after each
    restart short of the last iteration, and an iteration run for each
    iteration but the first and the restarts. Prints both solves' device
    times."""
    from pnp_tpu_torch import bench as B
    from pnp_tpu_torch.fem import assembly as FA
    from pnp_tpu_torch.fem.geometry import build_volume_tables
    from pnp_tpu_torch.operators import volume as V
    from pnp_tpu_torch.solvers import amg, krylov

    _, space = B._load(CG_LEVELS)
    n = space.ndof
    check(n == CG_NODES, f"the L{CG_LEVELS} mesh has {n} nodes")
    vt = build_volume_tables(space, 2, dev)
    A = V.laplace_jacobian_el(vt)
    edge = torch.as_tensor(space.bedge_dofs, device=dev).unique()
    for S, restart, reduction, maxiter in CG_LOOP_SOLVES:
        free = torch.ones((S, n), dtype=torch.bool, device=dev)
        free[0, edge] = False
        if S > 1:
            free[1, edge[::2]] = False
        A_el = torch.stack([A, 2.0 * A][:S])
        op = FA.make_constrained_operator(A_el, vt.dofmap, n, free)
        diag = torch.where(free, FA.scatter_add_batched(torch.diagonal(
            A_el, dim1=-2, dim2=-1), vt.dofmap, n), 1.0)
        t = torch.arange(n, dtype=torch.float64, device=dev)
        b = torch.stack([torch.sin(t), torch.cos(0.5 * t)])[:S] * free
        ctx = amg.make_amg_context(vt.dofmap, n, free,
                                   dof_coords=space.dof_coords)
        M = amg.two_level_precond(A_el, ctx, diag)
        runs = {}
        for graph in (False, True):
            before, graphs = dict(K.launches), dict(krylov.graph_counts)
            res, ms = timed(torch, lambda: krylov.cg(
                op, b, torch.zeros_like(b), M, reduction, maxiter,
                restart=restart, graph=graph))
            runs[graph] = (res, ms, {k: K.launches[k] - before[k]
                                     for k in before},
                           {k: krylov.graph_counts[k] - graphs[k]
                            for k in graphs})
        (e, e_ms, e_n, _), (g, g_ms, g_n, g_c) = runs[False], runs[True]
        k = e.iterations
        want = {"captures": 1, "loops": 1 + ((k - 1) // restart if restart
                                             else 0),
                "replays": k - 1 - (k // restart if restart else 0)}
        same = (g.iterations == k and g.converged == e.converged
                and torch.equal(g.relres, e.relres) and torch.equal(g.x, e.x))
        print(f"[graph loop] CG under AMG, {S} x {n} dofs, restart "
              f"{restart}, reduction {reduction:g}, maxiter {maxiter}: {k} "
              f"its (converged {e.converged}), eager {e_ms:.1f} ms "
              f"({1e3 * e_ms / k:.1f} us an iteration), graphed loop "
              f"{g_ms:.1f} ms ({1e3 * g_ms / k:.1f} us an iteration), "
              f"{g_c}; bitwise {same}, launches equal {g_n == e_n}",
              flush=True)
        check(same, "the graphed loop against the eager loop")
        check(g_n == e_n, f"launches: graphed {g_n}, eager {e_n}")
        check(g_c == want, f"graph counts {g_c}, not {want}")
        check(e.converged == (k < maxiter) and k > restart + 1,
              "a solve stopped short of a loop after a restart")


def gj_checks(torch, K, contraction_ok, dev):
    """Kernel 1 at the reference kernel's test shapes and on a row-permuted
    matrix (tests/test_pallas.py:49-85)."""
    import numpy as np

    for S, N in ((2, 128), (2, 300), (1, 40)):
        rng = np.random.RandomState(0)
        A = (rng.rand(S, N, N).astype(np.float32) * 0.1
             + np.eye(N, dtype=np.float32)[None] * N * 0.05)
        A = torch.tensor(A, device=dev)
        X = K.gj_inverse(A)
        resid = float((A.double() @ X.double()
                       - torch.eye(N, dtype=torch.float64, device=dev))
                      .abs().max())
        err = rel_err(X, K.gj_inverse_plain(A))
        print(f"  gj_inverse ({S}, {N}): |AX-I| {resid:.3e}  "
              f"rel err vs plain {err:.3e}")
        check(resid < 5e-6 and err <= GJ_REL_TOL, f"gj_inverse ({S}, {N})")
    rng = np.random.RandomState(1)
    N = 256
    A0 = (np.eye(N, dtype=np.float32) * 8
          + rng.standard_normal((N, N)).astype(np.float32))
    P = np.eye(N, dtype=np.float32)[rng.permutation(N)]
    A = torch.tensor((P @ A0)[None], device=dev)
    X = K.gj_inverse(A)
    resid = float((X[0].double() @ A[0].double()
                   - torch.eye(N, dtype=torch.float64, device=dev))
                  .abs().max())
    err = rel_err(X, K.gj_inverse_plain(A))
    ok = contraction_ok(A, X)
    print(f"  gj_inverse permuted (1, {N}): |XA-I| {resid:.3e}  rel err vs "
          f"plain {err:.3e}  contraction_ok {ok}")
    check(bool(torch.isfinite(X).all()) and resid < 1e-2 and ok
          and err <= GJ_REL_TOL, "gj_inverse permuted case")

    # the kernel variants (0: one block a matrix, 1: the panel path, a
    # launch a column, 2: a cluster launch a panel) below one panel, off the
    # panel grid, and with the first pivots in the last rows (rows reversed:
    # column 0's pivot is row N - 1, far outside the first panel's diagonal
    # block); pivot rows equal the plain version's
    for name, S, N, variant, panel, flip in (
            ("N < panel", 2, 20, 0, 32, False),
            ("N < panel", 2, 20, 1, 64, False),
            ("N < panel", 2, 20, 2, 64, False),
            ("N mod panel", 2, 77, 0, 32, False),
            ("N mod panel", 2, 333, 1, 64, False),
            ("N mod panel", 1, 515, 1, 48, False),
            ("N mod panel", 1, 515, 2, 48, False),
            ("cross-block pivots", 2, 300, 0, 32, True),
            ("cross-block pivots", 1, 700, 1, 64, True),
            ("cross-block pivots", 1, 700, 2, 64, True)):
        rng = np.random.RandomState(N)
        A = (rng.rand(S, N, N).astype(np.float32) * 0.1
             + np.eye(N, dtype=np.float32)[None] * N * 0.05)
        A = torch.tensor(A[:, ::-1].copy() if flip else A, device=dev)
        X, perm = K._gj_core_cuda(A, panel, variant)
        Xp, perm_p = K._gj_core_plain(A, panel)
        err = rel_err(X, Xp)
        lib = rel_err(X, torch.linalg.inv(A))
        same = bool((perm.long() == perm_p).all())
        far = int(perm[0, 0])
        ok = contraction_ok(A, X)
        print(f"  gj_inverse {name} ({S}, {N}) variant {variant} panel "
              f"{panel}: rel err vs plain {err:.3e}, vs torch.linalg.inv "
              f"{lib:.3e}, pivot rows equal {same} (column 0's: {far}), "
              f"contraction_ok {ok}")
        check(ok and same and err <= GJ_REL_TOL and lib <= GJ_REL_TOL
              and (not flip or far >= panel), f"gj_inverse {name} ({S}, {N})")


def ras_parity(torch, W, pore_case, dev) -> None:
    """Phase 7: the block-RAS tier on the card against the CPU, in both
    Poisson tiers."""
    sys_s, space_s = pore_case(30, 17)
    for tier, pit in (("mid-size inverse", 49152), ("two-level RAS", 0)):
        run = lambda d: W.run_instationary_pnp_from_pb(
            sys_s, space_s, n_steps=PARITY_STEPS, presolve_potential=True,
            dense_poisson_threshold=0, ras_block_size=64,
            ras_refresh_every=RAS_REFRESH, poisson_inv_threshold=pit,
            device=d)
        g, c = run(dev), run("cpu")
        errs = {n: rel_err(getattr(g, n).cpu(), getattr(c, n))
                for n in ("phi", "cp", "cm")}
        cur = max(rel_err(torch.tensor(a), torch.tensor(b))
                  for (_, *x), (_, *y) in zip(g.current_history,
                                              c.current_history)
                  for a, b in zip(x, y))
        counts = {d: (r.species_iterations, r.poisson_iterations)
                  for d, r in (("cuda", g), ("cpu", c))}
        print(f"[block-RAS parity] pore_case(30, 17), {tier}, "
              f"{PARITY_STEPS} presolved steps, CUDA vs CPU: rel err phi "
              f"{errs['phi']:.3e} cp {errs['cp']:.3e} cm {errs['cm']:.3e} "
              f"currents {cur:.3e} (tol {SLICE_REL_TOL:g}); species its / "
              f"Poisson its per step: cuda {counts['cuda']} cpu "
              f"{counts['cpu']}", flush=True)
        check(g.system.poisson_tier == c.system.poisson_tier
              == ("inverse" if pit else "ras"), f"{tier}: Poisson tier")
        # a count may differ by one where a residual lands on its target:
        # the assembly sums with atomics on the card, so the f32 factors'
        # inputs differ in their last bits (measured: the mid-size tier's
        # 1e-10 Poisson refinement took 2 passes on the card, 3 on the CPU,
        # at one step of five)
        diffs = [abs(a - b) for xs, ys in zip(counts["cuda"], counts["cpu"])
                 for a, b in zip(xs, ys)]
        if any(diffs):
            print(f"[block-RAS parity] {tier}: iteration counts differ "
                  f"between CUDA and CPU at {sum(map(bool, diffs))} of "
                  f"{len(diffs)} solves")
        check(max(diffs) <= 1, f"{tier}: iteration counts differ by more "
              "than one between CUDA and CPU")
        check(max(*errs.values(), cur) <= SLICE_REL_TOL,
              f"block-RAS parity, {tier}")


def ras_main(torch, K, W, direct, pore_case, dev):
    """Phase 8: the block-RAS main path at full size, with every kernel
    launch counted. Returns the run's result and the launch counts."""
    nodes, tris, n_blocks, L = RAS_SHAPE
    sys_r, space_r = pore_case(*RAS_CASE)
    out_dir = os.path.join(REPO, "chip_smoke_out", "block_ras")
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    direct.probe_failures["count"] = 0
    res = W.run_instationary_pnp_from_pb(
        sys_r, space_r, n_steps=RAS_STEPS, presolve_potential=True,
        output_dir=out_dir, ras_refresh_every=RAS_REFRESH, device=dev,
        **RAS_KW)
    counts = dict(K.launches)
    failures = direct.probe_failures["count"]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    system = res.system
    ctx = system.block_context
    finite = all(tuple(v.shape) == (nodes,) and bool(torch.isfinite(v).all())
                 for v in (res.phi, res.cp, res.cm))
    with open(os.path.join(out_dir, "current.dat")) as f:
        rows = [line.split() for line in f if line.strip()]
    print(f"[block-RAS main] pore_case{RAS_CASE}: {nodes} dofs, {tris} "
          f"triangles; factor kind {system.factor_kind}, Poisson tier "
          f"{system.poisson_tier}, K {ctx.K} B {ctx.B} L {ctx.L}")
    print(f"[block-RAS main] PB Newton iterations "
          f"{res.pb_newton_iterations}, phase A {1e3 * res.pb_seconds:.1f} "
          f"ms, setup (A-C) {1e3 * res.setup_seconds:.1f} ms, Poisson "
          f"setup (f32 assembly, Gauss-Jordan inverse, probe) "
          f"{1e3 * res.poisson_setup_seconds:.1f} ms")
    for i, (ms, ks, kp, fresh) in enumerate(zip(
            res.step_ms, res.species_iterations, res.poisson_iterations,
            res.factor_rebuilt)):
        print(f"[block-RAS main] step {i} {'factor' if fresh else 'reuse'}"
              f" {ms:.2f} ms, species its {ks}, Poisson refinements {kp}")
    print(f"[block-RAS main] launches {counts}, probe failures {failures}, "
          f"peak memory {peak:.2f} GiB", flush=True)
    check((system.factor_kind, system.poisson_tier) == ("ras", "inverse")
          and (ctx.K, ctx.L) == (n_blocks, L), "block-RAS tier not taken")
    check(finite, "non-finite or misshapen final state")
    check(all(math.isfinite(v) for _, a, b in res.current_history
              for v in (*a, *b)), "non-finite currents")
    check(len(res.current_history) == RAS_STEPS and len(rows) == RAS_STEPS
          and all(len(r) == 1 + 2 * sys_r.n_surfaces for r in rows),
          "current.dat rows")
    check(res.factor_rebuilt == [i % RAS_REFRESH == 0
                                 for i in range(RAS_STEPS)],
          f"factor refresh schedule {res.factor_rebuilt}")
    check(failures == 0, f"{failures} contraction-probe failures")
    check_launched(counts, BCGS_PATH, "block-RAS")
    return res, counts


def krylov_main(torch, K, W, direct, tableau, pore_case, dev) -> dict:
    """Phase 8b: the species Krylov path at full size (every stage its own
    local inverses), with every kernel launch counted, then its parity on
    the small case, CUDA against CPU. Returns the launch counts."""
    nodes, tris, n_blocks, L = RAS_SHAPE
    sys_r, space_r = pore_case(*RAS_CASE)
    stages = tableau.stages
    K.reset_launch_counts()
    direct.probe_failures["count"] = 0
    res = W.run_instationary_pnp_from_pb(
        sys_r, space_r, n_steps=KRYLOV_STEPS, tableau=tableau,
        presolve_potential=True, device=dev, **RAS_KW)
    counts = dict(K.launches)
    failures = direct.probe_failures["count"]
    system = res.system
    ctx = system.block_context
    print(f"[species-Krylov main] pore_case{RAS_CASE}, {tableau.name} "
          f"({stages} stages, diagonals differ): {nodes} dofs; factor kind "
          f"{system.factor_kind}, Poisson tier {system.poisson_tier}, K "
          f"{ctx.K} L {ctx.L}: each stage inverts a ({2 * ctx.K}, {ctx.L}, "
          f"{ctx.L}) batch")
    print("[species-Krylov main] step ms "
          + " ".join(f"{t:.2f}" for t in res.step_ms)
          + f"; species its per step {res.species_iterations}; Poisson "
          f"refinements {res.poisson_iterations}; setup (A-C) "
          f"{1e3 * res.setup_seconds:.1f} ms")
    print(f"[species-Krylov main] launches {counts}, probe failures "
          f"{failures}", flush=True)
    check((system.factor_kind, system.poisson_tier) == (None, "inverse")
          and system.species_factor is None
          and (ctx.K, ctx.L) == (n_blocks, L), "species Krylov path not taken")
    check(all(tuple(v.shape) == (nodes,) and bool(torch.isfinite(v).all())
              for v in (res.phi, res.cp, res.cm)),
          "non-finite or misshapen final state")
    check(len(res.current_history) == KRYLOV_STEPS
          and all(math.isfinite(v) for _, a, b in res.current_history
                  for v in (*a, *b)), "currents")
    check(res.factor_rebuilt == [True] * KRYLOV_STEPS, "factor reuse on a "
          "path that has no factor")
    check(failures == 0, f"{failures} contraction-probe failures")
    # kernel 1: phase A's Jacobian factors (at most one a Newton iteration),
    # the Poisson inverse, and one launch a stage
    setup = counts["gj_inverse"] - stages * KRYLOV_STEPS
    check(1 <= setup <= 1 + res.pb_newton_iterations,
          f"gj_inverse launched {counts['gj_inverse']} times: not "
          f"{stages} a step beside the setup's")
    check(counts["pb_residual_jacobian"] > 0, "kernel 2 was not launched")
    K.reset_launch_counts()
    system.species_step(res.phi, res.cp, res.cm)
    torch.cuda.synchronize(dev)
    check(K.launches["gj_inverse"] == stages
          and K.launches["pb_residual_jacobian"] == 0
          and K.launches["element_spmv"] > 0,
          f"one species step launched {K.launches}, not kernel 1 once a "
          "stage, kernel 3 in its operators and kernel 2 never")

    sys_s, space_s = pore_case(30, 17)
    run = lambda d: W.run_instationary_pnp_from_pb(
        sys_s, space_s, n_steps=KRYLOV_STEPS, tableau=tableau,
        presolve_potential=True, dense_poisson_threshold=0,
        ras_block_size=64, device=d)
    g, c = run(dev), run("cpu")
    errs = {n: rel_err(getattr(g, n).cpu(), getattr(c, n))
            for n in ("phi", "cp", "cm")}
    cur = max(rel_err(torch.tensor(a), torch.tensor(b))
              for (_, *x), (_, *y) in zip(g.current_history,
                                          c.current_history)
              for a, b in zip(x, y))
    its = {d: (r.species_iterations, r.poisson_iterations)
           for d, r in (("cuda", g), ("cpu", c))}
    print(f"[species-Krylov parity] pore_case(30, 17), {KRYLOV_STEPS} "
          f"presolved steps, CUDA vs CPU: rel err phi {errs['phi']:.3e} cp "
          f"{errs['cp']:.3e} cm {errs['cm']:.3e} currents {cur:.3e} (tol "
          f"{SLICE_REL_TOL:g}); species its / Poisson refinements per step: "
          f"cuda {its['cuda']} cpu {its['cpu']}", flush=True)
    check(g.system.factor_kind is None and c.system.factor_kind is None,
          "species Krylov parity: a factored path was taken")
    # counts within one: atomic assembly on the card (see ras_parity)
    check(max(abs(a - b) for xs, ys in zip(its["cuda"], its["cpu"])
              for a, b in zip(xs, ys)) <= 1, "species Krylov parity: "
          "iteration counts differ by more than one")
    check(max(*errs.values(), cur) <= SLICE_REL_TOL, "species Krylov parity")
    return counts


def ras_kernel_checks(torch, K, direct, FA, V, BR, make_scalar_context,
                      system, dev, tag: str = "") -> dict:
    """Both kernels at the shapes a block-RAS run gave them, on inputs
    built from its ``system`` (phase 9: the 12,097-node run's; phase 11:
    the 47,745-node run's): kernel 1 on the (2 K, L, L) species RAS local
    batch at the presolved potential, on the (K, L, L) local batch of
    phase A's PB Jacobian at the PB field and, on the mid-size tier, on
    its (1, ndof, ndof) constant Poisson matrix (the very-large tier's is
    :func:`poisson_large_check`'s), kernel 2 at the mesh's E. Each version
    runs on the same input tensor: the assembly sums with atomics, so a
    rebuilt input could differ in its last bits."""
    sys_r, space_r = system.sys, system.space
    nodes, tris = space_r.ndof, space_r.mesh.num_tris
    bc = system.block_context
    uphi1, _ = system.poisson_solve(system.uphi0, system.ucp0, system.ucm0)
    A = system.species_local_f32(uphi1)
    check(tuple(A.shape) == (2, bc.K, bc.L, bc.L), f"RAS batch {A.shape}")
    A = A.reshape(2 * bc.K, bc.L, bc.L)
    gj = gj_shape_check(torch, K, direct.contraction_ok, A,
                        f"{tag}species RAS local batch", 5, 3)
    del A

    ctx = make_scalar_context(sys_r, space_r, component=0, quad_order=3,
                              device=dev)
    vt = ctx.vt
    args = (system.pb[vt.dofmap], vt.shape, vt.gradphi, vt.qw, vt.qy,
            sys_r.l_b, sys_r.c0, sys_r.cylindrical, sys_r.pi)
    # phase A's Newton iterations invert the PB Jacobian's local matrices
    _, J_el = K.pb_residual_jacobian_plain(*args, outputs="jacobian")
    A = BR.assemble_local_matrices(bc, J_el, ctx.free)
    check(tuple(A.shape) == (bc.K, bc.L, bc.L), f"PB local batch {A.shape}")
    gj_pb = gj_shape_check(torch, K, direct.contraction_ok, A,
                           f"{tag}PB Jacobian local batch", 5, 3)
    del A, J_el
    out = {"gj": gj, "gj_pb": gj_pb}

    if system.poisson_tier == "inverse":
        # the mid-size tier's constant Poisson matrix, assembled as the
        # workload assembles it; one timed call of the plain version (seconds)
        A_el = V.poisson_jacobian_el(vt, sys_r.cylindrical, sys_r.pi)
        P32 = FA.dense_constrained_matrix(A_el.to(torch.float32), vt.dofmap,
                                          nodes, ctx.free)[None]
        check(tuple(P32.shape) == (1, nodes, nodes), f"Poisson {P32.shape}")
        out["gj_poisson"] = gj_shape_check(
            torch, K, direct.contraction_ok, P32,
            f"{tag}constant Poisson matrix", 3, 0)
        del P32

    out["pb"] = pb_check(torch, K, args, tris)
    return out


def poisson_large_check(torch, K, W, direct, V, make_scalar_context, sys_l,
                        space_l, dev) -> dict:
    """Kernel 1 at the very-large tier's shape, (1, ndof, ndof) with
    ``equilibrate=False``, on the equilibrated Poisson matrix assembled as
    the workload assembles it: against its plain version (GJ_REL_TOL), the
    probe, and beside ``torch.linalg.inv``; one timed call of each (seconds
    each). Needs room for five matrices of that size: call it with the
    run's own inverse freed."""
    nodes = space_l.ndof
    ctx = make_scalar_context(sys_l, space_l, component=0, quad_order=3,
                              device=dev)
    A_el = V.poisson_jacobian_el(ctx.vt, sys_l.cylindrical, sys_l.pi)
    A_eq, _ = W.equilibrated_dense_f32(A_el, ctx.vt.dofmap, nodes, ctx.free)
    del A_el, ctx
    torch.cuda.empty_cache()
    free_gib = torch.cuda.mem_get_info(dev)[0] / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    entry = gj_shape_check(torch, K, direct.contraction_ok, A_eq[None],
                           "very-large Poisson matrix", 0, 0,
                           equilibrate=False)
    print(f"[kernel gj_inverse, very-large Poisson matrix] {free_gib:.1f} "
          f"GiB free before the three versions, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB in them",
          flush=True)
    return entry


def trace_summary(torch, prof, wall_s: float, label: str,
                  tag: str = "block-RAS trace") -> None:
    """Device kernel time, kernel count and the costliest kernels of one
    traced step."""
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    n = sum(e.count for e in kern)
    print(f"[{tag}] {label} step: wall {1e3 * wall_s:.2f} ms "
          f"(profiled), device kernel time {dev_ms:.2f} ms "
          f"({100 * dev_ms / (1e3 * wall_s):.1f} % busy), {n} kernels")
    for e in sorted(kern, key=lambda e: e.self_device_time_total,
                    reverse=True)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:72]}")
    sys.stdout.flush()
    return dev_ms, n


def ras_breakdown(torch, W, PhaseTimer, maybe_trace, res, dev) -> None:
    """Phase 10: the per-phase breakdown of the block-RAS step on the main
    run's final state, a profiler trace of one factor step and one reuse
    step, and the two-level RAS Poisson tier against the mid-size tier on
    the same state."""
    system = res.system
    # bench.run_scaled's form; every piece already ran in the main run,
    # so nothing is cold
    timer = PhaseTimer()
    uphi, ucp, ucm = res.phi, res.cp, res.cm
    with timer.phase("species_factor", sync=dev):
        factor = system.species_factor(uphi)
    with timer.phase("species_step_reuse", sync=dev):
        ucp2, ucm2, sp_its = system.species_step_reuse(factor, uphi, ucp,
                                                       ucm)
    with timer.phase("poisson_solve", sync=dev):
        uphi2, po_its = system.poisson_solve(uphi, ucp2, ucm2)
    fa, sp, po = (timer.ms(n) for n in ("species_factor",
                                        "species_step_reuse",
                                        "poisson_solve"))
    print(f"[block-RAS breakdown] species_factor {fa:.2f} ms, "
          f"species_step_reuse {sp:.2f} ms ({sp_its} its), poisson_solve "
          f"{po:.2f} ms ({po_its} refinements), amortized step (species + "
          f"Poisson + factor / {RAS_REFRESH}) {sp + po + fa / RAS_REFRESH:.2f}"
          " ms", flush=True)

    trace_root = os.path.join(REPO, "chip_smoke_out", "block_ras")
    for label, fresh in (("factor", True), ("reuse", False)):
        with maybe_trace(os.path.join(trace_root, f"trace_{label}")) as prof:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            f = system.species_factor(uphi) if fresh else factor
            c2 = system.species_step_reuse(f, uphi, ucp, ucm)
            system.poisson_solve(uphi, c2[0], c2[1])
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        trace_summary(torch, prof, wall, label)

    # the two-level RAS Poisson tier, PB field carried over (no phase A)
    two = W.build_pnp_system(system.sys, system.space, pb_field=system.pb,
                             poisson_inv_threshold=0, device=dev, **RAS_KW)
    check(two.poisson_tier == "ras" and two.pb_newton_iterations == 0,
          "two-level RAS Poisson system")
    two.poisson_solve(uphi, ucp2, ucm2)
    with timer.phase("poisson_solve_two_level", sync=dev):
        uphi_2l, its_2l = two.poisson_solve(uphi, ucp2, ucm2)
    tier_err = rel_err(uphi_2l, uphi2)
    print(f"[block-RAS breakdown] two-level RAS poisson_solve "
          f"{timer.ms('poisson_solve_two_level'):.2f} ms ({its_2l} "
          f"BiCGSTAB its); against the mid-size tier rel err {tier_err:.3e} "
          f"(tol {TIER_REL_TOL:g})", flush=True)
    check(tier_err <= TIER_REL_TOL, "Poisson tiers disagree")


def pivot_rows_equal(torch, K, A) -> bool:
    """Kernel 1 and its plain version pick the same pivot rows on the
    equilibrated batch that ``gj_inverse`` hands its core."""
    s = torch.rsqrt(torch.clamp_min(
        torch.diagonal(A, dim1=1, dim2=2).abs(), 1e-30))
    W = A * s[:, :, None] * s[:, None, :]
    _, perm = K._gj_core_cuda(W)
    _, perm_p = K._gj_core_plain(W)
    return bool((perm.long() == perm_p).all())


def scaled_err(a, b) -> float:
    """max |a - b| / (max |b| + 1), the reference's cross-driver measure."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1.0))


def dist_fields_err(a, b, measure) -> float:
    """Largest ``measure`` over (phi, cp, cm) and the currents of two runs
    (either may be distributed: global numpy or device tensors)."""
    import numpy as np

    host = lambda v: v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
    errs = [measure(host(getattr(a, n)), host(getattr(b, n)))
            for n in ("phi", "cp", "cm")]
    errs += [measure(host(x), host(y))
             for (_, *xs), (_, *ys) in zip(a.current_history,
                                           b.current_history)
             for x, y in zip(xs, ys)]
    return max(errs)


def dist_main(torch, K, TD, direct, pore_case, ras_res, dev):
    """``[dist main]``: the owner-partitioned driver at full size, K =
    DIST_K shards on the card: distributed phase A (kernel 2 at E = K B_E,
    kernel 1 at (K, L, L) per Newton assembly), two-level Schwarz Poisson
    (kernel 1 at (K, L, L) once), presolved, DIST_STEPS steps with the
    species factor (kernel 1 at (2K, L, L)) refreshed every RAS_REFRESH;
    held against phase 8's single-device run (``ras_res``). Returns the
    run's result and its launch counts."""
    nodes, tris = RAS_SHAPE[:2]
    sys_r, space_r = pore_case(*RAS_CASE)
    out_dir = os.path.join(REPO, "chip_smoke_out", "dist")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the Schwarz matvecs must run in IEEE f32")
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    direct.probe_failures["count"] = 0
    res = TD.run_distributed_pnp_from_pb(
        sys_r, space_r, DIST_K, n_steps=DIST_STEPS, output_dir=out_dir,
        presolve_potential=True, ras_refresh_every=RAS_REFRESH, device=dev)
    counts = dict(K.launches)
    failures = direct.probe_failures["count"]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    system = res.system
    plan = system.ctx.plan
    L = plan.B_N + plan.B_H
    print(f"[dist main] pore_case{RAS_CASE}: {nodes} dofs, {tris} "
          f"triangles, K {DIST_K} shards on one card: B_E {plan.B_E} B_N "
          f"{plan.B_N} B_H {plan.B_H} L {L} H_pair {plan.H_pair}; Poisson "
          f"tier {system.poisson_tier}")
    print(f"[dist main] phase A {res.pb_seconds:.3f} s "
          f"({res.pb_newton_iterations} Newton iterations, "
          f"{res.pb_jacobian_builds} Jacobian builds), setup (A-C and the "
          f"presolve) {res.setup_seconds:.3f} s, Poisson setup (local "
          f"inverses + the 3K-column coarse level) "
          f"{1e3 * res.poisson_setup_seconds:.1f} ms")
    for i, (ms, ks, kp, fresh) in enumerate(zip(
            res.step_ms, res.species_iterations, res.poisson_iterations,
            res.factor_rebuilt)):
        print(f"[dist main] step {i} {'factor' if fresh else 'reuse'} "
              f"{ms:.2f} ms, species BiCGSTAB its {ks}, Poisson BiCGSTAB "
              f"its {kp}")
    fa = [t for t, f in zip(res.step_ms, res.factor_rebuilt) if f]
    re_ = [t for t, f in zip(res.step_ms, res.factor_rebuilt) if not f]
    mean = lambda xs: sum(xs) / len(xs)
    print(f"[dist main] factor step mean {mean(fa):.2f} ms, reuse step mean "
          f"{mean(re_):.2f} ms; phase 8 (one device, block-RAS): factor "
          f"{mean([t for t, f in zip(ras_res.step_ms, ras_res.factor_rebuilt) if f]):.2f}"
          f" ms, reuse "
          f"{mean([t for t, f in zip(ras_res.step_ms, ras_res.factor_rebuilt) if not f]):.2f}"
          f" ms; launches {counts}, probe failures {failures}, peak memory "
          f"{peak:.2f} GiB", flush=True)
    check(system.poisson_tier == "two_level", "two-level Schwarz not taken")
    check(failures == 0, f"{failures} contraction-probe failures")
    check(res.factor_rebuilt == [i % RAS_REFRESH == 0
                                 for i in range(DIST_STEPS)],
          f"factor refresh schedule {res.factor_rebuilt}")
    check(all(v.shape == (nodes,) and bool(torch.isfinite(
        torch.from_numpy(v)).all()) for v in (res.phi, res.cp, res.cm)),
          "non-finite or misshapen final state")
    with open(os.path.join(out_dir, "current.dat")) as f:
        rows = [line.split() for line in f if line.strip()]
    check(len(rows) == DIST_STEPS and all(
        len(r) == 1 + 2 * sys_r.n_surfaces for r in rows), "current.dat rows")
    # kernel 1: one launch a PB Jacobian build, one for the Poisson local
    # inverses, one a species refresh
    want = res.pb_jacobian_builds + 1 + DIST_STEPS // RAS_REFRESH
    check(counts["gj_inverse"] == want, f"gj_inverse launched "
          f"{counts['gj_inverse']} times, not {want}")
    # the owner-partitioned driver's SpMV is its own: no kernel 3
    check_launched(counts, ("gj_inverse", "pb_residual_jacobian",
                            "krylov_unconverged"), "distributed",
                   none=("element_spmv",))
    pb_err = rel_err(torch.from_numpy(system.to_global(system.pb)),
                     ras_res.system.pb.cpu())
    slack = dist_fields_err(res, ras_res, scaled_err)
    print(f"[dist main] against phase 8's single-device run: PB field rel "
          f"err {pb_err:.3e} (tol {DIST_PB_TOL:g}); fields and currents "
          f"{slack:.3e} of max + 1 (tol {DIST_SLACK:g})", flush=True)
    check(pb_err <= DIST_PB_TOL, "distributed PB field")
    check(slack <= DIST_SLACK, "distributed run against the single-device "
          "run")
    return res, counts


def dist_parity(torch, TD, problems, solve_pb, pore_case, dev) -> None:
    """``[dist parity]``: the distributed driver on the card against
    ``device="cpu"``, K = DIST_K: the one-wall case (4 steps, its own
    phase A) and the pore case (presolved, 3 steps, the PB field given)."""
    sys_w, space_w = problems.one_wall_case(40, 4)
    sys_s, space_s = pore_case(30, 17)
    pb = solve_pb(sys_s, space_s, device="cpu").u.numpy()
    for label, run in (
            ("one_wall_case(40, 4), 4 steps", lambda d: (
                TD.run_distributed_pnp_from_pb(sys_w, space_w, DIST_K,
                                               n_steps=4, device=d))),
            ("pore_case(30, 17), 3 presolved steps, PB field given",
             lambda d: TD.run_distributed_pnp_from_pb(
                 sys_s, space_s, DIST_K, n_steps=3, presolve_potential=True,
                 pb_field=pb, device=d))):
        g, c = run(dev), run("cpu")
        err = dist_fields_err(g, c, lambda a, b: rel_err(
            torch.from_numpy(a), torch.from_numpy(b)))
        print(f"[dist parity] {label}, K {DIST_K}, CUDA vs CPU: rel err "
              f"fields and currents {err:.3e} (tol {SLICE_REL_TOL:g}); "
              f"species its cuda {g.species_iterations} cpu "
              f"{c.species_iterations}, Poisson its cuda "
              f"{g.poisson_iterations} cpu {c.poisson_iterations}",
              flush=True)
        check(err <= SLICE_REL_TOL, f"dist parity, {label}")


def dist_kernels(torch, K, SW, direct, res) -> dict:
    """``[dist kernels]``: both kernels at the shapes the distributed run
    gave them, on inputs built from its system: kernel 1 on the (2K, L,
    L) species Schwarz batch at the presolved potential and on the (K, L,
    L) Schwarz batch of phase A's PB Jacobian at the PB field (against the
    plain version, equal pivot rows, beside ``torch.linalg.inv``), kernel
    2 at E = K B_E."""
    system = res.system
    ctx = system.ctx
    sys_r = system.sys
    L = ctx.plan.B_N + ctx.plan.B_H
    uphi = system.poisson_solve(system.uphi0, system.uc0)[0]
    A = system.species_local_f32(uphi).reshape(2 * ctx.K, L, L)
    same = pivot_rows_equal(torch, K, A)
    print(f"[dist kernels] species Schwarz batch ({2 * ctx.K}, {L}, {L}): "
          f"pivot rows equal the plain version's {same}")
    check(same, "kernel 1's pivots on the species Schwarz batch")
    gj_sp = gj_shape_check(torch, K, direct.contraction_ok, A,
                           "dist species Schwarz batch", 5, 3)
    del A
    vt = system.vt_phi
    args = (ctx.gather_elem(system.pb), vt.shape, vt.gradphi, vt.qw, vt.qy,
            sys_r.l_b, sys_r.c0, sys_r.cylindrical, sys_r.pi)
    _, J_el = K.pb_residual_jacobian_plain(*args, outputs="jacobian")
    A = SW.build_local_matrices(ctx, J_el, system.free_phi).to(torch.float32)
    check(tuple(A.shape) == (ctx.K, L, L), f"PB Schwarz batch {A.shape}")
    same = pivot_rows_equal(torch, K, A)
    print(f"[dist kernels] PB Jacobian Schwarz batch ({ctx.K}, {L}, {L}): "
          f"pivot rows equal the plain version's {same}")
    check(same, "kernel 1's pivots on the PB Schwarz batch")
    gj_pb = gj_shape_check(torch, K, direct.contraction_ok, A,
                           "dist PB Jacobian Schwarz batch", 5, 3)
    del A, J_el
    pb = pb_check(torch, K, args, ctx.E_flat)
    return {"gj_species": gj_sp, "gj_pb": gj_pb, "pb": pb}


def dist_trace(torch, maybe_trace, res, dev) -> None:
    """``[dist trace]``: a ``torch.profiler`` trace of one reuse step of
    the distributed driver on its final state (species stages on a
    species factor built before the trace, then the Poisson re-solve)."""
    system = res.system
    ctx = system.ctx
    put = lambda v: torch.from_numpy(ctx.partition(v)).to(dev)
    uphi, uc = put(res.phi), torch.stack([put(res.cp), put(res.cm)])
    factor = system.species_factor(uphi)
    system.species_step_reuse(factor, uphi, uc)
    with maybe_trace(os.path.join(REPO, "chip_smoke_out", "dist",
                                  "trace_reuse")) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        uc2, k = system.species_step_reuse(factor, uphi, uc)
        kp = system.poisson_solve(uphi, uc2, PROCS_TRACE_MAXITER)[1]
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    trace_summary(torch, prof, wall, f"reuse ({k} species its, {kp} Poisson "
                  "its)", tag="dist trace")


def dist_plan_timing(space) -> None:
    """``[dist plan]``: host seconds of the owner-partitioned plan's
    Python loops (copied from the reference as they are) at DIST_K shards:
    the Morton element order, the halo plan, the env-element maps."""
    import numpy as np

    from pnp_tpu_torch.parallel import dist as D
    from pnp_tpu_torch.parallel.halo import build_halo_plan

    dm = np.asarray(space.dofmap)
    t0 = time.perf_counter()
    perm = D.locality_element_order(space.mesh)
    t1 = time.perf_counter()
    plan = build_halo_plan(dm, space.ndof, DIST_K, element_perm=perm)
    t2 = time.perf_counter()
    env_ids, _ = D._build_env_maps(plan, dm)
    t3 = time.perf_counter()
    print(f"[dist plan] {space.ndof} dofs, {space.mesh.num_tris} triangles, "
          f"K {DIST_K}: L {plan.B_N + plan.B_H} H_pair {plan.H_pair} B_E2 "
          f"{env_ids.shape[1]}; host seconds: element order {t1 - t0:.3f}, "
          f"halo plan {t2 - t1:.3f}, env maps {t3 - t2:.3f}", flush=True)


def gloo_cuda_check(torch, dist, dev, rank: int) -> None:
    """Whether gloo takes CUDA tensors in ``all_to_all_single``,
    ``all_reduce`` and ``all_gather`` (2 ranks, a few floats, the values
    checked): the rank path hands gloo its tensors where they lie."""
    f64 = dict(dtype=torch.float64, device=dev)
    sent = torch.arange(4, **f64) + 10 * rank
    got = torch.empty_like(sent)
    dist.all_to_all_single(got, sent)
    total = torch.full((3,), rank + 1.0, **f64)
    dist.all_reduce(total)
    parts = [torch.empty(2, **f64) for _ in range(2)]
    dist.all_gather(parts, torch.full((2,), float(rank), **f64))
    want = [0.0, 1.0, 10.0, 11.0] if rank == 0 else [2.0, 3.0, 12.0, 13.0]
    ok = (got.device == dev and got.tolist() == want
          and total.tolist() == [3.0] * 3
          and torch.cat(parts).tolist() == [0.0, 0.0, 1.0, 1.0])
    print(f"[procs gloo] rank {rank}: gloo takes CUDA tensors in "
          f"all_to_all_single, all_reduce and all_gather: {ok}", flush=True)
    check(ok, "gloo on CUDA tensors")


def procs_collectives(torch, PD, res, dev) -> dict:
    """Host-clock ms of one halo exchange of a (2, K_l, B_N) species pair
    and of one ``allreduce_sum`` of two f64 partial sums read back on the
    host (as a Krylov iteration reads it), both ranks in step."""
    ctx = res.system.ctx
    xk = res.system.uc0.reshape(2, ctx.K_local, ctx.plan.B_N)
    part = torch.ones((2, 1), dtype=torch.float64, device=dev)
    out = {}
    for name, reps, fn in (
            ("exchange_ms", EXCHANGE_REPS, lambda: ctx._forward_b(xk)),
            ("allreduce_ms", ALLREDUCE_REPS,
             lambda: float(ctx.allreduce_sum(part)[0, 0]))):
        fn()
        torch.cuda.synchronize(dev)
        PD.barrier(ctx.layout)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
        out[name] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def procs_trace(torch, PD, maybe_trace, res, dev) -> dict:
    """One reuse step of every rank on the run's final state (species
    stages on a factor built first, then the Poisson re-solve to at most
    PROCS_TRACE_MAXITER iterations), rank 0's under the profiler
    (``chip_smoke_out/procs/trace_reuse/``). The ranks'
    last collective work: rank 0 writes and reads its trace after it, with
    no rank waiting on it in a collective (a wait is cut at the process
    group's timeout)."""
    system = res.system
    ctx = system.ctx
    put = lambda v: torch.from_numpy(ctx.partition(v)).to(dev)
    uphi, uc = put(res.phi), torch.stack([put(res.cp), put(res.cm)])
    factor = system.species_factor(uphi)
    system.species_step_reuse(factor, uphi, uc)
    trace_dir = (os.path.join(REPO, "chip_smoke_out", "procs", "trace_reuse")
                 if PD.is_coordinator() else None)
    with maybe_trace(trace_dir) as prof:
        torch.cuda.synchronize(dev)
        PD.barrier(ctx.layout)
        t0 = time.perf_counter()
        uc2, k = system.species_step_reuse(factor, uphi, uc)
        kp = system.poisson_solve(uphi, uc2, PROCS_TRACE_MAXITER)[1]
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    if prof is None:
        return {}
    dev_ms, n = trace_summary(torch, prof, wall, f"rank 0 reuse ({k} "
                              f"species its, {kp} Poisson its)",
                              tag="procs gloo trace")
    print(f"[procs gloo trace] written and read in "
          f"{time.perf_counter() - t0 - wall:.1f} s", flush=True)
    return {"trace_wall_ms": 1e3 * wall, "trace_device_ms": dev_ms,
            "trace_kernels": n}


def procs_kernel_inputs(torch, K, SW, res):
    """Both kernels' inputs at the shapes this rank's run gave them (every
    rank builds its own: the builds exchange): the (2 K_l, L, L) species
    Schwarz batch at the presolved potential, the (K_l, L, L) Schwarz
    batch of phase A's PB Jacobian at the PB field, and kernel 2's
    arguments at E = K_l B_E."""
    system = res.system
    ctx = system.ctx
    sys_r = system.sys
    L = ctx.plan.B_N + ctx.plan.B_H
    uphi = system.poisson_solve(system.uphi0, system.uc0)[0]
    A_sp = system.species_local_f32(uphi).reshape(2 * ctx.K_local, L, L)
    vt = system.vt_phi
    args = (ctx.gather_elem(system.pb), vt.shape, vt.gradphi, vt.qw, vt.qy,
            sys_r.l_b, sys_r.c0, sys_r.cylindrical, sys_r.pi)
    _, J_el = K.pb_residual_jacobian_plain(*args, outputs="jacobian")
    A_pb = SW.build_local_matrices(ctx, J_el, system.free_phi).to(
        torch.float32)
    return A_sp, A_pb, args


def procs_kernels(torch, K, direct, A_sp, A_pb, args, E: int) -> dict:
    """Rank 0's kernel checks (alone, after the ranks parted): kernel 1 on
    its species and PB Schwarz batches (equal pivot rows, against the
    plain version, beside ``torch.linalg.inv``), kernel 2 at E = K_l B_E."""
    out = {}
    for key, A, label in (("gj_species", A_sp, "rank 0 species Schwarz "
                           "batch"), ("gj_pb", A_pb, "rank 0 PB Jacobian "
                                      "Schwarz batch")):
        same = pivot_rows_equal(torch, K, A)
        print(f"[procs kernels] {label} {tuple(A.shape)}: pivot rows equal "
              f"the plain version's {same}")
        check(same, f"kernel 1's pivots on the {label}")
        out[key] = gj_shape_check(torch, K, direct.contraction_ok, A, label,
                                  5, 3)
    out["pb"] = pb_check(torch, K, args, E)
    return out


def procs_worker(argv) -> int:
    """One rank of ``[procs gloo]`` / ``[procs nccl]`` (``chip_smoke.py
    --procs-worker`` with ``multiproc_smoke``'s flags, launched by
    :func:`procs_launch`): the run, and with ``--measure`` the gloo check
    before it and, after it, the collectives' times, a profiled reuse step
    and rank 0's kernel checks; with ``--task sharded`` (``[sharded
    procs]``, ``[sharded nccl]``) the sharded driver instead and, with
    ``--measure``, :func:`sharded_collectives`. The coordinator writes it
    all to ``--out``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from pnp_tpu_torch.operators import kernels as K
    from pnp_tpu_torch.parallel import distributed as PD
    from pnp_tpu_torch.solvers import direct
    from pnp_tpu_torch.solvers import schwarz as SW
    from pnp_tpu_torch.tools import multiproc_smoke as MS
    from pnp_tpu_torch.utils.profiling import maybe_trace

    ap = MS.parser()
    ap.add_argument("--measure", action="store_true")
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args(argv)
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    layout = MS.start(args)
    dev = layout.device
    rank = layout.rank
    extra = {}
    sharded = args.task == "sharded"
    try:
        if sharded:
            res, counts = MS.run_sharded(args, layout)
            arrays = MS.sharded_arrays(res, counts, layout)
            if args.measure:
                extra.update(sharded_collectives(torch, dist, res, layout))
            PD.barrier(layout)
        else:
            if args.measure:
                gloo_cuda_check(torch, dist, dev, rank)
            res, counts = MS.run(args, layout, record_states=True)
            arrays = MS.result_arrays(res, counts, layout)
            extra["states"] = np.array(res.states)
            if args.measure:
                extra.update(procs_collectives(torch, PD, res, dev))
                inputs = procs_kernel_inputs(torch, K, SW, res)
            PD.barrier(layout)
            if args.measure:
                extra.update(procs_trace(torch, PD, maybe_trace, res, dev))
    finally:
        dist.destroy_process_group()
    if args.measure and rank == 0 and not sharded:
        ks = procs_kernels(torch, K, direct, *inputs, res.system.ctx.E_flat)
        extra["kernels_json"] = json.dumps(ks)
    if args.out and rank == 0:
        np.savez(args.out, **arrays, **extra)
    return 0


def procs_launch(MS, name: str, procs: int, flags) -> dict:
    """``procs`` ranks of :func:`procs_worker` on the card; their
    coordinator's ``.npz`` (``chip_smoke_out/procs/<name>.npz``), loaded."""
    import numpy as np

    out = os.path.join(REPO, "chip_smoke_out", "procs", f"{name}.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    cmd = [sys.executable, os.path.abspath(__file__), "--procs-worker",
           "--procs", str(procs), "--case", "pore", "--nx",
           str(RAS_CASE[0]), "--ny", str(RAS_CASE[1]), "--shards",
           str(DIST_K), "--presolve", "--out", out, *flags]
    t0 = time.perf_counter()
    rc = MS.launch(cmd, procs, timeout=PROCS_TIMEOUT_S)
    took = f"exit {rc} after {time.perf_counter() - t0:.1f} s"
    print(f"[procs {name}] {procs} rank(s) {took}", flush=True)
    check(rc == 0, f"[procs {name}]: a rank failed ({took} of at most "
          f"{PROCS_TIMEOUT_S} s; the failed ranks' last lines are above)")
    return dict(np.load(out))


def npz_run(r):
    """A coordinator's ``.npz`` as a run result for :func:`dist_fields_err`."""
    return types.SimpleNamespace(
        phi=r["phi"], cp=r["cp"], cm=r["cm"],
        current_history=list(zip(r["times"], r["ip"], r["im"])))


def procs_gloo(torch, TD, MS, pore_case, dev):
    """``[procs gloo]``: 2 ranks x K/2 shards of ``pore_case(160, 88)``,
    both on the one card over gloo, with their own distributed phase A,
    one-level Schwarz Poisson, DIST_STEPS presolved steps with the species
    factor refreshed every RAS_REFRESH, every step's state recorded; held
    against the batch-axis driver in this process on the same case forced
    to one level: its own phase A (the same PB Newton count, the PB field
    to DIST_PB_TOL), then each step from the ranks' state before it (see
    PROCS_TOL, PROCS_MIN_HELD). Returns the coordinator's record, its kernel checks and the
    launches by rank."""
    import numpy as np

    nodes = RAS_SHAPE[0]
    r = procs_launch(MS, "gloo", PROCS_RANKS, [
        "--backend", "gloo", "--steps", str(DIST_STEPS), "--refresh",
        str(RAS_REFRESH), "--measure", "--output-dir",
        os.path.join(REPO, "chip_smoke_out", "procs", "gloo_out")])
    names = [str(n) for n in r["kernel_names"]]
    launches = {n: [int(v) for v in r["launches"][:, i]]
                for i, n in enumerate(names)}
    fresh = [bool(f) for f in r["factor_rebuilt"]]
    mean = lambda xs: sum(xs) / len(xs)
    busy = float(r["trace_device_ms"]) / float(r["trace_wall_ms"])
    ms = [float(t) for t in r["step_ms"]]
    fa = [t for t, f in zip(ms, fresh) if f]
    re_ = [t for t, f in zip(ms, fresh) if not f]
    print(f"[procs gloo] {PROCS_RANKS} ranks x {DIST_K // PROCS_RANKS} "
          f"shards: Poisson tier {r['poisson_tier']}, phase A "
          f"{float(r['pb_seconds']):.3f} s ({int(r['pb_newton_iterations'])}"
          f" Newton iterations, {int(r['pb_jacobian_builds'])} Jacobian "
          f"builds), setup {float(r['setup_seconds']):.3f} s")
    print("[procs gloo] step ms " + " ".join(
        f"{t:.1f}{'f' if f else ''}" for t, f in zip(ms, fresh))
          + f"; factor step mean {mean(fa):.1f} ms, reuse step mean "
          f"{mean(re_):.1f} ms")
    print(f"[procs gloo] species BiCGSTAB its "
          f"{r['species_iterations'].tolist()}, Poisson BiCGSTAB its "
          f"{r['poisson_iterations'].tolist()}; exchange "
          f"{float(r['exchange_ms']):.3f} ms a call, allreduce_sum "
          f"{float(r['allreduce_ms']):.3f} ms a call; rank 0's profiled "
          f"reuse step: wall {float(r['trace_wall_ms']):.1f} ms, device "
          f"{float(r['trace_device_ms']):.2f} ms ({100 * busy:.1f} % busy), "
          f"{int(r['trace_kernels'])} kernels; launches by rank "
          f"{launches}", flush=True)
    check(str(r["poisson_tier"]) == "schwarz", "one-level Schwarz not taken")
    check(int(r["n_ranks"]) == PROCS_RANKS, "ranks")
    check(fresh == [i % RAS_REFRESH == 0 for i in range(DIST_STEPS)],
          f"factor refresh schedule {fresh}")
    check(all(r[n].shape == (nodes,) and np.isfinite(r[n]).all()
              for n in ("phi", "cp", "cm")), "non-finite or misshapen final "
          "state")
    want = int(r["pb_jacobian_builds"]) + 1 + DIST_STEPS // RAS_REFRESH
    # the owner-partitioned ranks' SpMV is their own: no kernel 3
    check_launched(launches, ("gj_inverse", "pb_residual_jacobian",
                              "krylov_unconverged"), "[procs gloo] ranks'",
                   none=("element_spmv",))
    check(launches["gj_inverse"] == [want] * PROCS_RANKS,
          f"gj_inverse launched {launches['gj_inverse']} times, not {want} "
          "on each rank")
    with open(os.path.join(REPO, "chip_smoke_out", "procs", "gloo_out",
                           "current.dat")) as f:
        rows = [line.split() for line in f if line.strip()]
    check(len(rows) == DIST_STEPS, "current.dat rows")

    check(r["states"].shape == (DIST_STEPS + 1, 3, nodes),
          f"recorded states {r['states'].shape}")
    procs_replay(torch, TD, r, pore_case, dev)
    return r, json.loads(str(r["kernels_json"])), launches


def procs_replay(torch, TD, r, pore_case, dev) -> None:
    """``[procs gloo]``'s hold: the batch-axis driver (K = DIST_K, forced
    to one level) with its own phase A, then each of the ranks' steps again
    from the ranks' state before it, on the same factor schedule: species
    to PROCS_TOL of max + 1 on every step; potential and currents to
    PROCS_TOL on every step whose Poisson solves (the ranks' and the
    replay's) converged, and at least PROCS_MIN_HELD such steps."""
    from pnp_tpu_torch.postprocess.ionflux import (build_ionflux_tables,
                                                   calc_ion_flux)

    sys_r, space_r = pore_case(*RAS_CASE)
    saved = TD.TWO_LEVEL_DOFS
    TD.TWO_LEVEL_DOFS = space_r.ndof           # one level, as the ranks
    try:
        system = TD.build_dist_pnp_system(sys_r, space_r, DIST_K, device=dev)
    finally:
        TD.TWO_LEVEL_DOFS = saved
    check(system.poisson_tier == "schwarz", "the replay's tier")
    ctx = system.ctx
    put = lambda v: torch.from_numpy(ctx.partition(v)).to(dev)
    tables = build_ionflux_tables(space_r, sys_r.cylindrical, sys_r.pi,
                                  sys_r.n_surfaces, dev)
    states = r["states"]
    fields, species, kept, species_its, poisson_its = [], [], [], [], []
    for i in range(DIST_STEPS):
        uphi = put(states[i][0])
        uc = torch.stack([put(states[i][1]), put(states[i][2])])
        if i % RAS_REFRESH == 0:
            factor = system.species_factor(uphi)
        uc, k = system.species_step_reuse(factor, uphi, uc)
        uphi, kp, converged = system.poisson_solve(uphi, uc)
        species_its.append(k)
        poisson_its.append(kp)
        phi_g = system.to_global(uphi)
        c_g = system.to_global(uc)
        ip, im = calc_ion_flux(tables, *(torch.from_numpy(v).to(dev)
                                         for v in (phi_g, *c_g)))
        species.append(max(scaled_err(c_g[n], states[i + 1][1 + n])
                           for n in (0, 1)))
        fields.append(max(scaled_err(phi_g, states[i + 1][0]),
                          scaled_err(ip.cpu().numpy(), r["ip"][i]),
                          scaled_err(im.cpu().numpy(), r["im"][i])))
        kept.append(converged and bool(r["poisson_converged"][i]))
    pb_err = rel_err(torch.from_numpy(r["pb"]),
                     torch.from_numpy(system.to_global(system.pb)))
    held = [f for f, k in zip(fields, kept) if k]
    print(f"[procs gloo] held against the batch-axis driver (K {DIST_K}, "
          f"one level, in this process): PB Newton "
          f"{system.pb_newton_iterations} (ranks "
          f"{int(r['pb_newton_iterations'])}), PB field rel err "
          f"{pb_err:.3e} (tol {DIST_PB_TOL:g}); each step again from the "
          f"ranks' state: species its {species_its} (ranks "
          f"{r['species_iterations'].tolist()}), Poisson its {poisson_its} "
          f"(ranks {r['poisson_iterations'].tolist()}); species "
          f"{max(species):.3e}, potential and currents "
          + " ".join(f"{f:.1e}" + ("" if k else "*")
                     for f, k in zip(fields, kept))
          + f" of max + 1 (tol {PROCS_TOL:g}); {len(held)} of {DIST_STEPS} "
          f"steps held, {DIST_STEPS - len(held)} exempted (* a Poisson "
          f"solve stopped unconverged at its cap; at least {PROCS_MIN_HELD} "
          "held)", flush=True)
    check(system.pb_newton_iterations == int(r["pb_newton_iterations"]),
          "PB Newton iterations differ")
    check(pb_err <= DIST_PB_TOL, "[procs gloo] PB field")
    check(max(species) <= PROCS_TOL, "[procs gloo] species, step by step")
    check(len(held) >= PROCS_MIN_HELD,
          f"[procs gloo] only {len(held)} steps held: the others' Poisson "
          "solves stopped at their cap")
    check(max(held) <= PROCS_TOL,
          "[procs gloo] potential and currents, step by step")


def procs_nccl(torch, TD, MS, pore_case, dev):
    """``[procs nccl]``: one rank over NCCL (every collective a copy), K =
    DIST_K, NCCL_STEPS presolved steps from ``[procs gloo]``'s PB field,
    against the batch-axis driver in this process to PROCS_NCCL_TOL of
    max + 1. Both run with PyTorch's deterministic algorithms: otherwise
    the card's atomic scatters add in another order in every run, and two
    runs of the same driver differ near the solvers' 1e-10 tolerance.
    Returns the rank's launches."""
    import numpy as np

    pb_path = os.path.join(REPO, "chip_smoke_out", "procs", "gloo.npz")
    r = procs_launch(MS, "nccl", 1, [
        "--backend", "nccl", "--steps", str(NCCL_STEPS), "--pb-field",
        pb_path, "--deterministic"])
    sys_r, space_r = pore_case(*RAS_CASE)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = TD.run_distributed_pnp_from_pb(
            sys_r, space_r, DIST_K, n_steps=NCCL_STEPS,
            presolve_potential=True, pb_field=np.load(pb_path)["pb"],
            device=dev)
    finally:
        torch.use_deterministic_algorithms(False)
    err = dist_fields_err(npz_run(r), ref, scaled_err)
    launches = {str(n): int(v) for n, v in zip(r["kernel_names"],
                                                r["launches"][0])}
    print(f"[procs nccl] 1 rank, K {DIST_K}, Poisson tier "
          f"{r['poisson_tier']}: step ms "
          + " ".join(f"{float(t):.1f}" for t in r["step_ms"])
          + f" (batch axis: " + " ".join(f"{t:.1f}" for t in ref.step_ms)
          + f"), species its {r['species_iterations'].tolist()} "
          f"({ref.species_iterations}), Poisson its "
          f"{r['poisson_iterations'].tolist()} ({ref.poisson_iterations}); "
          f"launches {launches}; fields and currents {err:.3e} of max + 1 "
          f"(tol {PROCS_NCCL_TOL:g})", flush=True)
    check(str(r["poisson_tier"]) == ref.system.poisson_tier, "tier")
    check(launches["gj_inverse"] > 0, "kernel gj_inverse was not launched")
    check(err <= PROCS_NCCL_TOL, "[procs nccl] against the batch-axis driver")
    return launches


def sharded_main(torch, K, W, direct, make_scalar_context, maybe_trace,
                 pore_case, dev):
    """``[sharded]``: ``run_instationary_pnp_from_pb`` with ``device_mesh``
    SHARD_K on ``pore_case(160, 88)``: element tables split into SHARD_K
    shards on the card, dof vectors whole, every scatter's partials summed
    over the shard axis; phase A unsharded (kernel 2, and kernel 1 on the
    PB Jacobian's RAS batch); the Poisson re-solve BiCGSTAB under
    Chebyshev-Jacobi(3), the species stages the species Krylov path;
    SHARD_STEPS presolved steps, every launch counted and kernel 1's inputs
    kept as the run gave them. Held against K = 1 on the card and, on
    ``pore_case(80, 44)``, against the CPU, to SHARD_TOL; one traced step
    on the final state; then kernel 1 on the kept inputs and kernel 2 at E
    = 23,552 against their plain versions. Returns the kernels' entries and
    the launches."""
    sys_r, space_r = pore_case(*RAS_CASE)
    nodes, tris = space_r.ndof, space_r.mesh.num_tris
    kept, gj = {}, K.gj_inverse

    def keep(A, *a, **kw):
        kept[tuple(A.shape)] = (A.detach().clone(), a, kw)
        return gj(A, *a, **kw)

    run = lambda k, d, case=RAS_CASE, steps=SHARD_STEPS: \
        W.run_instationary_pnp_from_pb(
            *pore_case(*case), n_steps=steps, presolve_potential=True,
            device_mesh=k, device=d)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    direct.probe_failures["count"] = 0
    K.gj_inverse = keep
    try:
        res = run(SHARD_K, dev)
    finally:
        K.gj_inverse = gj
    counts = dict(K.launches)
    failures = direct.probe_failures["count"]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    one = run(1, dev)
    err = dist_fields_err(res, one, scaled_err)
    per = [scaled_err(getattr(res, n).cpu(), getattr(one, n).cpu())
           for n in ("phi", "cp", "cm")]
    print(f"[sharded] pore_case{RAS_CASE}: {nodes} dofs, {tris} triangles "
          f"in {SHARD_K} element shards on the card "
          f"({res.system.poisson_tier} Poisson tier, {sys_r.linearSolver}): "
          f"phase A {res.pb_seconds:.3f} s ({res.pb_newton_iterations} "
          f"Newton iterations), setup {res.setup_seconds:.3f} s, peak "
          f"{peak:.2f} GiB")
    print("[sharded] step ms " + " ".join(f"{t:.1f}" for t in res.step_ms)
          + f"; species BiCGSTAB its {res.species_iterations}, Poisson "
          f"BiCGSTAB its {res.poisson_iterations}; launches {counts}, probe "
          f"failures {failures}")
    print(f"[sharded] K = 1 on the card: step ms "
          + " ".join(f"{t:.1f}" for t in one.step_ms)
          + f", species its {one.species_iterations}, Poisson its "
          f"{one.poisson_iterations}; K = {SHARD_K} against it: fields and "
          f"currents {err:.3e} of max + 1 (tol {SHARD_TOL:g}; phi, cp, cm "
          + " ".join(f"{e:.1e}" for e in per) + ")", flush=True)
    check(res.system.poisson_tier == "krylov", "the sharded Poisson tier")
    check(all(tuple(v.shape) == (nodes,) and bool(torch.isfinite(v).all())
              for v in (res.phi, res.cp, res.cm)), "non-finite or misshapen "
          "final state")
    check(failures == 0, f"{failures} contraction-probe failures")
    check_launched(counts, BCGS_PATH, "sharded")
    check(err <= SHARD_TOL, "[sharded] K = 8 against K = 1")

    gpu, cpu = (run(SHARD_K, d, SHARD_PARITY_CASE, SHARD_PARITY_STEPS)
                for d in (dev, "cpu"))
    err = dist_fields_err(gpu, cpu, scaled_err)
    print(f"[sharded] pore_case{SHARD_PARITY_CASE}, K = {SHARD_K}, "
          f"{SHARD_PARITY_STEPS} steps, CUDA vs CPU: fields and currents "
          f"{err:.3e} of max + 1 (tol {SHARD_TOL:g}); Poisson its "
          f"{gpu.poisson_iterations} ({cpu.poisson_iterations})", flush=True)
    check(err <= SHARD_TOL, "[sharded] CUDA vs CPU")
    del gpu, cpu, one

    system = res.system
    with maybe_trace(os.path.join(REPO, "chip_smoke_out", "sharded",
                                  "trace_step")) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        cp, cm, k = system.species_step(res.phi, res.cp, res.cm)
        _, kp = system.poisson_solve(res.phi, cp, cm)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    trace_summary(torch, prof, wall, f"one ({k} species its, {kp} Poisson "
                  "its)", tag="sharded trace")

    check(sorted(kept) == [(RAS_SHAPE[2], RAS_SHAPE[3], RAS_SHAPE[3])],
          f"kernel 1's shapes on the sharded path {sorted(kept)}")
    A, a, kw = kept.popitem()[1]
    same = pivot_rows_equal(torch, K, A)
    print(f"[sharded kernels] PB Jacobian RAS batch {tuple(A.shape)} as the "
          f"run gave it: pivot rows equal the plain version's {same}")
    check(same and not a and not kw, "kernel 1's pivots or arguments on "
          "the sharded run's batch")
    out = {"gj": gj_shape_check(torch, K, direct.contraction_ok, A,
                                "sharded run's PB Jacobian RAS batch", 5, 3)}
    del A
    ctx = make_scalar_context(sys_r, space_r, component=0, quad_order=3,
                              device=dev)
    vt = ctx.vt
    args = (system.pb[vt.dofmap], vt.shape, vt.gradphi, vt.qw, vt.qy,
            sys_r.l_b, sys_r.c0, sys_r.cylindrical, sys_r.pi)
    out["pb"] = pb_check(torch, K, args, tris)
    return out, counts


def sharded_collectives(torch, dist, res, layout) -> dict:
    """The rank path of element sharding: the all-reduces in one Poisson
    solve (from the run's initial state: the presolve's work) and its
    BiCGSTAB iterations, and the host-clock ms of one ``all_reduce`` of a
    dof vector, both ranks in step."""
    system = res.system
    n, reduce = [0], dist.all_reduce

    def counted(*a, **kw):
        n[0] += 1
        return reduce(*a, **kw)

    dist.all_reduce = counted
    try:
        _, k = system.poisson_solve(system.uphi0, system.ucp0, system.ucm0)
    finally:
        dist.all_reduce = reduce
    v = torch.ones(system.space.ndof, dtype=torch.float64,
                   device=layout.device)
    dist.all_reduce(v)
    torch.cuda.synchronize(layout.device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(ALLREDUCE_REPS):
        dist.all_reduce(v)
    torch.cuda.synchronize(layout.device)
    return {"solve_allreduces": n[0], "solve_iterations": k,
            "allreduce_ms": 1e3 * (time.perf_counter() - t0)
            / ALLREDUCE_REPS}


#: all-reduces of one element-sharded Poisson solve outside its Krylov
#: loop, by solver variant: the residual's scatter and the operator on the
#: start vector; under CG_AMG_SSOR also the coarse matrix's sum and the
#: preconditioner on the first residual (its two smoothing SpMVs)
SOLVE_ALLREDUCES_AROUND = {"BCGS_SSORk": 2, "CG_AMG_SSOR": 5}


def sharded_procs(torch, W, MS, pore_case, dev, solver="BCGS_SSORk",
                  tag="sharded"):
    """``[sharded procs]``: the sharded driver under ``solver`` as
    PROCS_RANKS gloo ranks x SHARD_K / PROCS_RANKS shards on the one card
    (each rank its own phase A, rank 0's PB field replicated),
    SHARD_PROCS_STEPS presolved steps: the ranks' final fields bitwise
    equal, held against one process at K = SHARD_K to SHARD_TOL of max +
    1; the all-reduces a Krylov iteration and a gloo all-reduce's ms.
    ``[sharded nccl]``: one NCCL rank x SHARD_K shards, both it and the
    one-process run under PyTorch's deterministic algorithms, bitwise
    equal. ``tag`` names the phases. Returns the launches (by rank) of
    both."""
    import numpy as np

    sys_r, space_r = pore_case(*RAS_CASE)
    sys_r = dataclasses.replace(sys_r, linearSolver=solver)
    name = tag.replace(" ", "_")
    one = lambda: W.run_instationary_pnp_from_pb(
        sys_r, space_r, n_steps=SHARD_PROCS_STEPS, presolve_potential=True,
        device_mesh=SHARD_K, device=dev)
    r = procs_launch(MS, f"{name}_gloo", PROCS_RANKS, [
        "--task", "sharded", "--solver", solver, "--backend", "gloo",
        "--steps", str(SHARD_PROCS_STEPS), "--measure", "--output-dir",
        os.path.join(REPO, "chip_smoke_out", "procs", f"{name}_out")])
    ref = one()
    err = dist_fields_err(npz_run(r), ref, scaled_err)
    names = [str(n) for n in r["kernel_names"]]
    launches = {n: [int(v) for v in r["launches"][:, i]]
                for i, n in enumerate(names)}
    fields = r["rank_fields"]
    same = all(np.array_equal(fields[0], f) for f in fields[1:])
    n, k = int(r["solve_allreduces"]), int(r["solve_iterations"])
    c = SOLVE_ALLREDUCES_AROUND[solver]
    krylov = "CG" if solver.startswith("CG") else "BiCGSTAB"
    print(f"[{tag} procs] {PROCS_RANKS} gloo ranks x "
          f"{SHARD_K // PROCS_RANKS} shards ({solver}): Poisson tier "
          f"{r['poisson_tier']}, step ms "
          + " ".join(f"{float(t):.1f}" for t in r["step_ms"])
          + " (one process: " + " ".join(f"{t:.1f}" for t in ref.step_ms)
          + f"), species its {r['species_iterations'].tolist()} "
          f"({ref.species_iterations}), Poisson its "
          f"{r['poisson_iterations'].tolist()} ({ref.poisson_iterations}); "
          f"launches by rank {launches}")
    print(f"[{tag} procs] {n} all-reduces in a Poisson solve of {k} "
          f"{krylov} iterations: {(n - c) / max(k, 1):.2f} an iteration "
          f"(and {c} around the loop; the owner-partitioned ranks make 11 "
          f"collectives a BiCGSTAB iteration), a gloo all-reduce of "
          f"{space_r.ndof} f64 {float(r['allreduce_ms']):.3f} ms; the ranks' "
          f"final fields bitwise equal {same}; against one process "
          f"{err:.3e} of max + 1 (tol {SHARD_TOL:g})", flush=True)
    check(str(r["poisson_tier"]) == "krylov", f"the {tag} ranks' tier")
    check(int(r["n_ranks"]) == PROCS_RANKS, "ranks")
    check(same, f"[{tag} procs] the ranks' final fields differ")
    check_launched(launches, PATH_KERNELS[solver], f"[{tag} procs] ranks'")
    check(err <= SHARD_TOL, f"[{tag} procs] against one process")

    r2 = procs_launch(MS, f"{name}_nccl", 1, [
        "--task", "sharded", "--solver", solver, "--backend", "nccl",
        "--steps", str(SHARD_PROCS_STEPS), "--deterministic"])
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = one()
    finally:
        torch.use_deterministic_algorithms(False)
    err2 = dist_fields_err(npz_run(r2), ref, scaled_err)
    launches2 = {str(n): int(v) for n, v in zip(r2["kernel_names"],
                                                r2["launches"][0])}
    print(f"[{tag} nccl] 1 rank x {SHARD_K} shards: step ms "
          + " ".join(f"{float(t):.1f}" for t in r2["step_ms"])
          + f", Poisson its {r2['poisson_iterations'].tolist()} "
          f"({ref.poisson_iterations}); launches {launches2}; against one "
          f"process (both deterministic) {err2:.3e} (bitwise)", flush=True)
    check_launched(launches2, PATH_KERNELS[solver], "NCCL rank's")
    check(err2 == 0.0, f"[{tag} nccl] not bitwise equal to one process")
    return launches, launches2


def sharded_amg_main(torch, K, W, direct, make_scalar_context, maybe_trace,
                     pore_case, dev):
    """``[sharded amg]``: ``run_instationary_pnp_from_pb`` under
    ``CG_AMG_SSOR`` with ``device_mesh`` SHARD_K on ``pore_case(160, 88)``
    (23,552 triangles, 2,944 a shard): CG under the two-level AMG on both
    Krylov paths, the aggregations of the whole dof map, each coarse
    matrix summed from the shards' element blocks, the smoother's SpMVs
    through the sharded scatter; phase A unsharded under the same variant
    (kernel 2; no RAS batch, so no kernel 1). SHARD_STEPS presolved steps,
    every launch counted (kernel 1 none). Held against the unsharded
    driver (``device_mesh=None``, the same Krylov tier above 8,192 dofs)
    on the card and, on ``pore_case(80, 44)``, K = SHARD_K on the card
    against the CPU, to SHARD_TOL; ``[sharded amg trace]``: one traced
    step on the final state; then kernel 2 at E = 23,552 against its
    plain version. Returns kernel 2's entry and the launches."""
    def amg_case(case):
        s, sp = pore_case(*case)
        return dataclasses.replace(s, linearSolver="CG_AMG_SSOR"), sp

    sys_r, space_r = amg_case(RAS_CASE)
    nodes, tris = space_r.ndof, space_r.mesh.num_tris
    run = lambda k, d, case=RAS_CASE, steps=SHARD_STEPS: \
        W.run_instationary_pnp_from_pb(
            *amg_case(case), n_steps=steps, presolve_potential=True,
            device_mesh=k, device=d)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    direct.probe_failures["count"] = 0
    res = run(SHARD_K, dev)
    counts = dict(K.launches)
    failures = direct.probe_failures["count"]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    whole = run(None, dev)
    err = dist_fields_err(res, whole, scaled_err)
    per = [scaled_err(getattr(res, n).cpu(), getattr(whole, n).cpu())
           for n in ("phi", "cp", "cm")]
    print(f"[sharded amg] pore_case{RAS_CASE}: {nodes} dofs, {tris} "
          f"triangles in {SHARD_K} element shards on the card "
          f"({res.system.poisson_tier} Poisson tier, {sys_r.linearSolver}):"
          f" phase A {res.pb_seconds:.3f} s ({res.pb_newton_iterations} "
          f"Newton iterations), setup {res.setup_seconds:.3f} s, peak "
          f"{peak:.2f} GiB")
    print("[sharded amg] step ms " + " ".join(f"{t:.1f}" for t in
                                             res.step_ms)
          + f"; species CG its {res.species_iterations}, Poisson CG its "
          f"{res.poisson_iterations}; launches {counts}, probe failures "
          f"{failures}")
    print(f"[sharded amg] unsharded driver on the card "
          f"({whole.system.poisson_tier} tier): phase A "
          f"{whole.pb_seconds:.3f} s, step ms "
          + " ".join(f"{t:.1f}" for t in whole.step_ms)
          + f", species its {whole.species_iterations}, Poisson its "
          f"{whole.poisson_iterations}; K = {SHARD_K} against it: fields "
          f"and currents {err:.3e} of max + 1 (tol {SHARD_TOL:g}; phi, cp, "
          "cm " + " ".join(f"{e:.1e}" for e in per) + ")", flush=True)
    for r in (res, whole):
        check(r.system.poisson_tier == "krylov", "the Poisson tier")
        check(all(tuple(v.shape) == (nodes,) and bool(torch.isfinite(v).all())
                  for v in (r.phi, r.cp, r.cm)), "non-finite or misshapen "
              "final state")
    check(failures == 0, f"{failures} contraction-probe failures")
    want = PATH_KERNELS["CG_AMG_SSOR"]
    check_launched(counts, want, "sharded AMG",
                   none=[k for k in STEP_KERNELS if k not in want])
    check(err <= SHARD_TOL, "[sharded amg] K = 8 against the unsharded "
          "driver")

    gpu, cpu = (run(SHARD_K, d, SHARD_PARITY_CASE, SHARD_PARITY_STEPS)
                for d in (dev, "cpu"))
    err = dist_fields_err(gpu, cpu, scaled_err)
    print(f"[sharded amg] pore_case{SHARD_PARITY_CASE}, K = {SHARD_K}, "
          f"{SHARD_PARITY_STEPS} steps, CUDA vs CPU: fields and currents "
          f"{err:.3e} of max + 1 (tol {SHARD_TOL:g}); Poisson its "
          f"{gpu.poisson_iterations} ({cpu.poisson_iterations}), species "
          f"its {gpu.species_iterations} ({cpu.species_iterations})",
          flush=True)
    check(err <= SHARD_TOL, "[sharded amg] CUDA vs CPU")
    del gpu, cpu, whole

    system = res.system
    with maybe_trace(os.path.join(REPO, "chip_smoke_out", "sharded_amg",
                                  "trace_step")) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        cp, cm, k = system.species_step(res.phi, res.cp, res.cm)
        _, kp = system.poisson_solve(res.phi, cp, cm)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    trace_summary(torch, prof, wall, f"one ({k} species CG its, {kp} "
                  "Poisson CG its)", tag="sharded amg trace")

    ctx = make_scalar_context(sys_r, space_r, component=0, quad_order=3,
                              device=dev)
    vt = ctx.vt
    args = (system.pb[vt.dofmap], vt.shape, vt.gradphi, vt.qw, vt.qy,
            sys_r.l_b, sys_r.c0, sys_r.cylindrical, sys_r.pi)
    return {"pb": pb_check(torch, K, args, tris)}, counts


def p2_phase(torch, K, W, problems, make_scalar_context, dev):
    """The production driver at P2 on the dense tier (the general stage
    matrix: element blocks assembled densely), P2_STEPS presolved steps on
    the card against the CPU, then kernel 2 at n = 6 at this run's E
    against its plain version. Returns kernel 2's entry and the card
    run's launch counts."""
    sys_p, space_p = problems.one_wall_case(*P2_CASE, degree=2)
    K.reset_launch_counts()
    run = lambda d: W.run_instationary_pnp_from_pb(
        sys_p, space_p, n_steps=P2_STEPS, presolve_potential=True, device=d)
    g = run(dev)
    counts = dict(K.launches)
    c = run("cpu")
    err, cur = fields_rel(torch, g, c)
    print(f"[P2] one_wall_case{P2_CASE} at P2: {space_p.ndof} dofs, "
          f"{space_p.mesh.num_tris} triangles; tiers "
          f"({g.system.factor_kind}, {g.system.poisson_tier}); "
          f"{P2_STEPS} presolved steps, CUDA vs CPU: rel err fields "
          f"{err:.3e} currents {cur:.3e} (tol {SLICE_REL_TOL:g}); step ms "
          + " ".join(f"{t:.2f}" for t in g.step_ms)
          + f"; launches {counts}", flush=True)
    check((g.system.factor_kind, g.system.poisson_tier) == ("dense", "dense"),
          "P2: the dense tier not taken")
    check(max(err, cur) <= SLICE_REL_TOL, "P2 run, CUDA vs CPU")
    check_launched(counts, BCGS_PATH, "P2 run's")
    ctx = make_scalar_context(sys_p, space_p, component=0, quad_order=3,
                              device=dev)
    vt = ctx.vt
    check(vt.dofmap.shape[1] == 6, "P2 element dofs")
    entry = pb_check(torch, K, (g.system.pb[vt.dofmap], vt.shape, vt.gradphi,
                                vt.qw, vt.qy, sys_p.l_b, sys_p.c0,
                                sys_p.cylindrical, sys_p.pi),
                     space_p.mesh.num_tris)
    return entry, counts


def fields_rel(torch, a, b):
    """Largest relative error over (phi, cp, cm) and the currents of two
    runs of the production workload."""
    errs = [rel_err(getattr(a, n).cpu(), getattr(b, n).cpu())
            for n in ("phi", "cp", "cm")]
    cur = [rel_err(torch.tensor(x), torch.tensor(y))
           for (_, *xs), (_, *ys) in zip(a.current_history, b.current_history)
           for x, y in zip(xs, ys)]
    return max(errs), max(cur)


def states_rel(a, b) -> float:
    """Largest relative error over the tensors of two states (tuples of
    tensors, nested or not), the second on the CPU."""
    if isinstance(a, (tuple, list)):
        return max(states_rel(x, y) for x, y in zip(a, b))
    return rel_err(a.cpu(), b)


def bench_calls(B, EN, d) -> dict:
    """The calls of ``[bench]`` on device ``d``: each one's result (where
    it has one) and final state."""
    out = {"drybuild": B.run_drybuild(device=d)}
    out["headline_out"], out["headline"] = B.run_headline(
        BENCH_HEADLINE_MEAS, device=d)
    out["scaled_out"], out["scaled"] = B.run_scaled(*BENCH_SCALED, device=d)
    fn, args = EN.entry(device=d)
    out["entry"] = fn(*args)
    dry = EN.dryrun_multichip(BENCH_SHARDS, device=d)
    out["dryrun_out"] = dry
    out["dryrun"], out["dryrun_large"] = dry["state"], dry["large"]["state"]
    return out


def bench_phase(torch, K, W, direct, make_scalar_context, dev):
    """``[bench]``: the port's measurement and step entry points
    (``pnp_tpu_torch/bench.py``, ``pnp_tpu_torch/entry.py``) on the card,
    every launch counted: ``run_drybuild``, ``run_headline`` with
    BENCH_HEADLINE_MEAS timed steps on L0, ``run_scaled`` on L1, one call
    of ``entry()``'s step, ``dryrun_multichip`` with BENCH_SHARDS shards
    (and its ``dryrun_multichip_large`` on L1); then each again with
    ``device="cpu"``, final states to SLICE_REL_TOL (the large dry run to
    BENCH_DIST_LARGE_TOL), the scaled level's
    iteration counts within one, the dry run's plan sizes equal, and no
    value of the results null or non-finite. Then the kernels at L0's
    shapes: kernel 1 on the (2, 3105, 3105) stage batch at the presolved
    potential, kernel 2 at E = 5,888, kernel 3 in its three forms at E =
    5,888. Returns their entries and the launch counts."""
    from pnp_tpu_torch import bench as B
    from pnp_tpu_torch import entry as EN

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    direct.probe_failures["count"] = 0
    t0 = time.perf_counter()
    gpu = bench_calls(B, EN, dev)
    torch.cuda.synchronize(dev)
    counts = dict(K.launches)
    failures = direct.probe_failures["count"]
    card_s = time.perf_counter() - t0
    head, scaled = gpu["headline_out"], gpu["scaled_out"]
    dry = gpu["dryrun_out"]
    print(f"[bench] headline (L0, {BENCH_HEADLINE_MEAS} steps): "
          f"{json.dumps(head)}")
    print(f"[bench] run_scaled{BENCH_SCALED}: {json.dumps(scaled)}")
    print(f"[bench] card calls {card_s:.1f} s, launches {counts}, probe "
          f"failures {failures}", flush=True)
    check((head["nodes"], head["triangles"]) == BENCH_SHAPE
          and head["poisson_tier"] == "dense", f"headline case {head}")
    check(scaled["nodes"] == RAS_SHAPE[0]
          and scaled["poisson_tier"] == "inverse", f"scaled case {scaled}")
    bad = B.null_or_nonfinite({"headline": head, "scaled": scaled})
    check(not bad, f"null or non-finite values in the results: {bad}")
    check(failures == 0, f"{failures} contraction-probe failures")
    check_launched(counts, BCGS_PATH, "bench's")

    t0 = time.perf_counter()
    cpu = bench_calls(B, EN, "cpu")
    print(f"[bench] the same calls on the CPU {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    tols = dict.fromkeys(("drybuild", "headline", "scaled", "entry",
                          "dryrun"), SLICE_REL_TOL)
    tols["dryrun_large"] = BENCH_DIST_LARGE_TOL
    for name, tol in tols.items():
        err = states_rel(gpu[name], cpu[name])
        print(f"[bench] {name}: final state CUDA vs CPU rel err {err:.3e} "
              f"(tol {tol:g})")
        check(err <= tol, f"[bench] {name} CUDA vs CPU")
    its = [(scaled["phases"][k], cpu["scaled_out"]["phases"][k])
           for k in ("species_stage_iters", "poisson_iters")]
    print(f"[bench] scaled iterations (card, CPU): species {its[0]}, "
          f"Poisson {its[1]}")
    check(all(abs(a - b) <= 1 for a, b in its), "scaled iteration counts")
    plan = ("Kb", "B_N", "B_H", "pb_newton")
    check(all(dry[k] == cpu["dryrun_out"][k] for k in plan),
          f"dry run plans differ: {dry} {cpu['dryrun_out']}")
    del gpu, cpu

    # the kernels at L0's shapes, on inputs from L0's system
    sys0, space0 = B._load(0)
    system = W.build_pnp_system(sys0, space0, device=dev)
    uphi1, _ = system.poisson_solve(system.uphi0, system.ucp0, system.ucm0)
    A32 = system.species_dense_f32(uphi1)
    N = BENCH_SHAPE[0]
    check(tuple(A32.shape) == (2, N, N), f"L0 stage batch {A32.shape}")
    gj = gj_shape_check(torch, K, direct.contraction_ok, A32,
                        "bench L0 species stage batch", 3, 2)
    del A32
    ctx = make_scalar_context(sys0, space0, component=0, quad_order=3,
                              device=dev)
    vt = ctx.vt
    args = (system.pb[vt.dofmap], vt.shape, vt.gradphi, vt.qw, vt.qy,
            sys0.l_b, sys0.c0, sys0.cylindrical, sys0.pi)
    pb = pb_check(torch, K, args, BENCH_SHAPE[1])
    spmv = spmv_checks(torch, K, system, dev, "bench L0 ")
    return {"gj": gj, "pb": pb, "spmv": spmv}, counts


def level_kernels(argv) -> int:
    """``chip_smoke.py --level-kernels L`` (L >= 1): the kernels at the
    shapes the bench's level L gives them, on inputs from that level's
    system built on the card (phase A included): kernel 1 on the species
    RAS and PB Jacobian local batches (and, on the mid-size tier, the
    Poisson matrix), kernel 2 at the level's E (:func:`ras_kernel_checks`),
    kernel 3 in its three forms at the level's E (:func:`spmv_checks`),
    each against its plain version and timed. Prints the entries as one
    JSON line last."""
    import torch

    levels = int(argv[0])
    check(levels >= 1, "--level-kernels takes a refined level (L0: [bench])")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pnp_tpu_torch import bench as B
    from pnp_tpu_torch.fem import assembly as FA
    from pnp_tpu_torch.operators import kernels as K
    from pnp_tpu_torch.operators import volume as V
    from pnp_tpu_torch.solvers import block_ras as BR
    from pnp_tpu_torch.solvers import direct
    from pnp_tpu_torch.workloads import instationary_pnp_from_pb as W
    from pnp_tpu_torch.workloads.common import make_scalar_context

    dev = torch.device("cuda:0")
    print("[card] nvidia-smi name, power.limit:")
    print(nvidia_smi(), flush=True)
    K.build()
    sys_l, space_l = B._load(levels)
    system = W.build_pnp_system(sys_l, space_l, device=dev)
    bc = system.block_context
    print(f"[level kernels] L{levels}: {space_l.ndof} nodes, "
          f"{space_l.mesh.num_tris} triangles, K {bc.K} L {bc.L}, Poisson "
          f"tier {system.poisson_tier}, phase A {system.pb_seconds:.2f} s",
          flush=True)
    out = ras_kernel_checks(torch, K, direct, FA, V, BR, make_scalar_context,
                            system, dev, tag=f"L{levels} ")
    out["spmv"] = spmv_checks(torch, K, system, dev, f"L{levels} ")
    print(json.dumps({"level_kernels": levels, **out}))
    return 0


def very_large_main(torch, K, W, direct, FA, V, BR, make_scalar_context,
                    pore_case, dev):
    """Phase 11: the very-large Poisson tier at full size, then both
    kernels at the shapes that run gave them. Returns kernel 1's entry for
    the (1, N, N) shape, the other shapes' entries and the run's launch
    counts."""
    nodes, tris = LARGE_SHAPE
    sys_l, space_l = pore_case(*LARGE_CASE)
    check((space_l.ndof, space_l.mesh.num_tris) == (nodes, tris),
          f"pore_case{LARGE_CASE}: {space_l.ndof} nodes")
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    direct.probe_failures["count"] = 0
    res = W.run_instationary_pnp_from_pb(
        sys_l, space_l, n_steps=LARGE_STEPS, presolve_potential=True,
        ras_refresh_every=RAS_REFRESH, device=dev)
    counts = dict(K.launches)
    failures = direct.probe_failures["count"]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    held = torch.cuda.memory_allocated(dev) / 2**30
    system = res.system
    ctx = system.block_context
    print(f"[very-large main] pore_case{LARGE_CASE}: {nodes} dofs, {tris} "
          f"triangles; factor kind {system.factor_kind}, Poisson tier "
          f"{system.poisson_tier}, K {ctx.K} B {ctx.B} L {ctx.L}")
    check(system.poisson_tier == "inverse_large",
          f"very-large tier not taken: tier {system.poisson_tier}, probe "
          f"failures {failures}")
    setup_s, poisson_setup_s = res.setup_seconds, res.poisson_setup_seconds
    print(f"[very-large main] PB Newton iterations "
          f"{res.pb_newton_iterations}, phase A {res.pb_seconds:.3f} s, "
          f"setup (A-C) {setup_s:.3f} s, Poisson setup (f32 assembly, kernel "
          f"1 at (1, {nodes}, {nodes}), probe) {poisson_setup_s:.3f} s")
    for i, (ms, ks, kp, fresh) in enumerate(zip(
            res.step_ms, res.species_iterations, res.poisson_iterations,
            res.factor_rebuilt)):
        print(f"[very-large main] step {i} {'factor' if fresh else 'reuse'}"
              f" {ms:.2f} ms, species its {ks}, Poisson refinements {kp}")
    print(f"[very-large main] launches {counts}, probe failures "
          f"{failures}, peak memory {peak:.2f} GiB, held after the run "
          f"{held:.2f} GiB", flush=True)
    check(failures == 0, f"{failures} contraction-probe failures")
    check(all(tuple(v.shape) == (nodes,) and bool(torch.isfinite(v).all())
              for v in (res.phi, res.cp, res.cm)),
          "non-finite or misshapen final state")
    check(len(res.current_history) == LARGE_STEPS
          and all(math.isfinite(v) for _, a, b in res.current_history
                  for v in (*a, *b)), "currents")
    check(res.factor_rebuilt == [i % RAS_REFRESH == 0
                                 for i in range(LARGE_STEPS)]
          and res.factor_kinds == ["ras"] * LARGE_STEPS,
          f"factor schedule {res.factor_rebuilt} {res.factor_kinds}")
    check_launched(counts, BCGS_PATH, "very-large")

    # the run's inverse against the f64 element operator on a seeded b
    X_eq, s = system.poisson_pre
    check(tuple(X_eq.shape) == (1, nodes, nodes) and tuple(s.shape) == (nodes,),
          f"poisson_pre shapes {X_eq.shape} {s.shape}")
    del X_eq, s
    ctx_phi = make_scalar_context(sys_l, space_l, component=0, quad_order=3,
                                  device=dev)
    A_el = V.poisson_jacobian_el(ctx_phi.vt, sys_l.cylindrical, sys_l.pi)
    op = FA.make_constrained_operator(
        A_el[None], ctx_phi.vt.dofmap, nodes, ctx_phi.free[None])
    gen = torch.Generator(device="cpu").manual_seed(11)
    b = torch.randn(1, nodes, generator=gen, dtype=torch.float64).to(dev)
    x = direct.scaled_inv_apply(system.poisson_pre, b)
    resid = float(torch.linalg.vector_norm(op(x) - b)
                  / torch.linalg.vector_norm(b))
    print(f"[very-large main] ||A (X b) - b|| / ||b|| on a seeded b against "
          f"the f64 element operator {resid:.3e} (tol "
          f"{LARGE_RESIDUAL_TOL:g})", flush=True)
    check(resid <= LARGE_RESIDUAL_TOL, "very-large inverse residual")
    del op, A_el, ctx_phi, x, b

    # the same state through the two-level RAS Poisson (PB field shared)
    state = (res.phi, res.cp, res.cm)
    system.poisson_solve(*state)
    (phi_inv, k_inv), inv_solve_ms = timed(
        torch, lambda: system.poisson_solve(*state))
    two = W.build_pnp_system(sys_l, space_l, pb_field=system.pb,
                             poisson_inv_threshold=0, device=dev)
    check(two.poisson_tier == "ras", "two-level RAS Poisson system")
    two.poisson_solve(*state)
    (phi_two, k_two), two_solve_ms = timed(
        torch, lambda: two.poisson_solve(*state))
    tier_err = rel_err(phi_two, phi_inv)
    print(f"[very-large main] Poisson re-solve on the final state: inverse "
          f"tier {inv_solve_ms:.2f} ms ({k_inv} refinements), two-level RAS "
          f"{two_solve_ms:.2f} ms ({k_two} BiCGSTAB its, its setup "
          f"{1e3 * two.poisson_setup_seconds:.1f} ms); rel err "
          f"{tier_err:.3e} (tol {TIER_REL_TOL:g})", flush=True)
    check(tier_err <= TIER_REL_TOL, "very-large and two-level RAS Poisson "
          "tiers disagree")
    del two, phi_two, phi_inv

    # both kernels at this run's shapes: the (2 K, L, L) and (K, L, L)
    # local batches and kernel 2 at E = 94,208 from the run's system; then,
    # with the run and its inverse freed, the (1, N, N) Poisson matrix
    shapes = ras_kernel_checks(torch, K, direct, FA, V, BR,
                               make_scalar_context, system, dev,
                               tag="very-large ")
    del res, system, state
    entry = poisson_large_check(torch, K, W, direct, V, make_scalar_context,
                                sys_l, space_l, dev)
    share = entry["ms"] / (1e3 * poisson_setup_s)
    print(f"[very-large main] kernel 1 at (1, {nodes}, {nodes}), timed alone "
          f"after the run, {entry['ms'] / 1e3:.3f} s: {100 * share:.1f} % of "
          f"the run's Poisson setup", flush=True)
    entry.update(residual_rel=resid, peak_memory_gib=peak,
                 share_of_poisson_setup=share)
    return entry, shapes, counts


def very_large_parity(torch, W, pore_case, dev) -> None:
    """Phase 11's parity: the very-large tier forced on the small case (the
    mid-size bound set to 0), CUDA against CPU."""
    sys_s, space_s = pore_case(30, 17)
    bound_was = W.POISSON_INV_MAX_DOFS
    W.POISSON_INV_MAX_DOFS = 0
    try:
        run = lambda d: W.run_instationary_pnp_from_pb(
            sys_s, space_s, n_steps=PARITY_STEPS, presolve_potential=True,
            dense_poisson_threshold=0, ras_block_size=64,
            ras_refresh_every=RAS_REFRESH, device=d)
        g, c = run(dev), run("cpu")
    finally:
        W.POISSON_INV_MAX_DOFS = bound_was
    err, cur = fields_rel(torch, g, c)
    print(f"[very-large parity] pore_case(30, 17), tier forced, "
          f"{PARITY_STEPS} presolved steps, CUDA vs CPU: rel err fields "
          f"{err:.3e} currents {cur:.3e} (tol {SLICE_REL_TOL:g}); Poisson "
          f"refinements cuda {g.poisson_iterations} cpu "
          f"{c.poisson_iterations}", flush=True)
    check(g.system.poisson_tier == c.system.poisson_tier == "inverse_large",
          "very-large parity: tier not taken")
    check(max(abs(a - b) for a, b in zip(g.poisson_iterations,
                                         c.poisson_iterations)) <= 1,
          "very-large parity: refinement counts differ by more than one")
    check(max(err, cur) <= SLICE_REL_TOL, "very-large parity")


def mid_species_main(torch, K, W, direct, pore_case, ras_res, dev):
    """Phase 12: the mid-size species tier at 12,097 nodes beside phase 8's
    RAS numbers (``ras_res``), its parity on the small case, then kernel 1
    on the (2, N, N) stage batch at the run's final potential against its
    plain version. Returns kernel 1's entry for that shape and the run's
    launch counts."""
    nodes = RAS_SHAPE[0]
    sys_r, space_r = pore_case(*RAS_CASE)
    K.reset_launch_counts()
    direct.probe_failures["count"] = 0
    res = W.run_instationary_pnp_from_pb(
        sys_r, space_r, n_steps=MID_SPECIES_STEPS,
        presolve_potential=True, ras_refresh_every=RAS_REFRESH,
        species_inv_threshold=MID_SPECIES_THRESHOLD, device=dev,
        **RAS_KW)
    counts = dict(K.launches)
    failures = direct.probe_failures["count"]

    def split(r):
        fa = [t for t, f in zip(r.step_ms, r.factor_rebuilt) if f]
        re_ = [t for t, f in zip(r.step_ms, r.factor_rebuilt) if not f]
        return fa, re_

    fa, re_ = split(res)
    fa_ras, re_ras = split(ras_res)
    fmt = lambda xs: " ".join(f"{t:.2f}" for t in xs)
    print(f"[mid-species main] pore_case{RAS_CASE}, species_inv_threshold "
          f"{MID_SPECIES_THRESHOLD}, {MID_SPECIES_STEPS} presolved steps, "
          f"refresh every {RAS_REFRESH}: window kinds {res.factor_kinds}")
    print(f"[mid-species main] factor steps ms {fmt(fa)} (each with kernel "
          f"1 at (2, {nodes}, {nodes})), reuse steps ms {fmt(re_)}; "
          f"refinements a step {res.species_iterations}, Poisson "
          f"{res.poisson_iterations}")
    print(f"[mid-species main] beside the RAS factor (phase 8): factor steps "
          f"ms {fmt(fa_ras)}, reuse steps ms {fmt(re_ras)}; BiCGSTAB its a "
          f"step {ras_res.species_iterations}")
    mean = lambda xs: sum(xs) / len(xs)
    amort = lambda f, r: (mean(f) + (RAS_REFRESH - 1) * mean(r)) / RAS_REFRESH
    gain = mean(re_ras) - mean(re_)
    extra = mean(fa) - mean(fa_ras)
    print(f"[mid-species main] mean step at a refresh every {RAS_REFRESH}: "
          f"{amort(fa, re_):.2f} ms against {amort(fa_ras, re_ras):.2f} ms "
          f"with the RAS factor; a reuse step gains {gain:.2f} ms, a refresh "
          f"costs {extra:.2f} ms more: break-even at a refresh every "
          + (f"{1 + extra / gain:.0f} steps" if gain > 0 else "- (no gain)")
          + f"; launches {counts}, probe failures {failures}", flush=True)
    check(res.system.factor_kind == "ras"
          and res.system.poisson_tier == "inverse", "mid-species: tiers")
    # kernel 1: phase A's Jacobian factors (at most one a Newton iteration),
    # the Poisson inverse, and one launch a refresh
    refreshes = MID_SPECIES_STEPS // RAS_REFRESH
    check(1 <= counts["gj_inverse"] - refreshes
          <= 1 + res.pb_newton_iterations,
          f"gj_inverse launched {counts['gj_inverse']} times: not once a "
          "refresh beside the setup's")
    check(res.factor_kinds == ["inv"] * MID_SPECIES_STEPS and failures == 0,
          f"mid-species windows {res.factor_kinds}, {failures} probe "
          "failures")
    check(all(bool(torch.isfinite(v).all())
              for v in (res.phi, res.cp, res.cm)), "non-finite final state")
    # against phase 8's run from the same start: the stage tolerance's slack
    slack = max(rel_err(getattr(res, n), getattr(ras_res, n))
                for n in ("phi", "cp", "cm"))
    print(f"[mid-species main] final state against phase 8's RAS run: rel "
          f"err {slack:.3e} (stage solves to 1e-5; bound 2e-4)")
    check(slack <= 2e-4, "mid-species run against the RAS run")
    check_launched(counts, BCGS_PATH, "mid-species")

    sys_s, space_s = pore_case(30, 17)
    run = lambda d: W.run_instationary_pnp_from_pb(
        sys_s, space_s, n_steps=PARITY_STEPS, presolve_potential=True,
        dense_poisson_threshold=0, ras_block_size=64, ras_refresh_every=2,
        species_inv_threshold=space_s.ndof, device=d)
    g, c = run(dev), run("cpu")
    err, cur = fields_rel(torch, g, c)
    print(f"[mid-species parity] pore_case(30, 17), refresh every 2, "
          f"{PARITY_STEPS} presolved steps, CUDA vs CPU: rel err fields "
          f"{err:.3e} currents {cur:.3e} (tol {SLICE_REL_TOL:g}); kinds "
          f"{g.factor_kinds}; refinements cuda {g.species_iterations} cpu "
          f"{c.species_iterations}", flush=True)
    check(g.factor_kinds == c.factor_kinds == ["inv"] * PARITY_STEPS,
          "mid-species parity: kinds")
    check(max(abs(a - b) for a, b in zip(g.species_iterations,
                                         c.species_iterations)) <= 1,
          "mid-species parity: refinement counts differ by more than one")
    check(max(err, cur) <= SLICE_REL_TOL, "mid-species parity")

    # kernel 1 at this shape, on the stage matrices at the final potential,
    # against its plain version and beside torch.linalg.inv (one timed call
    # of the plain version: seconds)
    A = res.system.species_dense_f32(res.phi)
    check(tuple(A.shape) == (2, nodes, nodes), f"stage batch {A.shape}")
    entry = gj_shape_check(torch, K, direct.contraction_ok, A,
                           "mid-size species stage batch", 3, 0)
    return entry, counts


def workloads_phase(torch, K, W, make_scalar_context, pore_case, dev):
    """Phase 13: the other workloads at full width on the card against the
    CPU, kernel 2's launches counted and kernel 2 held against its plain
    version at the one shape no earlier phase gave it; then the command
    line from files written here. Returns that shape's entry and the
    launch counts of the card runs."""
    import numpy as np

    from pnp_tpu_torch import problems
    from pnp_tpu_torch.workloads.instationary_pnp import run_instationary_pnp
    from pnp_tpu_torch.workloads.pb import solve_pb
    from pnp_tpu_torch.workloads.stationary_diffusion import (
        run_stationary_diffusion)
    from pnp_tpu_torch.workloads.stationary_pnp import run_stationary_pnp

    def both(fn):
        """``fn(device)`` on the card (timed, host clock, synced) and on
        the CPU."""
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        g = fn(dev)
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        return g, fn("cpu"), ms

    K.reset_launch_counts()
    sys_r, space_r = pore_case(*RAS_CASE)
    sys_w, space_w = problems.one_wall_case(*WALL_CASE)
    pore, wall = f"pore_case{RAS_CASE}", f"one-wall rect_mesh{WALL_CASE}"
    for label, (sys_c, space_c) in ((wall, (sys_w, space_w)),
                                    (pore, (sys_r, space_r))):
        (ug, rg), (uc, rc), ms = both(lambda d: run_stationary_diffusion(
            sys_c, space_c, DIFFUSION_REDUCTION, device=d))
        err = rel_err(ug.cpu(), uc)
        print(f"[workloads] stationary_diffusion, {label}, {space_c.ndof} "
              f"dofs: {ms:.1f} ms on the card, {rg.iterations} its (cpu "
              f"{rc.iterations}), CUDA vs CPU rel err {err:.3e} (tol "
              f"{SLICE_REL_TOL:g})", flush=True)
        # BiCGSTAB that far down: the atomic assembly's last bits move the
        # count by a few iterations from one run on the card to the next
        check(ug.is_cuda and rg.converged and rc.converged
              and err <= SLICE_REL_TOL, f"stationary_diffusion, {label}")

    # CG under the two-level aggregation AMG: the diffusion solve and the
    # PB Newton on the one-wall case
    amg_w = dataclasses.replace(sys_w, linearSolver="CG_AMG_SSOR")
    (ug, rg), (uc, rc), ms = both(lambda d: run_stationary_diffusion(
        amg_w, space_w, DIFFUSION_REDUCTION, device=d))
    err = rel_err(ug.cpu(), uc)
    print(f"[workloads] stationary_diffusion CG_AMG_SSOR, {wall}, "
          f"{space_w.ndof} dofs: {ms:.1f} ms on the card, CG {rg.iterations}"
          f" its (cpu {rc.iterations}), CUDA vs CPU rel err {err:.3e} (tol "
          f"{SLICE_REL_TOL:g})", flush=True)
    check(ug.is_cuda and rg.converged and rc.converged
          and err <= SLICE_REL_TOL, "stationary_diffusion CG_AMG_SSOR")
    g, c, ms = both(lambda d: solve_pb(amg_w, space_w, device=d))
    err = rel_err(g.u.cpu(), c.u)
    print(f"[workloads] solve_pb CG_AMG_SSOR, {wall}: {ms:.1f} ms on the "
          f"card, Newton {g.iterations} its (cpu {c.iterations}), CG "
          f"{g.linear_iterations} (cpu {c.linear_iterations}), CUDA vs CPU "
          f"rel err {err:.3e} (tol {SLICE_REL_TOL:g})", flush=True)
    check(g.converged and c.converged and err <= SLICE_REL_TOL,
          "solve_pb CG_AMG_SSOR")

    # the monolithic Newton solve on the one-wall case only: on the pore
    # case its Jacobi-preconditioned BiCGSTAB runs to its iteration cap
    before = K.launches["pb_residual_jacobian"]
    g, c, ms = both(lambda d: run_stationary_pnp(sys_w, space_w, from_pb=True,
                                                 device=d))
    pb_launches = K.launches["pb_residual_jacobian"] - before
    err = rel_err(g.u.cpu(), c.u)
    print(f"[workloads] stationary_pnp from PB, {wall}, 3 x {space_w.ndof} "
          f"dofs: {ms:.1f} ms on the card, Newton {g.iterations} its (cpu "
          f"{c.iterations}), linear {g.linear_iterations} (cpu "
          f"{c.linear_iterations}), kernel 2 launches {pb_launches}, CUDA vs "
          f"CPU rel err {err:.3e} (tol {SLICE_REL_TOL:g})", flush=True)
    check(g.converged and c.converged and g.iterations == c.iterations
          and pb_launches > 0 and err <= SLICE_REL_TOL,
          "stationary_pnp on the card")

    before = K.launches["pb_residual_jacobian"]
    g, c, ms = both(lambda d: run_instationary_pnp(
        sys_r, space_r, n_steps=WORKLOAD_STEPS, device=d))
    pb_launches = K.launches["pb_residual_jacobian"] - before
    err = max(rel_err(getattr(g, n).cpu(), getattr(c, n))
              for n in ("phi", "cp", "cm"))
    print(f"[workloads] instationary_pnp, {pore}, {space_r.ndof} dofs, "
          f"{WORKLOAD_STEPS} explicit steps of dt {g.dt:.3e}: {ms:.1f} ms on "
          f"the card, kernel 2 launches {pb_launches}, CUDA vs CPU rel err "
          f"{err:.3e} (tol {SLICE_REL_TOL:g})", flush=True)
    check(g.dt == c.dt and pb_launches > 0 and err <= SLICE_REL_TOL
          and all(bool(torch.isfinite(getattr(g, n)).all())
                  for n in ("phi", "cp", "cm")),
          "instationary_pnp on the card")
    counts = dict(K.launches)
    # CG_AMG_SSOR's solves above are CG on the card
    check_launched(counts, ("cg_update", "cg_direction", "krylov_unconverged"),
                   "workloads'")

    # kernel 2 at the one-wall runs' shape (planar, E = 20,480) against its
    # plain version; the pore runs' (cylindrical, E = 23,552) is phase 9's
    ctx = make_scalar_context(sys_w, space_w, component=0, quad_order=3,
                              device=dev)
    vt = ctx.vt
    pb_w = solve_pb(sys_w, space_w, device=dev).u
    entry = pb_check(torch, K, (pb_w[vt.dofmap], vt.shape, vt.gradphi, vt.qw,
                                vt.qy, sys_w.l_b, sys_w.c0, sys_w.cylindrical,
                                sys_w.pi), space_w.mesh.num_tris)

    # the command line, from a .msh and a .cfg written here: the production
    # workload on the one-wall case (10,593 nodes: the block-RAS tier with
    # the mid-size Poisson inverse), on the card (no --device) and with
    # --device cpu; each leaves a checkpoint after its last step. Not the
    # pore case: the command line has no presolve switch, as the
    # reference's has none, and that case's raw biased start diverges
    cli_dir = os.path.join(REPO, "chip_smoke_out", "cli")
    os.makedirs(cli_dir, exist_ok=True)
    problems.write_gmsh(space_w.mesh, os.path.join(cli_dir, "one_wall.msh"))
    problems.write_config(sys_w, os.path.join(cli_dir, "one_wall.cfg"),
                          "one_wall.msh")

    def cli(tag, *device_args):
        ck = os.path.join(cli_dir, f"{tag}.ck")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "pnp_tpu_torch", "--steps", str(CLI_STEPS),
             "--checkpoint", ck, "--checkpoint-freq", str(CLI_STEPS), "-o",
             os.path.join(cli_dir, f"out_{tag}"), *device_args,
             os.path.join(cli_dir, "one_wall.cfg")],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        wall_s = time.perf_counter() - t0
        for line in out.stdout.splitlines():
            print(f"[workloads] cli ({tag}): {line}")
        print(f"[workloads] python3 -m pnp_tpu_torch --steps {CLI_STEPS} "
              f"--checkpoint ... -o ... {' '.join(device_args)} one_wall.cfg: "
              f"exit code {out.returncode}, {wall_s:.1f} s of process time",
              flush=True)
        check(out.returncode == 0, f"command line failed: "
              f"{out.stderr[-2000:]}")
        check(f"{space_w.ndof} nodes" in out.stdout
              and f"{CLI_STEPS} steps in" in out.stdout
              and os.path.exists(os.path.join(cli_dir, f"out_{tag}",
                                              "current.dat")),
              "command line output")
        return out.stdout, np.load(ck)

    out_g, ck_g = cli("cuda")
    check("device cuda" in out_g, "the command line did not take the card")
    out_c, ck_c = cli("cpu", "--device", "cpu")
    check("device cpu" in out_c, "--device cpu")
    # the same call through the library, from the case in memory
    res = W.run_instationary_pnp_from_pb(sys_w, space_w, n_steps=CLI_STEPS,
                                         device=dev)
    check((res.system.factor_kind, res.system.poisson_tier)
          == ("ras", "inverse"), "the one-wall case's tiers")
    err_cpu = max(rel_err(torch.tensor(ck_g[n]), torch.tensor(ck_c[n]))
                  for n in ("phi", "cp", "cm"))
    # the checkpoint's potential is the last step's; the run's final
    # potential has one more 1e-10 solve behind it
    err_lib = max(rel_err(torch.tensor(ck_g[n]), getattr(res, n).cpu())
                  for n in ("cp", "cm"))
    print(f"[workloads] cli checkpoints after {CLI_STEPS} steps at "
          f"{space_w.ndof} nodes: card vs --device cpu rel err {err_cpu:.3e}, "
          f"card vs the library call on the case in memory (cp, cm) "
          f"{err_lib:.3e} (tol {SLICE_REL_TOL:g})", flush=True)
    check(int(ck_g["step"]) == int(ck_c["step"]) == CLI_STEPS
          and max(err_cpu, err_lib) <= SLICE_REL_TOL, "command line results")
    return entry, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from pnp_tpu_torch.fem import assembly as FA
        from pnp_tpu_torch.operators import kernels as K
        from pnp_tpu_torch.operators import volume as V
        from pnp_tpu_torch.problems import pore_case, substeps_tableau
        from pnp_tpu_torch.solvers import block_ras as BR
        from pnp_tpu_torch.solvers import direct
        from pnp_tpu_torch.utils.profiling import PhaseTimer, maybe_trace
        from pnp_tpu_torch.workloads.common import make_scalar_context
        from pnp_tpu_torch.workloads import instationary_pnp_from_pb as W
        from pnp_tpu_torch import problems
        from pnp_tpu_torch.solvers import schwarz as SW
        from pnp_tpu_torch.workloads import distributed_pnp as TD
        from pnp_tpu_torch.workloads.pb import solve_pb
        from pnp_tpu_torch.tools import multiproc_smoke as MS
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    t_all = time.perf_counter()

    smi = nvidia_smi()
    print("[card] nvidia-smi name, power.limit:")
    print(smi, flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build ------------------------------------------------------
    info = K.build()
    print(f"[build] {info['seconds']:.2f} s (cached {info['cached']}) "
          f"-> {os.path.relpath(info['path'], REPO)}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    sys.stdout.flush()

    # ---- 3-4. kernels against their plain versions -----------------------
    sys_big, space_big = pore_case(100, 55)
    system0 = W.build_pnp_system(sys_big, space_big, device=dev)
    # at the raw biased start the stage matrices are near-singular in the
    # smooth direction and fail the probe with any f32 inverse (LAPACK's
    # included); the main path inverts them at the presolved potential
    uphi1, _ = system0.poisson_solve(system0.uphi0, system0.ucp0,
                                     system0.ucm0)
    A32 = system0.species_dense_f32(uphi1)
    check(tuple(A32.shape) == (2, 4801, 4801), f"stage batch {A32.shape}")
    gj = gj_shape_check(torch, K, direct.contraction_ok, A32,
                        "species stage batch", 3, 2)
    gj_checks(torch, K, direct.contraction_ok, dev)
    del A32
    sys.stdout.flush()

    ctx = make_scalar_context(sys_big, space_big, component=0, quad_order=3,
                              device=dev)
    vt = ctx.vt
    args = (system0.pb[vt.dofmap], vt.shape, vt.gradphi, vt.qw, vt.qy,
            sys_big.l_b, sys_big.c0, sys_big.cylindrical, sys_big.pi)
    pb = pb_check(torch, K, args, 9200)
    del system0, ctx, args

    # ---- 4b-4c. the Krylov kernels and the graphed loop ------------------
    cg_k = cg_kernel_checks(torch, K, dev)
    graph_loop_check(torch, K, dev)

    # ---- 5. slice parity, CUDA against CPU ------------------------------
    sys_s, space_s = pore_case(30, 17)
    run = lambda d: W.run_instationary_pnp_from_pb(
        sys_s, space_s, n_steps=3, presolve_potential=True, device=d)
    res_gpu, res_cpu = run(dev), run("cpu")
    errs = {n: rel_err(getattr(res_gpu, n).cpu(), getattr(res_cpu, n))
            for n in ("phi", "cp", "cm")}
    cur = max(rel_err(torch.tensor(a), torch.tensor(b))
              for (_, *g), (_, *c) in zip(res_gpu.current_history,
                                          res_cpu.current_history)
              for a, b in zip(g, c))
    print(f"[slice parity] pore_case(30, 17), 3 presolved steps, CUDA vs "
          f"CPU: rel err phi {errs['phi']:.3e} cp {errs['cp']:.3e} "
          f"cm {errs['cm']:.3e} currents {cur:.3e} (tol {SLICE_REL_TOL:g})",
          flush=True)
    check(max(*errs.values(), cur) <= SLICE_REL_TOL, "slice parity")

    # ---- 6. the main path ------------------------------------------------
    out_dir = os.path.join(REPO, "chip_smoke_out")
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    direct.probe_failures["count"] = 0
    res = W.run_instationary_pnp_from_pb(
        sys_big, space_big, n_steps=MAIN_STEPS, presolve_potential=True,
        output_dir=out_dir, device=dev)
    counts = dict(K.launches)
    failures = direct.probe_failures["count"]
    ndof = space_big.ndof
    finite = all(tuple(v.shape) == (ndof,) and bool(torch.isfinite(v).all())
                 for v in (res.phi, res.cp, res.cm))
    _, ip, im = res.current_history[-1]
    with open(os.path.join(out_dir, "current.dat")) as f:
        rows = [line.split() for line in f if line.strip()]
    print(f"[main] pore_case(100, 55): {ndof} dofs, "
          f"{space_big.mesh.num_tris} triangles")
    print(f"[main] PB Newton iterations {res.pb_newton_iterations}, phase A "
          f"{1e3 * res.pb_seconds:.1f} ms, setup (A-C) "
          f"{1e3 * res.setup_seconds:.1f} ms")
    print("[main] step ms " + " ".join(f"{t:.2f}" for t in res.step_ms))
    print(f"[main] species refinements per step {res.species_iterations}")
    print(f"[main] launches {counts}, probe failures {failures}, peak "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"[main] last currents t={res.time:g} ip {ip.tolist()} "
          f"im {im.tolist()}", flush=True)
    check(finite, "non-finite or misshapen final state")
    check(all(math.isfinite(v) for _, a, b in res.current_history
              for v in (*a, *b)), "non-finite currents")
    check(len(res.current_history) == MAIN_STEPS and len(rows) == MAIN_STEPS
          and all(len(r) == 1 + 2 * sys_big.n_surfaces for r in rows),
          "current.dat rows")
    check(failures == 0, f"{failures} contraction-probe failures")
    check_launched(counts, BCGS_PATH, "main")
    with maybe_trace(os.path.join(out_dir, "trace_dense")) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        c2 = res.system.species_step(res.phi, res.cp, res.cm)
        res.system.poisson_solve(res.phi, c2[0], c2[1])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    trace_summary(torch, prof, wall, "dense", tag="dense trace")
    del res, c2
    print(f"[dense tier done] {time.perf_counter() - t_all:.1f} s",
          flush=True)

    # ---- 7-10. the block-RAS tier -------------------------------------------
    ras_parity(torch, W, pore_case, dev)
    ras_res, ras_counts = ras_main(torch, K, W, direct, pore_case, dev)
    kry_counts = krylov_main(torch, K, W, direct, substeps_tableau(),
                             pore_case, dev)
    ras_k = ras_kernel_checks(torch, K, direct, FA, V, BR,
                              make_scalar_context, ras_res.system, dev)
    ras_breakdown(torch, W, PhaseTimer, maybe_trace, ras_res, dev)
    print(f"[block-RAS tier done] {time.perf_counter() - t_all:.1f} s",
          flush=True)

    # ---- the owner-partitioned driver, K shards on the card ---------------
    dist_res, dist_counts = dist_main(torch, K, TD, direct, pore_case,
                                      ras_res, dev)
    dist_parity(torch, TD, problems, solve_pb, pore_case, dev)
    dist_k = dist_kernels(torch, K, SW, direct, dist_res)
    dist_trace(torch, maybe_trace, dist_res, dev)
    del dist_res
    print(f"[owner-partitioned, one process, done] "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)

    # ---- the same driver as processes: ranks on the card ------------------
    _, procs_k, procs_counts = procs_gloo(torch, TD, MS, pore_case, dev)
    nccl_counts = procs_nccl(torch, TD, MS, pore_case, dev)
    p2_k, p2_counts = p2_phase(torch, K, W, problems, make_scalar_context,
                               dev)
    print(f"[distributed and P2 done] {time.perf_counter() - t_all:.1f} s",
          flush=True)

    # ---- element sharding: the single driver on K element shards ----------
    shard_k, shard_counts = sharded_main(torch, K, W, direct,
                                         make_scalar_context, maybe_trace,
                                         pore_case, dev)
    shard_procs, shard_nccl = sharded_procs(torch, W, MS, pore_case, dev)
    print(f"[element sharding done] {time.perf_counter() - t_all:.1f} s",
          flush=True)
    amg_k, amg_counts = sharded_amg_main(torch, K, W, direct,
                                         make_scalar_context, maybe_trace,
                                         pore_case, dev)
    amg_procs, amg_nccl = sharded_procs(torch, W, MS, pore_case, dev,
                                        "CG_AMG_SSOR", "sharded amg")
    print(f"[element sharding under CG_AMG_SSOR done] "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)

    # ---- 11-13. the inverse tiers above it, the other workloads -----------
    mid_k, mid_counts = mid_species_main(torch, K, W, direct, pore_case,
                                         ras_res, dev)
    del ras_res
    very_large_parity(torch, W, pore_case, dev)
    large_k, large_shapes, large_counts = very_large_main(
        torch, K, W, direct, FA, V, BR, make_scalar_context, pore_case, dev)
    dist_plan_timing(pore_case(*LARGE_CASE)[1])
    print(f"[inverse tiers done] {time.perf_counter() - t_all:.1f} s",
          flush=True)
    work_k, work_counts = workloads_phase(torch, K, W, make_scalar_context,
                                          pore_case, dev)
    bench_k, bench_counts = bench_phase(torch, K, W, direct,
                                        make_scalar_context, dev)
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    # once more, for a reader who sees the end of the output only
    print("[card] nvidia-smi name, power.limit:")
    print(smi)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        {"name": "gj_inverse", "route": "cuda",
         "source": "pnp_tpu_torch/csrc/gj_inverse.cu",
         "replaces": "pnp_tpu/operators/pallas_kernels.py:343",
         "launches": counts["gj_inverse"], **{k: gj[k] for k in keys},
         "shape": gj["shape"], "library_rel_diff": gj["library_rel_diff"],
         "launches_block_ras": ras_counts["gj_inverse"],
         "launches_species_krylov": kry_counts["gj_inverse"],
         "block_ras_shape": ras_k["gj"],
         "block_ras_pb_shape": ras_k["gj_pb"],
         "poisson_shape": ras_k["gj_poisson"],
         "launches_very_large": large_counts["gj_inverse"],
         "launches_mid_species": mid_counts["gj_inverse"],
         "launches_workloads": work_counts["gj_inverse"],
         "poisson_large_shape": large_k,
         "very_large_species_shape": large_shapes["gj"],
         "very_large_pb_shape": large_shapes["gj_pb"],
         "mid_species_shape": mid_k,
         "launches_dist": dist_counts["gj_inverse"],
         "dist_species_shape": dist_k["gj_species"],
         "dist_pb_shape": dist_k["gj_pb"],
         "launches_p2": p2_counts["gj_inverse"],
         "launches_procs_gloo": procs_counts["gj_inverse"],
         "launches_procs_nccl": nccl_counts["gj_inverse"],
         "procs_species_shape": procs_k["gj_species"],
         "procs_pb_shape": procs_k["gj_pb"],
         "launches_bench": bench_counts["gj_inverse"],
         "bench_shape": bench_k["gj"],
         "launches_sharded": shard_counts["gj_inverse"],
         "sharded_shape": shard_k["gj"],
         "launches_sharded_procs": shard_procs["gj_inverse"],
         "launches_sharded_nccl": shard_nccl["gj_inverse"],
         "launches_sharded_amg": amg_counts["gj_inverse"],
         "launches_sharded_amg_procs": amg_procs["gj_inverse"],
         "launches_sharded_amg_nccl": amg_nccl["gj_inverse"]},
        {"name": "pb_residual_jacobian", "route": "cuda",
         "source": "pnp_tpu_torch/csrc/pb_element.cu",
         "replaces": "pnp_tpu/operators/pallas_kernels.py:105",
         "launches": counts["pb_residual_jacobian"],
         **{k: v for k, v in pb.items() if k != "E"},
         "launches_block_ras": ras_counts["pb_residual_jacobian"],
         "launches_species_krylov": kry_counts["pb_residual_jacobian"],
         "launches_very_large": large_counts["pb_residual_jacobian"],
         "launches_mid_species": mid_counts["pb_residual_jacobian"],
         "launches_workloads": work_counts["pb_residual_jacobian"],
         "block_ras_shape": ras_k["pb"],
         "very_large_shape": large_shapes["pb"],
         "workloads_shape": work_k,
         "launches_dist": dist_counts["pb_residual_jacobian"],
         "dist_shape": dist_k["pb"],
         "launches_p2": p2_counts["pb_residual_jacobian"],
         "p2_shape": p2_k,
         "launches_procs_gloo": procs_counts["pb_residual_jacobian"],
         "launches_procs_nccl": nccl_counts["pb_residual_jacobian"],
         "procs_shape": procs_k["pb"],
         "launches_bench": bench_counts["pb_residual_jacobian"],
         "bench_shape": bench_k["pb"],
         "launches_sharded": shard_counts["pb_residual_jacobian"],
         "sharded_shape": shard_k["pb"],
         "launches_sharded_procs": shard_procs["pb_residual_jacobian"],
         "launches_sharded_nccl": shard_nccl["pb_residual_jacobian"],
         "launches_sharded_amg": amg_counts["pb_residual_jacobian"],
         "sharded_amg_shape": amg_k["pb"],
         "launches_sharded_amg_procs": amg_procs["pb_residual_jacobian"],
         "launches_sharded_amg_nccl": amg_nccl["pb_residual_jacobian"]},
        {"name": "element_spmv", "route": "cuda",
         "source": "pnp_tpu_torch/csrc/element_spmv.cu",
         "replaces": "pnp_tpu/fem/assembly.py:spmv (XLA's gather, batched "
                     "matvec and scatter-add; no Pallas kernel)",
         "launches": counts["element_spmv"],
         **{k: bench_k["spmv"]["poisson"][k] for k in keys},
         "shape": bench_k["spmv"]["poisson"]["shape"],
         "library_rel_diff": bench_k["spmv"]["poisson"]["library_rel_diff"],
         "bench_shape": bench_k["spmv"],
         "launches_block_ras": ras_counts["element_spmv"],
         "launches_species_krylov": kry_counts["element_spmv"],
         "launches_very_large": large_counts["element_spmv"],
         "launches_mid_species": mid_counts["element_spmv"],
         "launches_workloads": work_counts["element_spmv"],
         "launches_dist": dist_counts["element_spmv"],
         "launches_p2": p2_counts["element_spmv"],
         "launches_bench": bench_counts["element_spmv"],
         "launches_sharded": shard_counts["element_spmv"],
         "launches_sharded_amg": amg_counts["element_spmv"]},
    ]
    paths = {"block_ras": ras_counts, "species_krylov": kry_counts,
             "very_large": large_counts, "mid_species": mid_counts,
             "workloads": work_counts, "dist": dist_counts, "p2": p2_counts,
             "procs_gloo": procs_counts, "procs_nccl": nccl_counts,
             "bench": bench_counts, "sharded": shard_counts,
             "sharded_procs": shard_procs, "sharded_nccl": shard_nccl,
             "sharded_amg": amg_counts, "sharded_amg_procs": amg_procs,
             "sharded_amg_nccl": amg_nccl}
    kernels += [
        {"name": name, "route": "cuda",
         "source": "pnp_tpu_torch/csrc/cg_update.cu",
         "replaces": "pnp_tpu/solvers/krylov.py (XLA's fusion of the "
                     "iteration's updates and test; no Pallas kernel)",
         "launches": counts[name], **entry,
         **{f"launches_{path}": c[name] for path, c in paths.items()}}
        for name, entry in cg_k.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--procs-worker"]:
            sys.exit(procs_worker(sys.argv[2:]))
        if sys.argv[1:2] == ["--level-kernels"]:
            sys.exit(level_kernels(sys.argv[2:]))
        sys.exit(main())
    except Exception:  # any failed phase: report it and print no result
        traceback.print_exc()
        sys.exit(1)
