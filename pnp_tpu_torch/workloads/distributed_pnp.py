"""The owner-partitioned multi-shard production driver (port of
``pnp_tpu.workloads.distributed_pnp``).

The multi-device form of :mod:`.instationary_pnp_from_pb` (reference
driver src/instationary_pnp_from_pb_md.hh:112-456): the same phases A-D,
but dof vectors live owner-partitioned over K shards
(:mod:`..parallel.dist`), halo values move as packed per-pair buffers, and
every linear solve is BiCGSTAB under distributed Schwarz
(:mod:`..solvers.schwarz`): the counterpart of DUNE's NOVLP decomposition
with SSOR-preconditioned ISTL solvers. ``n_shards`` (the reference's
``device_mesh``) is a shard count K, all K shards a leading batch axis of
tensors in this process, or a :class:`..parallel.distributed.RankLayout`:
K / P shards on each of P ranks, every rank running this same code on its
own rows (the reference binary's ``mpirun -np P``). The exchange of
:class:`..parallel.dist.DistContext` is the only place where shards read
each other's data; under ranks every read across shards (the exchange,
the Krylov and Newton sums, the probe's verdict, the non-finite guard, the
gather for IO) is a collective that every rank reaches together, and only
the coordinator (rank 0) writes outputs and checkpoints.

State layout:
  * ``uphi``: flat (Kb,) owner-partitioned potential;
  * ``uc``:   (2, Kb) stacked species (c+, c-), both stage systems solved
    as one batched BiCGSTAB run (one exchange serves both);
  * element quadrature tables: flat (K*B_E, ...) per the halo plan, padded
    rows zero, so the element kernels run unchanged on them.

Kernels: phase A's PB residual and Jacobian come from the fused PB kernel
(:class:`..operators.kernels.PBElement`) at E = K*B_E; every Schwarz local
inverse is one (S*K, L, L) batch through the Gauss-Jordan kernel (per PB
Newton assembly, per species factor, once for the Poisson operator).

Poisson tiers: one-level Schwarz up to 8,192 dofs; above, two-level
Schwarz with the per-shard linear coarse level, both built once a run.
Over more than one rank always one-level, as the reference's
multi-process driver (``pnp_tpu/workloads/distributed_pnp.py:224``).
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..config import Sysparams
from ..fem import constraints as C
from ..fem.geometry import VolumeTables, build_volume_tables, f64
from ..fem.space import FunctionSpace
from ..io.checkpoint import load_checkpoint, save_checkpoint
from ..io.writers import CurrentWriter, write_dat, write_vtu
from ..operators import kernels as KN
from ..operators import volume as V
from ..operators.common import interp_grad
from ..parallel import distributed as PD
from ..parallel.dist import DistContext, build_dist_context
from ..postprocess.ionflux import build_ionflux_tables, calc_ion_flux
from ..solvers import schwarz as SW
from ..solvers.krylov import bicgstab
from ..solvers.newton import NewtonParams, NewtonResult, newton_solve
from ..timestepping.tableaux import Tableau, alexander2
from ..utils.profiling import synchronize
from .common import make_scalar_context

F64 = torch.float64

#: above this many dofs the Poisson operator takes two-level Schwarz (in
#: one process)
TWO_LEVEL_DOFS = 8192


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def partition_volume_tables(ctx: DistContext, vt: VolumeTables) -> VolumeTables:
    """Element tables -> flat (K*B_E, ...) layout on ``ctx.device`` (pad
    rows zero, so padded elements contribute nothing through qw)."""
    put = lambda a: f64(ctx.partition_elem(_host(a)), ctx.device)
    return VolumeTables(shape=vt.shape.to(ctx.device),
                        gradphi=put(vt.gradphi), qw=put(vt.qw),
                        qy=put(vt.qy), dofmap=None)   # gathers go through ctx


@dataclasses.dataclass
class DistPnpSystem:
    """Pipeline pieces of the owner-partitioned production driver."""

    sys: Sysparams
    space: FunctionSpace
    ctx: DistContext
    pb: Any                      # (Kb,) distributed PB field
    pb_newton_iterations: int
    pb_jacobian_builds: int
    uphi0: Any                   # (Kb,)
    uc0: Any                     # (2, Kb) stacked (c+, c-)
    species_step: Callable       # (uphi, uc) -> (uc', iters)
    poisson_solve: Callable      # (uphi, uc, maxiter=None) -> (uphi', iters, converged)
    fused_step: Callable         # (uphi, uc) -> (uphi', uc')
    scan_steps: Callable         # ((uphi, uc), n) -> (uphi', uc')
    dt: float
    # Schwarz factor amortization (None where the tableau's stage
    # diagonals differ: no one factor serves every stage)
    species_factor: Any = None         # (uphi) -> (2, K, L, L) f32 inverses
    species_step_reuse: Any = None     # (factor, uphi, uc) -> (uc', iters)
    fused_step_reuse: Any = None       # (factor, uphi, uc) -> (uphi', uc')
    # (uphi) -> (2, K, L, L) f32 local stage matrices, what
    # ``species_factor`` inverts (None with it)
    species_local_f32: Any = None
    poisson_tier: str = "schwarz"      # "schwarz" | "two_level"
    free_phi: Any = None               # (Kb,) bool, padding constrained
    vt_phi: Any = None                 # phase A's partitioned tables
    pb_seconds: float = 0.0            # phase A wall time (device synced)
    poisson_setup_seconds: float = 0.0

    def to_global(self, v) -> np.ndarray:
        """Owner-partitioned (Kb,) -> global (ndof,) numpy (for IO; under
        ranks a collective, on every rank)."""
        return self.ctx.to_host_global(v)


def solve_pb_distributed(sys: Sysparams, space: FunctionSpace,
                         ctx: DistContext, vt_p: VolumeTables, flux_phi,
                         free_phi, verbosity: int = 0) -> NewtonResult:
    """Phase A: distributed PB Newton (reference md.hh:125-228).

    Residual and Jacobian from the fused PB kernel on the partitioned
    tables, assembled through the halo-exchange gather/scatter; each
    assembly inverts the Schwarz local matrices (kernel 1), each Newton
    step solves J z = r by BiCGSTAB under RAS. The split assemble/solve
    protocol honours ``newtonReassembleThreshold``."""
    element = KN.PBElement(vt_p.shape, vt_p.gradphi, vt_p.qw, vt_p.qy,
                           sys.l_b, sys.c0, sys.cylindrical, sys.pi)

    def residual(u):
        r_el, _ = element(ctx.gather_elem(u), "residual")
        return torch.where(free_phi, ctx.scatter_elem(r_el) + flux_phi, 0.0)

    def assemble(u):
        _, J_el = element(ctx.gather_elem(u), "jacobian")
        inv = SW.invert_local_matrices(
            ctx, SW.build_local_matrices(ctx, J_el, free_phi))
        return J_el, inv

    def solve(jac_ctx, r, lin_red):
        J_el, inv = jac_ctx
        op = ctx.make_constrained_operator(J_el, free_phi)
        res = bicgstab(op, r, torch.zeros_like(r),
                       SW.make_ras_inv_precond(ctx, inv), lin_red,
                       sys.linearSolverIterations, reduce=ctx.allreduce_sum)
        return res.x, res.iterations

    params = NewtonParams(
        reduction=sys.newtonReduction,
        min_linear_reduction=sys.newtonMinLinearReduction,
        max_iterations=int(sys.newtonMaxIterations),
        line_search_max=int(sys.newtonLineSearchMaxIteration),
        verbosity=verbosity,
        reassemble_threshold=sys.newtonReassembleThreshold)
    u0 = torch.zeros(ctx.Kb, dtype=F64, device=ctx.device)
    return newton_solve(residual, None, u0, params, assemble_fn=assemble,
                        assembled_solve_fn=solve, reduce=ctx.allreduce_sum)


def build_dist_pnp_system(
    sys: Sysparams,
    space: FunctionSpace,
    n_shards,
    tableau: Optional[Tableau] = None,
    pb_field=None,
    device=None,
) -> DistPnpSystem:
    """Build the owner-partitioned pipeline over ``n_shards``: a shard
    count (all in this process, on ``device``, default the current CUDA
    device; raises without one) or this rank's
    :class:`..parallel.distributed.RankLayout` (on its device).

    ``pb_field``: an optional precomputed GLOBAL (ndof,) PB field; without
    it, phase A runs the distributed PB Newton."""
    layout = PD.as_layout(n_shards, device)
    device = layout.device
    tab = tableau if tableau is not None else alexander2()
    dt = sys.tau
    pi = sys.pi
    a_tab = [[float(v) for v in row] for row in tab.A]
    b_tab = [[float(v) for v in row] for row in tab.B]
    stages = tab.stages
    uniform_diag = all(
        a_tab[i][i + 1] == a_tab[0][1] and b_tab[i][i + 1] == b_tab[0][1]
        for i in range(stages))

    ctx = build_dist_context(space, layout)
    pad = ctx.pad_mask_flat()
    part = lambda x: ctx.partition(np.asarray(x))
    put_vec = lambda x: f64(part(x), device)
    # a global dof mask -> (Kb,) bool, padded slots constrained
    mask = lambda m: torch.as_tensor(
        part(np.asarray(m).astype(np.int8)).astype(bool) & pad,
        device=device)

    # ---- constraints + boundary tables (host-built, partitioned once) ----
    ctx_phi = make_scalar_context(sys, space, component=0, quad_order=3,
                                  device="cpu")
    free_phi = mask(ctx_phi.free.numpy())
    flux_phi = put_vec(ctx_phi.flux_vector.numpy())
    free_pair = torch.stack([mask(C.free_dof_mask(space, sys, c))
                             for c in (1, 2)])
    g_pair = torch.stack([put_vec(C.dirichlet_dof_values(space, sys, c))
                          for c in (1, 2)])

    # ---- element tables (quad orders per reference, degree-scaled) -------
    vt_p = partition_volume_tables(ctx, ctx_phi.vt)
    vt2 = partition_volume_tables(
        ctx, build_volume_tables(space, max(2, 2 * space.degree)))
    vt5 = partition_volume_tables(
        ctx, build_volume_tables(space, max(5, 2 * space.degree + 1)))

    # ---- Phase A: PB bootstrap -------------------------------------------
    t0 = _time.perf_counter()
    if pb_field is None:
        pb_res = solve_pb_distributed(sys, space, ctx, vt_p, flux_phi,
                                      free_phi, verbosity=sys.verbosity)
        pb, pb_iters = pb_res.u, pb_res.iterations
        pb_builds = pb_res.jacobian_builds
    else:
        pb_np = (_host(pb_field) if isinstance(pb_field, torch.Tensor)
                 else pb_field)
        pb, pb_iters, pb_builds = put_vec(pb_np), 0, 0
    synchronize(device)
    PD.barrier(layout)
    pb_seconds = _time.perf_counter() - t0

    # ---- Phase B: initial fields from the PB solution --------------------
    pb_g = ctx.to_host_global(pb)
    uphi0 = put_vec(C.interpolate_with_pb_fallback(space, sys, 0, pb_g))
    uc0 = torch.stack([
        put_vec(C.interpolate_with_pb_fallback(space, sys, c, pb_g))
        for c in (1, 2)])

    # ---- Phase C: operators + the constant Poisson factorization ---------
    M_el = V.mass_jacobian_el(vt5, 1.0, False, pi)        # ref: planar mass
    A_phi = V.poisson_jacobian_el(vt_p, sys.cylindrical, pi)
    op_phi = ctx.make_constrained_operator(A_phi, free_phi)
    t0 = _time.perf_counter()
    if space.ndof > TWO_LEVEL_DOFS and layout.world_size == 1:
        # two-level Schwarz for the constant Poisson operator: per-shard
        # inverses + the per-shard linear coarse level, built once a run
        # (the single-device block-RAS tier's linear coarse default)
        poisson_tier = "two_level"
        inv_phi = SW.invert_local_matrices(
            ctx, SW.build_local_matrices(ctx, A_phi, free_phi))
        p1_phi = SW.build_p1_coarse_dist(ctx, op_phi, _host(free_phi),
                                         space.dof_coords)
        M_phi = SW.make_two_level_inv_precond(ctx, inv_phi, p1_phi,
                                              op_phi, free_phi)
    else:
        poisson_tier = "schwarz"
        M_phi = SW.make_schwarz_precond(ctx, A_phi, free_phi)
    synchronize(device)
    poisson_setup_seconds = _time.perf_counter() - t0

    def _build_K_pair(uphi_):
        gphi = interp_grad(ctx.gather_elem(uphi_), vt2.gradphi)
        return torch.stack([
            V.drift_diffusion_jacobian_el(gphi, vt2, +1.0, False, pi),
            V.drift_diffusion_jacobian_el(gphi, vt2, -1.0, False, pi)])

    def _mass_scatter(uc_):
        ue = ctx.gather_elem(uc_)                          # (2, F, n)
        return ctx.scatter_elem(torch.einsum("eij,sej->sei", M_el, ue))

    def _stage_blocks(K_pair, a_ii, b_ii):
        return a_ii * M_el[None] + (dt * b_ii) * K_pair

    def _species_stages(K_pair, uc_, M_shared):
        """All DIRK stages for both species, batched (2, Kb) solves at the
        reference's 1e-5 stage tolerance (md.hh:383-386), each BiCGSTAB
        under Schwarz: ``M_shared`` where the stage diagonal is uniform
        (possibly a stale factor under ``ras_refresh_every``: staleness
        only raises iteration counts), else each stage's own."""
        levels = [uc_]
        iters = 0
        for i in range(stages):
            a_ii, b_ii = a_tab[i][i + 1], b_tab[i][i + 1]
            hist = torch.zeros_like(uc_)
            for j in range(i + 1):
                if a_tab[i][j] != 0.0:
                    hist = hist + a_tab[i][j] * _mass_scatter(levels[j])
                if b_tab[i][j] != 0.0:
                    hist = hist + dt * b_tab[i][j] * ctx.spmv(K_pair,
                                                              levels[j])
            guess = torch.where(free_pair, levels[-1], g_pair)
            r = (hist + a_ii * _mass_scatter(guess)
                 + dt * b_ii * ctx.spmv(K_pair, guess))
            r = torch.where(free_pair, r, 0.0)
            A_el = _stage_blocks(K_pair, a_ii, b_ii)
            op = ctx.make_constrained_operator(A_el, free_pair)
            M = M_shared if M_shared is not None else (
                SW.make_schwarz_precond(ctx, A_el, free_pair))
            res = bicgstab(op, r, torch.zeros_like(r), M, 1e-5,
                           sys.linearSolverIterations, reduce=ctx.allreduce_sum)
            levels.append(guess - res.x)
            # one iteration count for the batch: the loop runs until both
            # systems converge
            iters += res.iterations
        return levels[-1], iters

    def _species_local(uphi_):
        A_stage = _stage_blocks(_build_K_pair(uphi_), a_tab[0][1],
                                b_tab[0][1])
        return SW.build_local_matrices(ctx, A_stage, free_pair)

    def _species_factor(uphi_):
        """Schwarz local inverses of the (uniform-diagonal) stage matrix,
        (2, K, L, L) f32: reusable across steps."""
        return SW.invert_local_matrices(ctx, _species_local(uphi_))

    def _species_step(uphi_, uc_):
        K_pair = _build_K_pair(uphi_)
        M_shared = None
        if uniform_diag:
            A_stage = _stage_blocks(K_pair, a_tab[0][1], b_tab[0][1])
            M_shared = SW.make_schwarz_precond(ctx, A_stage, free_pair)
        return _species_stages(K_pair, uc_, M_shared)

    def _species_step_reuse(inv, uphi_, uc_):
        return _species_stages(_build_K_pair(uphi_), uc_,
                               SW.make_ras_inv_precond(ctx, inv))

    def _poisson_solve(uphi_, uc_, maxiter=None):
        """SLP apply at tolerance 1e-10 (reference md.hh:349-350), at most
        ``maxiter`` (default linearSolverIterations) BiCGSTAB iterations."""
        r_el = V.poisson_residual_el(
            ctx.gather_elem(uphi_), ctx.gather_elem(uc_[0]),
            ctx.gather_elem(uc_[1]), vt_p, sys.l_b, sys.cylindrical, pi)
        r = torch.where(free_phi, ctx.scatter_elem(r_el) + flux_phi, 0.0)
        res = bicgstab(op_phi, r, torch.zeros_like(r), M_phi, 1e-10,
                       maxiter or sys.linearSolverIterations,
                       reduce=ctx.allreduce_sum)
        return uphi_ - res.x, res.iterations, res.converged

    def _fused_step(uphi_, uc_):
        uc_, _ = _species_step(uphi_, uc_)
        uphi_ = _poisson_solve(uphi_, uc_)[0]
        return uphi_, uc_

    def _fused_step_reuse(inv, uphi_, uc_):
        uc2, _ = _species_step_reuse(inv, uphi_, uc_)
        uphi2 = _poisson_solve(uphi_, uc2)[0]
        return uphi2, uc2

    def scan_steps(state, n_steps: int):
        # the reference's lax.scan; its own A/B found the scan flat
        # against the loop (PARITY.md, round 5)
        for _ in range(n_steps):
            state = _fused_step(*state)
        return state

    return DistPnpSystem(
        sys=sys, space=space, ctx=ctx, pb=pb,
        pb_newton_iterations=pb_iters, pb_jacobian_builds=pb_builds,
        uphi0=uphi0, uc0=uc0, species_step=_species_step,
        poisson_solve=_poisson_solve, fused_step=_fused_step,
        scan_steps=scan_steps, dt=dt,
        species_factor=_species_factor if uniform_diag else None,
        species_step_reuse=_species_step_reuse if uniform_diag else None,
        fused_step_reuse=_fused_step_reuse if uniform_diag else None,
        species_local_f32=((lambda u: _species_local(u).to(torch.float32))
                           if uniform_diag else None),
        poisson_tier=poisson_tier, free_phi=free_phi, vt_phi=vt_p,
        pb_seconds=pb_seconds, poisson_setup_seconds=poisson_setup_seconds)


@dataclasses.dataclass
class DistPnpRunResult:
    """Phase-D result of the distributed driver; fields are GLOBAL numpy,
    on every rank. ``n_shards`` is the reference's ``n_devices``: the shard
    count K over all ranks; ``n_ranks`` the processes that held them."""

    phi: np.ndarray
    cp: np.ndarray
    cm: np.ndarray
    time: float
    steps: int
    pb_newton_iterations: int
    pb_jacobian_builds: int    # newtonReassembleThreshold observability
    current_history: list      # [(time, ip(n_surf,), im(n_surf,)), ...]
    space: FunctionSpace
    n_shards: int
    n_ranks: int = 1
    # host-clock wall times (device synced; under ranks each step starts
    # and ends at a barrier, so every rank reads the same step): setup =
    # phases A-C (and the presolve); per step: wall ms (the factor build
    # included), the species BiCGSTAB iterations summed over the stages,
    # the Poisson iterations (0 when the step skipped the re-solve),
    # whether the Poisson solve converged before its cap (True when it was
    # skipped), whether it built a species factor
    setup_seconds: float = 0.0
    pb_seconds: float = 0.0
    poisson_setup_seconds: float = 0.0
    step_ms: list = dataclasses.field(default_factory=list)
    species_iterations: list = dataclasses.field(default_factory=list)
    poisson_iterations: list = dataclasses.field(default_factory=list)
    poisson_converged: list = dataclasses.field(default_factory=list)
    factor_rebuilt: list = dataclasses.field(default_factory=list)
    system: Any = None         # the DistPnpSystem the run stepped
    # with ``record_states``: the global (phi, cp, cm) the first step
    # started from, then after every step
    states: Optional[list] = None


def run_distributed_pnp_from_pb(
    sys: Sysparams,
    space: FunctionSpace,
    n_shards,
    n_steps: Optional[int] = None,
    output_dir: Optional[str] = None,
    tableau: Optional[Tableau] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_freq: int = 0,
    resume: bool = False,
    flux_convention: str = "reference",
    presolve_potential: bool = False,
    pb_field=None,
    ras_refresh_every: int = 1,
    device=None,
    record_states: bool = False,
) -> DistPnpRunResult:
    """The multi-shard production driver: phases A-D owner-partitioned over
    ``n_shards``: a shard count K, all in this process on ``device``
    (default: the current CUDA device; raises without one), or this rank's
    :class:`..parallel.distributed.RankLayout` (every rank of the group
    calls this function with the same arguments and its own layout).

    Mirrors ``run_instationary_pnp_from_pb`` (reference phase D,
    src/instationary_pnp_from_pb_md.hh:421-456): species step each tau,
    Poisson re-solve at potentialUpdateFreq cadence, ion flux + .dat/.vtu
    writers + current.dat every outputFreq, final Poisson solve. Output
    work gathers to host global vectors, so current.dat depends on the
    trajectory alone, not on K or the ranks. Only the coordinator writes
    outputs and checkpoints. Checkpoints are in the single-device global
    format: a run checkpointed under one K, or under ranks, resumes under
    another K, or in one process.
    ``ras_refresh_every`` > 1 rebuilds the species Schwarz factor on steps
    whose absolute index is a multiple of it (and on the first step run),
    so a resumed run keeps the uninterrupted run's schedule.
    ``record_states`` keeps every step's global state in the result (a
    step run again from it shows what that one step did)."""
    layout = PD.as_layout(n_shards, device)
    device = layout.device
    n_steps = sys.nSteps if n_steps is None else n_steps
    t_setup = _time.perf_counter()
    system = build_dist_pnp_system(sys, space, layout, tableau=tableau,
                                   pb_field=pb_field)
    ctx = system.ctx
    uphi, uc = system.uphi0, system.uc0
    dt = system.dt
    if presolve_potential:
        uphi = system.poisson_solve(uphi, uc)[0]
    synchronize(device)
    PD.barrier(layout)
    setup_seconds = _time.perf_counter() - t_setup

    ionflux_tables = build_ionflux_tables(space, sys.cylindrical, sys.pi,
                                          sys.n_surfaces, device)
    put_vec = lambda x: f64(ctx.partition(np.asarray(x)), device)

    time = 0.0
    start_step = 0
    if resume and checkpoint_path:
        ck = load_checkpoint(checkpoint_path, sys)
        if ck is not None:
            uphi = put_vec(ck["phi"])
            uc = torch.stack([put_vec(ck["cp"]), put_vec(ck["cm"])])
            time, start_step = ck["time"], ck["step"]

    def to_host(uphi_, uc_):
        uc_g = ctx.to_host_global(uc_)
        return ctx.to_host_global(uphi_), uc_g[0], uc_g[1]

    def finite() -> bool:
        """The state is finite on every rank (a collective under ranks)."""
        bad = ~(torch.isfinite(uphi).all() & torch.isfinite(uc).all())
        return float(ctx.allreduce_sum(bad.to(F64))) == 0.0

    writes = output_dir and PD.is_coordinator()    # one writer under ranks
    current_writer = None
    output_counter = 0
    if output_dir:
        fields0 = to_host(uphi, uc)
    if writes:
        os.makedirs(output_dir, exist_ok=True)
        current_writer = CurrentWriter(os.path.join(output_dir, "current.dat"))
        for name, vec in zip(("phi", "cp", "cm"), fields0):
            write_dat(space, vec, os.path.join(output_dir, f"{name}.dat"))

    states = [to_host(uphi, uc)] if record_states else None
    history, step_ms = [], []
    species_its, poisson_its, converged, rebuilt = [], [], [], []
    use_reuse = ras_refresh_every > 1 and system.species_factor is not None
    factor = None
    try:
        for i in range(start_step, n_steps):
            PD.barrier(layout)
            t_step = _time.perf_counter()
            fresh = True
            if use_reuse:
                fresh = factor is None or i % ras_refresh_every == 0
                if fresh:
                    factor = system.species_factor(uphi)
                uc, k = system.species_step_reuse(factor, uphi, uc)
            else:
                uc, k = system.species_step(uphi, uc)
            kp, ok = 0, True
            if i % sys.potentialUpdateFreq == 0:
                uphi, kp, ok = system.poisson_solve(uphi, uc)
            synchronize(device)
            PD.barrier(layout)
            step_ms.append(1e3 * (_time.perf_counter() - t_step))
            species_its.append(k)
            poisson_its.append(kp)
            converged.append(ok)
            rebuilt.append(fresh)
            if record_states:
                states.append(to_host(uphi, uc))
            time += dt
            if i % sys.outputFreq == 0:
                output_counter += 1
                phi_g, cp_g, cm_g = to_host(uphi, uc)
                ip, im = calc_ion_flux(
                    ionflux_tables, *(f64(v, device)
                                      for v in (phi_g, cp_g, cm_g)),
                    convention=flux_convention)
                ip, im = _host(ip), _host(im)
                history.append((time, ip, im))
                if writes:
                    fields = {"phi": phi_g, "cp": cp_g, "cm": cm_g}
                    for name, vec in fields.items():
                        write_dat(space, vec, os.path.join(
                            output_dir, f"{name}{output_counter:03d}.dat"))
                    write_vtu(space, fields, os.path.join(
                        output_dir, f"data{output_counter:03d}.vtu"))
                    current_writer.write(time, ip, im)
            if (checkpoint_path and checkpoint_freq
                    and (i + 1) % checkpoint_freq == 0):
                fields = to_host(uphi, uc)
                if PD.is_coordinator():
                    save_checkpoint(checkpoint_path, sys, i + 1, time,
                                    *fields)
            # failure guard: detect a non-finite state, dump an emergency
            # checkpoint, and abort with a diagnosable error (every rank
            # reads the same verdict and raises at the same step)
            if (i + 1) % 16 == 0 or i + 1 == n_steps:
                if not finite():
                    if checkpoint_path:
                        fields = to_host(uphi, uc)
                        if PD.is_coordinator():
                            save_checkpoint(checkpoint_path + ".emergency",
                                            sys, i + 1, time, *fields)
                    raise FloatingPointError(
                        f"non-finite state at step {i + 1} (t={time:g}); "
                        "reduce tau or enable presolve_potential")
    finally:
        if current_writer:
            current_writer.close()

    uphi = system.poisson_solve(uphi, uc)[0]   # final solve (ref :454)
    phi_g, cp_g, cm_g = to_host(uphi, uc)
    return DistPnpRunResult(
        phi=phi_g, cp=cp_g, cm=cm_g, time=time, steps=n_steps,
        pb_newton_iterations=system.pb_newton_iterations,
        pb_jacobian_builds=system.pb_jacobian_builds,
        current_history=history, space=space, n_shards=ctx.K,
        n_ranks=layout.world_size,
        setup_seconds=setup_seconds, pb_seconds=system.pb_seconds,
        poisson_setup_seconds=system.poisson_setup_seconds,
        step_ms=step_ms, species_iterations=species_its,
        poisson_iterations=poisson_its, poisson_converged=converged,
        factor_rebuilt=rebuilt, system=system, states=states)
