"""The production workload: instationary PNP bootstrapped from a PB solve.

Port of ``pnp_tpu.workloads.instationary_pnp_from_pb`` on one device, in
two tiers, each with a species Krylov path beside its factored one.
Parity: reference ``instationary_pnp_md``
(src/instationary_pnp_from_pb_md.hh:112-456). Phases:

  A. nonlinear PB Newton solve on the coulomb BC table (workloads/pb.py;
     element residual and Jacobian from the fused PB kernel; block-RAS
     BiCGSTAB above 8,192 dofs)
  B. initial (phi, c+, c-) from the PB solution: phi = phi_PB,
     c+- = c0 exp(-+ phi_PB), Dirichlet dofs from config
  C. one-time Poisson setup for the constant decoupled operator:
     * dense tier (ndof <= ``dense_poisson_threshold``): the exact affine
       form phi* = q + P (cm - cp) from a host-grade f64 inverse;
     * block-RAS tier, mid-size (ndof <= ``poisson_inv_threshold`` and
       <= POISSON_INV_MAX_DOFS): one f32 inverse by the Gauss-Jordan
       kernel, each re-solve an f64-residual refinement to 1e-10;
     * block-RAS tier, very large (POISSON_INV_MAX_DOFS < ndof <=
       ``poisson_inv_threshold``): the same with the one (ndof, ndof) f32
       inverse kept in its equilibrated form (X_eq, s), assembled from
       scaled element blocks and probed against the element operator;
     * block-RAS tier above that, or where the very-large inverse fails
       its probe: two-level RAS (local inverses + the piecewise-linear
       coarse space), f64 BiCGSTAB to 1e-10;
     * above the dense tier with another solver variant than
       ``BCGS_SSORk``: that variant's Krylov solve to 1e-10 on the
       assembled diagonal, with the lambda_max(D^-1 A) estimate of setup.
  D. time loop: both species' Alexander-2 stages solved together as one
     (2, ndof) batch. Dense tier: f32 stage matrices inverted by the
     Gauss-Jordan kernel, then f64 refinement against the exact element
     operator. Block-RAS tier: BiCGSTAB under RAS with f32 local stage
     inverses (kernel 1), one factor serving every stage and, in the run
     loop, ``ras_refresh_every`` steps. A tableau whose stage diagonals
     differ has no factor that serves every stage (none of
     ``timestepping.tableaux`` does: ``fractional_step_theta`` too has one
     diagonal; ``problems.substeps_tableau`` is such a one): on the
     block-RAS tier each stage builds its own local
     inverses (kernel 1 once a stage), elsewhere, and for every other
     solver variant above the dense tier, each stage is that variant's
     Krylov solve on the batched diagonal. With ``species_inv_threshold``
     (off by default) the block-RAS tier's refresh builds the dense
     (2, ndof, ndof) f32 stage inverses instead (kernel 1 and the probe)
     and reuse steps refine with them; a refresh whose probe fails keeps
     the RAS factor for its window. Poisson re-solve every
     potentialUpdateFreq; ion flux + output every outputFreq; final
     Poisson solve.

Reference behaviours kept: the species operators carry NO axisymmetric
weight even in cylindrical runs (src/diffusion_operator.hh:100; PB and
Poisson do carry it); quadrature orders 3 (PB/Poisson), 2 (species
spatial), 5 (species mass); dt = tau.

Spans (``utils.profiling``, recorded inside ``recording()``):
``pnp.setup.phase_a``/``_b``/``_c`` in :func:`build_pnp_system`,
``pnp.species_factor``, ``pnp.species_step`` (its ``iterations``) and
``pnp.poisson_solve`` (its ``tier`` and ``iterations``) around the
system's callables, ``pnp.step`` (its ``step``), ``pnp.output`` and
``pnp.checkpoint`` in the run loop, whose host copies and finiteness
guard go through ``host_copy`` and ``host_read``.

``CG_AMG_SSOR`` runs CG under two-level aggregation AMG above the dense
tier and on element-sharded tables (one aggregation for phi, one for the
species pair). The species stage operators carry the drift, so they are
not symmetric: their CG restarts every ``SPECIES_CG_RESTART`` iterations
(the reference never restarts; plain CG stalls above the stage tolerance
from 47,745 dofs on, and converges within the period below that).

``device_mesh`` (K element shards, :mod:`..parallel.sharding`): the
species and Poisson element tables (orders 2, 5 and 3) are split over the
shards, dof vectors stay whole, and every scatter over them sums the
shards' partials (over the shard axis, then one all-reduce over ranks).
As in the reference the dense tier and block-RAS are then off at every
size: the Poisson re-solve is the configured variant's Krylov solve on the
assembled diagonal (``BCGS_SSORk``: BiCGSTAB under Chebyshev-Jacobi(3))
and the species stages take the species Krylov path. Phase A's PB solve,
the boundary tables and the ion flux stay unsharded. Under ranks only the
coordinator writes outputs and checkpoints. ``CG_AMG_SSOR`` runs on it
where the shard count divides the element count (as in the reference,
whose aggregation is of the whole, unpadded dof map; another count raises
``ValueError``): each aggregation is of the whole dof map, the same on
every rank, its coarse matrix the sum of the shards' partials (one
all-reduce a preconditioner build over ranks). The owner-partitioned
multi-device driver is
:func:`..workloads.distributed_pnp.run_distributed_pnp_from_pb`.
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..config import Sysparams
from ..fem import assembly as FA
from ..fem import constraints as C
from ..fem.space import FunctionSpace
from ..fem.geometry import build_volume_tables, f64
from ..operators import volume as V
from ..operators.common import interp_grad
from ..timestepping.tableaux import Tableau, alexander2
from ..postprocess.ionflux import build_ionflux_tables, calc_ion_flux
from ..io.writers import write_dat, write_vtu, CurrentWriter
from ..io.checkpoint import save_checkpoint, load_checkpoint
from ..solvers import block_ras as BR
from ..solvers.amg import make_amg_context
from ..solvers.direct import (batched_inv_f32, inv_f32_probe, inv_f32_setup,
                              inv_f32_setup_large, make_inv_refine_solver,
                              make_inv_refine_solver_arg)
from ..solvers.krylov import bicgstab
from ..solvers.linear_problem import make_krylov_solver
from ..solvers.precond import estimate_dinv_spectral_radius
from ..parallel.distributed import RankLayout, as_layout, is_coordinator
from ..parallel.sharding import (make_device_mesh, replicate,
                                 shard_volume_tables)
from ..utils.device import resolve_device
from ..utils.profiling import host_copy, host_read, span, synchronize
from .common import make_scalar_context
from .pb import solve_pb

F32 = torch.float32
F64 = torch.float64

#: upper bound of the mid-size Poisson tier (its (ndof, ndof) f32 inverse,
#: equilibrated and unscaled inside kernel 1's wrapper); above it, up to
#: ``poisson_inv_threshold``, the very-large tier keeps the inverse scaled
POISSON_INV_MAX_DOFS = 16384

#: the restart period of the species stages' CG under ``CG_AMG_SSOR``
#: (:func:`..solvers.krylov.cg`): the pore case's stages take 12-13
#: iterations at 12,097 dofs, 21-23 restarted at 47,745 and 42-44 at 189,697,
#: where plain CG stalls above the stage tolerance
SPECIES_CG_RESTART = 15

#: relative tolerance of the species stage solves (the reference's,
#: src/instationary_pnp_from_pb_md.hh:383-386)
STAGE_REDUCTION = 1e-5

class PoissonTier(NamedTuple):
    name: str            # dense | inverse | inverse_large | ras | krylov
    amg: bool = False    # krylov under CG_AMG_SSOR: with its aggregation


class SpeciesPath(NamedTuple):
    name: str                 # dense | ras | ras_stage | krylov
    rank1: bool = False       # dense, P1: the drift block's rank-1 form
    two_level: bool = False   # ras: with the batched p1 coarse level
    mid: bool = False         # ras: the mid-size tier's tagged factor


def choose_tiers(ndof: int, linear_solver: str, sharded: bool,
                 uniform_stage_diag: bool, degree: int,
                 dense_poisson_threshold: int, poisson_inv_threshold: int,
                 species_inv_threshold: int, species_two_level: bool):
    """``(PoissonTier, SpeciesPath)`` of :func:`build_pnp_system` (whose
    docstring gives the bounds). One factor serves every stage only where
    the stage diagonals are uniform; the species Krylov path also carries
    the AMG aggregation. A very-large inverse that fails its probe at
    setup runs as "ras"."""
    if not sharded and ndof <= dense_poisson_threshold:
        poisson = PoissonTier("dense")
    elif sharded or linear_solver != "BCGS_SSORk":
        poisson = PoissonTier("krylov", amg=linear_solver == "CG_AMG_SSOR")
    elif ndof <= min(poisson_inv_threshold, POISSON_INV_MAX_DOFS):
        poisson = PoissonTier("inverse")
    elif ndof <= poisson_inv_threshold:
        poisson = PoissonTier("inverse_large")
    else:
        poisson = PoissonTier("ras")
    if poisson.name == "dense" and uniform_stage_diag:
        species = SpeciesPath("dense", rank1=degree == 1)
    elif poisson.name in ("dense", "krylov"):
        species = SpeciesPath("krylov")
    elif uniform_stage_diag:
        species = SpeciesPath("ras", two_level=species_two_level,
                              mid=ndof <= species_inv_threshold)
    else:
        species = SpeciesPath("ras_stage")
    return poisson, species


def _spectral_probe(ndof: int, device):
    """The start vector of the lambda_max(D^-1 A) power iterations."""
    return torch.sin(torch.arange(ndof, dtype=F64, device=device) * 0.7) + 1.1


def element_mesh(device_mesh, device):
    """``device_mesh`` (a :class:`RankLayout`, a shard count over the
    process group, or None) as (layout or None, device)."""
    if device_mesh is None:
        return None, resolve_device(device)
    mesh = (as_layout(device_mesh, device)
            if isinstance(device_mesh, RankLayout)
            else make_device_mesh(device_mesh, device))
    return mesh, mesh.device


def equilibrated_dense_f32(A_el, dofmap, ndof: int, free):
    """The constrained operator's equilibrated dense matrix A_eq = S A S in
    f32, (ndof, ndof), and the scale s = 1/sqrt|diag| (ndof,) f32, built
    without an unscaled or f64 copy (the very-large tier counts its
    (ndof, ndof) buffers): the element blocks are scaled on both sides by
    (free * s)[dofmap] and cast to f32 before the scatter, so Dirichlet
    rows and columns come out zero, and the identity is put back on their
    diagonal (s = 1 there)."""
    d = FA.constrained_diagonal(A_el, dofmap, ndof, free)
    s = torch.rsqrt(torch.clamp_min(d.abs(), 1e-30)).to(F32)
    free32 = free.to(F32)
    w_el = (free32 * s)[dofmap]                              # (E, n)
    Am = A_el.to(F32) * w_el[:, :, None] * w_el[:, None, :]
    A_eq = torch.zeros((ndof, ndof), dtype=F32, device=A_el.device)
    A_eq.index_put_((dofmap[:, :, None].expand_as(Am),
                     dofmap[:, None, :].expand_as(Am)), Am, accumulate=True)
    A_eq.diagonal().add_(1.0 - free32)
    return A_eq, s


@dataclasses.dataclass
class PnpSystem:
    """Pipeline pieces for the instationary PNP-from-PB workload."""

    sys: Sysparams
    space: FunctionSpace
    pb: Any                      # PB bootstrap field
    pb_newton_iterations: int
    uphi0: Any
    ucp0: Any
    ucm0: Any
    species_step: Callable       # (uphi, ucp, ucm) -> (ucp', ucm', its)
    # (uphi, ucp, ucm[, phi_pre]) -> (uphi', its); ``phi_pre`` replaces
    # the system's own ``poisson_pre`` for one call
    poisson_solve: Callable
    fused_step: Callable         # (uphi, ucp, ucm) -> (uphi', ucp', ucm')
    scan_steps: Callable         # ((uphi, ucp, ucm), n) -> (uphi', ucp', ucm')
    ionflux_tables: Any
    dt: float
    # factor-amortized species stepping; ``factor_kind`` "dense" (f32
    # stage inverses) or "ras" (f32 local inverses, with the batched p1
    # coarse tables when ``species_two_level``; with the mid-size species
    # tier a tagged pair, ("inv", stage inverses) or ("ras", that factor),
    # by each refresh's probe). All None where no one factor serves every
    # stage (the species Krylov path).
    species_factor: Any = None       # (uphi) -> factor
    species_step_reuse: Any = None   # (factor, uphi, ucp, ucm) -> (...)
    factor_kind: Any = None
    # the mid-size species tier is on: ``species_factor`` returns, and
    # ``species_step_reuse`` takes, the tagged pair
    mid_species: bool = False
    fused_step_reuse: Any = None     # (factor, uphi, ucp, ucm) -> state'
    # dense tier and mid-size species tier: (uphi) -> (2, ndof, ndof) f32
    # constrained stage matrices; block-RAS tier: (uphi) -> (2, K, L, L)
    # f32 local stage matrices
    species_dense_f32: Any = None
    species_local_f32: Any = None
    # Poisson setup state: "dense" (P, q) | "inverse" (1, N, N) f32 |
    # "inverse_large" (X_eq (1, N, N) f32, s (N,) f32) | "ras" (local
    # inverses, p1 coarse tables) | "krylov" (the assembled diagonal)
    poisson_tier: str = "dense"
    poisson_pre: Any = None
    # lambda_max(D^-1 A) estimates with their 1.2 headroom, where a Krylov
    # path reads them (0-d tensors; None elsewhere)
    lam_phi: Any = None
    lam_species: Any = None
    block_context: Any = None        # block-RAS tier's BlockContext
    pb_seconds: float = 0.0      # phase A wall time (host clock, synced)
    poisson_setup_seconds: float = 0.0   # phase C's Poisson setup (synced)

    def kind_of(self, factor) -> Optional[str]:
        """The kind of a step's species factor (None: it built its own)."""
        return (factor[0] if self.mid_species and factor is not None
                else self.factor_kind)


def build_pnp_system(
    sys: Sysparams,
    space: FunctionSpace,
    tableau: Optional[Tableau] = None,
    device_mesh=None,
    pb_field=None,
    dense_poisson_threshold: int = 8192,
    ras_block_size: int = 256,
    poisson_inv_threshold: int = 49152,
    species_inv_threshold: int = 0,
    species_two_level: bool = False,
    device=None,
) -> PnpSystem:
    """Build the production pipeline on ``device`` (default: the current
    CUDA device; raises without one, see ``utils.device.resolve_device``).
    :func:`choose_tiers` picks the Poisson tier and the species path once.

    ``dense_poisson_threshold``: the dense tier's size bound; above it
    (with ``BCGS_SSORk``) the block-RAS tier with blocks of about
    ``ras_block_size`` dofs, and with any other solver variant that
    variant's Krylov solves. ``poisson_inv_threshold``: the Poisson
    inverse tiers serve up to this many dofs (mid-size up to
    POISSON_INV_MAX_DOFS, very large above); 0 forces two-level RAS.
    ``species_two_level`` adds the batched p1 coarse level to the species
    RAS factor (a tableau with a uniform stage diagonal only, as in the
    reference). ``species_inv_threshold`` (default 0, off): up to this
    many dofs the block-RAS tier's ``species_factor`` builds the dense f32
    stage inverses and, where they pass the contraction probe, reuse
    steps refine with them instead of running RAS BiCGSTAB. The reference
    offers it on a TPU only; here it runs on any device.
    ``device_mesh``: K element shards (a shard count, or a layout from
    ``parallel.sharding.make_device_mesh``; its device is the run's); the
    dense tier and block-RAS are then off (see the module docstring);
    under ``CG_AMG_SSOR`` a K that does not divide the element count
    raises ``ValueError``. The species stages solve to STAGE_REDUCTION.
    """
    mesh, device = element_mesh(device_mesh, device)
    tab = tableau if tableau is not None else alexander2()
    dt = sys.tau
    pi = sys.pi
    ndof = space.ndof
    if (mesh is not None and sys.linearSolver == "CG_AMG_SSOR"
            and space.mesh.num_tris % mesh.n_shards):
        raise ValueError(
            f"CG_AMG_SSOR on element-sharded tables needs a shard count "
            f"that divides the element count ({mesh.n_shards} shards, "
            f"{space.mesh.num_tris} elements): its aggregation is of the "
            f"whole, unpadded dof map, as in the reference")
    a_tab = [[float(v) for v in row] for row in tab.A]
    b_tab = [[float(v) for v in row] for row in tab.B]
    stages = tab.stages
    a01, b01 = a_tab[0][1], b_tab[0][1]
    # raises for an unknown variant
    krylov = make_krylov_solver(sys.linearSolver, sys.linearSolverIterations)
    poisson, species = choose_tiers(
        ndof, sys.linearSolver, mesh is not None,
        all(a_tab[i][i + 1] == a01 and b_tab[i][i + 1] == b01
            for i in range(stages)),
        space.degree, dense_poisson_threshold, poisson_inv_threshold,
        species_inv_threshold, species_two_level)

    # ---- Phase A: PB bootstrap ------------------------------------------
    with span("pnp.setup.phase_a"):
        t0 = _time.perf_counter()
        if pb_field is None:
            pb_res = solve_pb(sys, space, device=device)
            pb, pb_iters = pb_res.u, pb_res.iterations
        else:
            pb = torch.as_tensor(pb_field, dtype=F64, device=device)
            pb_iters = 0
        if mesh is not None:
            pb = replicate(mesh, pb)
        synchronize(device)
        pb_seconds = _time.perf_counter() - t0

    # ---- Phase B: constraints + initial fields --------------------------
    with span("pnp.setup.phase_b"):
        ctx_phi = make_scalar_context(sys, space, component=0, quad_order=3,
                                      device=device)
        if mesh is not None:
            ctx_phi = dataclasses.replace(ctx_phi, flux_vector=replicate(
                mesh, ctx_phi.flux_vector))
        masks = [torch.as_tensor(C.free_dof_mask(space, sys, c), device=device)
                 for c in (1, 2)]
        free_pair = torch.stack(masks)                          # (2, ndof)
        g_pair = torch.stack([f64(C.dirichlet_dof_values(space, sys, c),
                                  device) for c in (1, 2)])
        pb_np = host_copy(pb)
        uphi0, ucp0, ucm0 = (
            f64(C.interpolate_with_pb_fallback(space, sys, c, pb_np), device)
            for c in (0, 1, 2))

    # ---- Phase C: operators + the Poisson setup --------------------------
    # each tier's setup returns (tier, pre, solve(uphi, ucp, ucm, pre) ->
    # (uphi', iterations)); every re-solve is to 1e-10 (reference :349-350)
    def _poisson_residual(uphi_, ucp_, ucm_):
        dm = vt_phi.dofmap
        r_el = V.poisson_residual_el(uphi_[dm], ucp_[dm], ucm_[dm], vt_phi,
                                     sys.l_b, sys.cylindrical, pi)
        return ctx_phi.constrain(FA.scatter_add(r_el, dm, ndof)
                                 + ctx_phi.flux_vector)

    def dense_setup():
        A_phi_dense = FA.dense_constrained_matrix(A_phi_el, vt_phi.dofmap,
                                                  ndof, ctx_phi.free)
        # charge coupling: the Poisson residual is affine in w = cm - cp,
        # r = A u + M4 w + flux; M4 dense with Dirichlet rows zeroed
        M4_el = V.mass_jacobian_el(vt_phi, 4.0 * sys.l_b * pi,
                                   sys.cylindrical, pi)
        M4_dense = torch.zeros((ndof, ndof), dtype=F64, device=device)
        E_phi, n_phi = vt_phi.dofmap.shape
        M4_dense.index_put_(
            (vt_phi.dofmap[:, :, None].expand(E_phi, n_phi, n_phi),
             vt_phi.dofmap[:, None, :].expand(E_phi, n_phi, n_phi)),
            M4_el, accumulate=True)
        M4_dense = M4_dense * ctx_phi.free.to(F64)[:, None]
        u_bc = torch.where(ctx_phi.free, 0.0, ctx_phi.dirichlet)
        rhs_bc = ctx_phi.constrain(FA.spmv(A_phi_el, u_bc, vt_phi.dofmap,
                                           ndof) + ctx_phi.flux_vector)
        # phi* = q + P (cm - cp),  P = -Ainv M4,  q = u_bc - Ainv r(u_bc):
        # exact for any current phi (the decoupled Poisson operator is
        # constant), so one matvec a re-solve. One-time f64 inverse,
        # outside any kernel (as in the reference).
        Ainv = torch.linalg.inv(A_phi_dense)

        def solve(uphi_, ucp_, ucm_, pre):
            P_phi, q_phi = pre
            return q_phi + P_phi @ (ucm_ - ucp_), 1

        return "dense", (-(Ainv @ M4_dense), u_bc - Ainv @ rhs_bc), solve

    def krylov_setup():
        # another solver variant above the dense tier: its Krylov solve on
        # the assembled diagonal, lambda_max(D^-1 A) estimated once (the
        # operator is constant) with 1.2 headroom
        nonlocal lam_phi
        diag = FA.constrained_diagonal(A_phi_el, vt_phi.dofmap, ndof,
                                       ctx_phi.free)
        lam_phi = 1.2 * estimate_dinv_spectral_radius(
            op_phi, diag, _spectral_probe(ndof, device))

        def solve(uphi_, ucp_, ucm_, pre):
            r = _poisson_residual(uphi_, ucp_, ucm_)
            res = krylov_phi(op_phi, r, torch.zeros_like(r), pre, 1e-10,
                             A_el=A_phi_el, lam=lam_phi)
            return uphi_ - res.x, res.iterations

        return "krylov", diag, solve

    def refine_setup(tier, pre):
        # the inverse tiers: an f64-residual refinement with the f32 inverse
        refine = make_inv_refine_solver_arg(A_phi_el[None], vt_phi.dofmap,
                                            ndof, ctx_phi.free[None])

        def solve(uphi_, ucp_, ucm_, pre_):
            x, k = refine(pre_, _poisson_residual(uphi_, ucp_, ucm_)[None],
                          1e-10)
            return uphi_ - x[0], k

        return tier, pre, solve

    def inverse_setup():
        # mid-size tier: one f32 inverse of the constant operator (kernel 1
        # + the probe)
        A32 = FA.dense_constrained_matrix(A_phi_el.to(F32), vt_phi.dofmap,
                                          ndof, ctx_phi.free)
        return refine_setup("inverse", inv_f32_setup(A32[None]))

    def inverse_large_setup():
        # very-large tier: one (ndof, ndof) f32 inverse, kept in its
        # equilibrated form. Kernel 1 holds its working copy and its output
        # beside A_eq; A_eq and the working copy are freed before the run
        # state is made. An inverse that fails its probe leaves two-level
        # RAS to serve.
        dm = vt_phi.dofmap
        A_eq, s_phi = equilibrated_dense_f32(A_phi_el, dm, ndof, ctx_phi.free)
        X_eq, ok = inv_f32_setup_large(
            A_eq[None], s_phi, FA.make_constrained_operator(
                A_phi_el[None], dm, ndof, ctx_phi.free[None]))
        del A_eq
        if not ok:
            del X_eq
            return ras_setup()
        return refine_setup("inverse_large", (X_eq, s_phi))

    def ras_setup():
        # two-level RAS factors, built once: local inverses + the
        # piecewise-linear coarse space (3 modes per block); BiCGSTAB as
        # one CUDA graph a re-solve
        pre = (BR.build_local_inverses(ctx_ras, A_phi_el, ctx_phi.free),
               BR.build_p1_coarse(ctx_ras, A_phi_el, vt_phi.dofmap,
                                  ctx_phi.free, space.dof_coords))

        def solve(uphi_, ucp_, ucm_, pre_):
            r = _poisson_residual(uphi_, ucp_, ucm_)
            inv_p, p1_p = pre_
            M = BR.make_two_level_precond(ctx_ras, inv_p, None, op_phi,
                                          ctx_phi.free, p1_coarse=p1_p)
            res = bicgstab(op_phi, r, torch.zeros_like(r), M, 1e-10,
                           sys.linearSolverIterations, graph=True)
            return uphi_ - res.x, res.iterations

        return "ras", pre, solve

    with span("pnp.setup.phase_c"):
        # species orders 2 (spatial) / 5 (mass), raised with the space degree
        vt2 = build_volume_tables(space, max(2, 2 * space.degree), device)
        vt5 = build_volume_tables(space, max(5, 2 * space.degree + 1), device)
        vt_phi = ctx_phi.vt
        if mesh is not None:
            vt2, vt5, vt_phi = (shard_volume_tables(vt, mesh)
                                for vt in (vt2, vt5, vt_phi))

        krylov_phi = krylov_sp = krylov
        if poisson.amg:
            # the AMG variant gets an aggregation on both Krylov paths, one for
            # phi and one over the union of the species masks, each of the
            # whole dof map (the same on every rank) and kept with the dof map
            # of the (sharded) element blocks passed at the call sites
            coords = space.dof_coords
            krylov_phi = make_krylov_solver(
                sys.linearSolver, sys.linearSolverIterations,
                amg_ctx=make_amg_context(space.dofmap, ndof, ctx_phi.free,
                                         dof_coords=coords,
                                         block_dofmap=vt_phi.dofmap))
            krylov_sp = make_krylov_solver(
                sys.linearSolver, sys.linearSolverIterations,
                amg_ctx=make_amg_context(space.dofmap, ndof, free_pair,
                                         dof_coords=coords,
                                         block_dofmap=vt2.dofmap),
                cg_restart=SPECIES_CG_RESTART)

        M_el = V.mass_jacobian_el(vt5, 1.0, False, pi)  # planar (as the ref)
        # one mass matrix for both species; vt5 and vt2 share a dof map
        mass_apply = FA.make_operator(M_el[None], vt2.dofmap, ndof)
        A_phi_el = V.poisson_jacobian_el(vt_phi, sys.cylindrical, pi)
        op_phi = FA.make_constrained_operator(A_phi_el, vt_phi.dofmap, ndof,
                                              ctx_phi.free)
        ctx_ras = lam_phi = lam_species = None
        t0 = _time.perf_counter()
        if species.name in ("ras", "ras_stage"):
            ctx_ras = BR.build_block_context_for_space(space, ras_block_size,
                                                       device)
        poisson_tier, poisson_pre, solve_phi = {
            "dense": dense_setup, "krylov": krylov_setup,
            "inverse": inverse_setup, "inverse_large": inverse_large_setup,
            "ras": ras_setup}[poisson.name]()
        synchronize(device)
        poisson_setup_seconds = _time.perf_counter() - t0

    # ---- species: the step's drift, the factor, the stages ---------------
    def _stage_blocks(K_pair, a_ii=a01, b_ii=b01):
        return a_ii * M_el[None] + (dt * b_ii) * K_pair

    if species.rank1:
        # P1: grad(phi) and the basis gradients are constant per element,
        # so the drift block is rank-1, A_drift[e,i,j] = u_el[e,i] w_el[e,j]
        # with w_el = sum_q f shape independent of phi; the dense drift
        # matrix is U^T W, one (N,E)x(E,N) f32 matmul per step. The
        # constant part a M + dt b K_diff is assembled once. The step's
        # drift is u_el.
        E2 = vt2.num_elements
        w_el = torch.einsum("eq,qj->ej", vt2.qw, vt2.shape)
        g_el = vt2.gradphi[:, 0]                             # (E, n, 2)
        eidx = torch.arange(E2, device=device)[:, None].expand_as(vt2.dofmap)
        W32 = torch.zeros((E2, ndof), dtype=F32, device=device)
        W32.index_put_((eidx, vt2.dofmap), w_el.to(F32))
        K_diff_el = V.laplace_jacobian_el(vt2)
        A0_el = a01 * M_el + (dt * b01) * K_diff_el
        A0m32 = FA.dense_constrained_matrix_batched(
            A0_el.expand(2, *A0_el.shape), vt2.dofmap, ndof,
            free_pair).to(F32)
        fpair32 = free_pair.to(F32)
        # every term f32: an f64 coefficient would promote the whole
        # (2, N, N) stage matrix to f64 before the f32 inversion
        coef_pair = (dt * b01) * torch.tensor([1.0, -1.0], dtype=F32,
                                              device=device)
        pm_pair = torch.tensor([1.0, -1.0], dtype=F64,
                               device=device)[:, None, None, None]

        def drift(uphi_):
            """P1 rank-1 drift row factor
            u_el[e,i] = grad(phi)_e . grad(N_i)_e."""
            gphi_e = torch.einsum("ei,eid->ed", uphi_[vt2.dofmap], g_el)
            return torch.einsum("ed,eid->ei", gphi_e, g_el)

        def K_of(u_el):
            """The drift-diffusion element Jacobians for z = +1, -1 in the
            rank-1 form (as the reference)."""
            return K_diff_el[None] + pm_pair * (
                u_el[:, :, None] * w_el[:, None, :])[None]

        def dense_f32(u_el):
            U32 = torch.zeros((E2, ndof), dtype=F32, device=device)
            U32.index_put_((eidx, vt2.dofmap), u_el.to(F32))
            D = U32.T @ W32                                  # (N, N) f32
            return A0m32 + coef_pair[:, None, None] * (
                fpair32[:, :, None] * fpair32[:, None, :] * D[None])
    else:
        def drift(uphi_):
            """Species drift-diffusion element Jacobians for z = +1, -1."""
            gphi = interp_grad(uphi_[vt2.dofmap], vt2.gradphi)
            return torch.stack([
                V.drift_diffusion_jacobian_el(gphi, vt2, +1.0, False, pi),
                V.drift_diffusion_jacobian_el(gphi, vt2, -1.0, False, pi)])

        def K_of(K_pair):
            return K_pair

        def dense_f32(K_pair):
            return FA.dense_constrained_matrix_batched(
                _stage_blocks(K_pair), vt2.dofmap, ndof, free_pair).to(F32)

    if species.name == "krylov":
        # lambda_max(D^-1 A) of the first stage's c+ operator at the
        # initial potential, with 1.2 headroom: the estimate is reused as
        # the matrices drift
        A0 = (a01 * M_el + (dt * b01) * V.drift_diffusion_jacobian_el(
            interp_grad(uphi0[vt2.dofmap], vt2.gradphi), vt2, +1.0, False,
            pi))
        lam_species = 1.2 * estimate_dinv_spectral_radius(
            FA.make_constrained_operator(A0, vt2.dofmap, ndof, masks[0]),
            FA.constrained_diagonal(A0, vt2.dofmap, ndof, masks[0]),
            _spectral_probe(ndof, device))
        del A0

    def _species_dense_f32(uphi_):
        """(2, ndof, ndof) f32 constrained stage matrices at the current
        potential (the preconditioner target; exactness lives in the f64
        element blocks the refinement uses)."""
        return dense_f32(drift(uphi_))

    def _species_local_f32(uphi_):
        """(2, K, L, L) f32 constrained local stage matrices (block-RAS)."""
        return BR.assemble_local_matrices(
            ctx_ras, _stage_blocks(drift(uphi_)), free_pair)

    def build_factor(d):
        """The stage factor from the step's drift: the dense f32 stage
        inverses, or the local stage inverses (kernel 1) with the batched
        p1 coarse level on the two-level path; None where no one factor
        serves every stage."""
        if species.name == "dense":
            return batched_inv_f32(dense_f32(d))
        if species.name != "ras":
            return None
        A_stage = _stage_blocks(d)
        inv = BR.build_local_inverses(ctx_ras, A_stage, free_pair)
        if species.two_level:
            return (inv, BR.build_p1_coarse_batched(
                ctx_ras, A_stage, vt2.dofmap, free_pair, space.dof_coords))
        return inv

    def _stages(d, u_old, kind, factor):
        """All DIRK stages for both species as one batched (2, ndof)
        system from the step's drift ``d``, each to STAGE_REDUCTION. Kind
        "dense": f64 refinement preconditioned by the stage inverses
        ``factor``, one for every stage of the uniform diagonal. Otherwise
        each stage is f64 BiCGSTAB under RAS with the local inverses
        ``factor`` ("ras"; two-level with its p1 coarse level) or its own
        ("ras_stage"), or the configured Krylov variant on its batched
        diagonal ("krylov")."""
        K_pair = K_of(d)
        if kind == "dense":
            A_stage = _stage_blocks(K_pair)
            stage_apply = FA.make_operator(A_stage, vt2.dofmap, ndof)
            refine = make_inv_refine_solver(factor, A_stage, vt2.dofmap,
                                            ndof, free_pair)
        alpha_apply = FA.make_operator(K_pair, vt2.dofmap, ndof)

        mass, alpha = {}, {}      # per-level scatters, reused across stages

        def cached(cache, apply, j, levels):
            if j not in cache:
                cache[j] = apply(levels[j])
            return cache[j]

        levels = [u_old]
        iters = 0
        for i in range(stages):
            a_ii, b_ii = a_tab[i][i + 1], b_tab[i][i + 1]
            hist = torch.zeros((2, ndof), dtype=F64, device=device)
            for j in range(i + 1):
                if a_tab[i][j] != 0.0:
                    hist = hist + a_tab[i][j] * cached(mass, mass_apply, j,
                                                       levels)
                if b_tab[i][j] != 0.0:
                    hist = hist + dt * b_tab[i][j] * cached(
                        alpha, alpha_apply, j, levels)
            guess = torch.where(free_pair, levels[-1], g_pair)
            if kind == "dense":
                # the guess's mass + drift terms share the stage blocks
                r = hist + stage_apply(guess)
                r = torch.where(free_pair, r, 0.0)
                z, k = refine(r, STAGE_REDUCTION)
                levels.append(guess - z)
                iters += k
                continue
            r = (hist + a_ii * mass_apply(guess)
                 + dt * b_ii * alpha_apply(guess))
            r = torch.where(free_pair, r, 0.0)
            A_el = _stage_blocks(K_pair, a_ii, b_ii)
            op = FA.make_constrained_operator(A_el, vt2.dofmap, ndof,
                                              free_pair)
            if kind == "krylov":
                dg = FA.scatter_add_batched(torch.diagonal(
                    A_el, dim1=-2, dim2=-1), vt2.dofmap, ndof)
                dg = torch.where(free_pair, dg, 1.0)
                res = krylov_sp(op, r, torch.zeros_like(r), dg,
                                STAGE_REDUCTION, A_el=A_el, lam=lam_species)
            else:
                if species.two_level:
                    inv_s, p1_s = factor
                    M_s = BR.make_two_level_precond(ctx_ras, inv_s, None, op,
                                                    free_pair, p1_coarse=p1_s)
                else:    # "ras_stage": each stage its own local inverses
                    inv_s = (factor if kind == "ras" else
                             BR.build_local_inverses(ctx_ras, A_el, free_pair))
                    M_s = BR.make_ras_precond(ctx_ras, inv_s, free_pair)
                res = bicgstab(op, r, torch.zeros_like(r), M_s,
                               STAGE_REDUCTION, sys.linearSolverIterations)
            levels.append(guess - res.x)
            iters += res.iterations
        return levels[-1], iters

    def species_step(uphi_, ucp_, ucm_):
        """Both species' DIRK stages with a fresh factor where one serves
        every stage (the RAS factor on the mid-size tier too, as in the
        reference), else with none (the species Krylov path)."""
        with span("pnp.species_step") as sp:
            d = drift(uphi_)
            out, iters = _stages(d, torch.stack([ucp_, ucm_]), species.name,
                                 build_factor(d))
            sp.set(iterations=iters)
        return out[0], out[1], iters

    def species_factor(uphi_):
        """The stage factor at the current potential, reusable across
        steps while phi drifts: a stale factor only raises the refinement
        or Krylov counts (each stage solve checks its own residual). The
        mid-size species tier returns a tagged pair: ("inv", the dense
        f32 stage inverses) where they pass the contraction probe, else
        ("ras", the RAS factor) for this refresh window."""
        with span("pnp.species_factor"):
            d = drift(uphi_)
            if species.mid:
                X, ok = inv_f32_probe(dense_f32(d))
                if ok:
                    return ("inv", X)
                del X
                return ("ras", build_factor(d))
            return build_factor(d)

    def species_step_reuse(factor, uphi_, ucp_, ucm_):
        """Both species' stages with a possibly stale factor."""
        with span("pnp.species_step") as sp:
            kind = species.name
            if species.mid:
                tag, factor = factor
                kind = "dense" if tag == "inv" else "ras"
            out, iters = _stages(drift(uphi_), torch.stack([ucp_, ucm_]),
                                 kind, factor)
            sp.set(iterations=iters)
        return out[0], out[1], iters

    def poisson_solve(uphi_, ucp_, ucm_, phi_pre=None):
        """SLP apply at tolerance 1e-10 by the tier's own solve."""
        with span("pnp.poisson_solve", tier=poisson_tier) as sp:
            uphi2, k = solve_phi(uphi_, ucp_, ucm_,
                                 poisson_pre if phi_pre is None else phi_pre)
            sp.set(iterations=k)
        return uphi2, k

    def fused_step(uphi_, ucp_, ucm_):
        ucp_, ucm_, _ = species_step(uphi_, ucp_, ucm_)
        uphi_, _ = poisson_solve(uphi_, ucp_, ucm_)
        return uphi_, ucp_, ucm_

    def fused_step_reuse(factor, uphi_, ucp_, ucm_):
        ucp2, ucm2, _ = species_step_reuse(factor, uphi_, ucp_, ucm_)
        uphi2, _ = poisson_solve(uphi_, ucp2, ucm2)
        return uphi2, ucp2, ucm2

    def scan_steps(state, n_steps: int):
        for _ in range(n_steps):
            state = fused_step(*state)
        return state

    # the factor-reuse entry points exist only where one factor serves
    # every stage (None elsewhere, as in the reference)
    factor_kind = species.name if species.name in ("dense", "ras") else None
    has_factor = factor_kind is not None
    return PnpSystem(
        sys=sys, space=space, pb=pb, pb_newton_iterations=pb_iters,
        uphi0=uphi0, ucp0=ucp0, ucm0=ucm0,
        species_step=species_step, poisson_solve=poisson_solve,
        fused_step=fused_step, scan_steps=scan_steps,
        ionflux_tables=build_ionflux_tables(space, sys.cylindrical, pi,
                                            sys.n_surfaces, device),
        dt=dt, species_factor=species_factor if has_factor else None,
        species_step_reuse=species_step_reuse if has_factor else None,
        factor_kind=factor_kind, mid_species=species.mid,
        fused_step_reuse=fused_step_reuse if has_factor else None,
        species_dense_f32=(_species_dense_f32 if species.name == "dense"
                           or species.mid else None),
        species_local_f32=(_species_local_f32 if species.name == "ras"
                           else None),
        poisson_tier=poisson_tier, poisson_pre=poisson_pre,
        lam_phi=lam_phi, lam_species=lam_species,
        block_context=ctx_ras, pb_seconds=pb_seconds,
        poisson_setup_seconds=poisson_setup_seconds)


@dataclasses.dataclass
class PnpRunResult:
    phi: Any
    cp: Any
    cm: Any
    time: float
    steps: int
    pb_newton_iterations: int
    current_history: list      # [(time, ip(n_surf,), im(n_surf,)), ...]
    space: FunctionSpace
    # host-clock wall times (device synced): setup = phases A-C
    setup_seconds: float = 0.0
    pb_seconds: float = 0.0
    poisson_setup_seconds: float = 0.0
    # per step: wall ms (device synced, the factor build included), the
    # species refinements (dense) or BiCGSTAB iterations (block-RAS)
    # summed over both stages, the Poisson refinements or iterations (0
    # when the step skipped the re-solve), and whether it built a factor
    step_ms: list = dataclasses.field(default_factory=list)
    species_iterations: list = dataclasses.field(default_factory=list)
    poisson_iterations: list = dataclasses.field(default_factory=list)
    factor_rebuilt: list = dataclasses.field(default_factory=list)
    # per step, the kind of species factor it ran on: "dense", "ras", with
    # the mid-size species tier "inv" or "ras" by its window's probe, None
    # on the species Krylov path
    factor_kinds: list = dataclasses.field(default_factory=list)
    system: Any = None         # the PnpSystem the run stepped


def run_instationary_pnp_from_pb(
    sys: Sysparams,
    space: FunctionSpace,
    n_steps: Optional[int] = None,
    output_dir: Optional[str] = None,
    tableau: Optional[Tableau] = None,
    device_mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_freq: int = 0,
    resume: bool = False,
    flux_convention: str = "reference",
    presolve_potential: bool = False,
    dense_poisson_threshold: int = 8192,
    ras_block_size: int = 256,
    ras_refresh_every: Optional[int] = None,
    poisson_inv_threshold: int = 49152,
    species_inv_threshold: int = 0,
    device=None,
) -> PnpRunResult:
    """Run phases A-D on ``device`` (default: the current CUDA device;
    raises without one). ``presolve_potential`` solves Poisson
    once before the loop (a deviation switch: the reference's first
    species step sees the raw Dirichlet bias jump).

    ``ras_refresh_every`` (default 4 on the block-RAS tier, 1 on the
    dense tier): the block-RAS species factor is rebuilt on steps whose
    absolute index is a multiple of it (and on the first step run), so a
    resumed run keeps the uninterrupted run's schedule; in between, steps
    reuse it. The dense tier always builds a fresh factor.
    ``device_mesh``: see :func:`build_pnp_system`; under ranks only the
    coordinator writes ``output_dir`` and checkpoints."""
    mesh, device = element_mesh(device_mesh, device)
    writes = mesh is None or is_coordinator()
    if not writes:
        output_dir = None
    n_steps = sys.nSteps if n_steps is None else n_steps
    t_setup = _time.perf_counter()
    system = build_pnp_system(sys, space, tableau, mesh,
                              dense_poisson_threshold=dense_poisson_threshold,
                              ras_block_size=ras_block_size,
                              poisson_inv_threshold=poisson_inv_threshold,
                              species_inv_threshold=species_inv_threshold,
                              device=device)
    if ras_refresh_every is None:
        ras_refresh_every = 4 if system.factor_kind == "ras" else 1
    uphi, ucp, ucm = system.uphi0, system.ucp0, system.ucm0
    dt = system.dt
    if presolve_potential:
        uphi, _ = system.poisson_solve(uphi, ucp, ucm)
    synchronize(device)
    setup_seconds = _time.perf_counter() - t_setup

    # ---- Phase D: time loop ---------------------------------------------
    time = 0.0
    start_step = 0
    if resume and checkpoint_path:
        ck = load_checkpoint(checkpoint_path, sys)
        if ck is not None:
            uphi, ucp, ucm = (f64(ck[k], device) for k in ("phi", "cp", "cm"))
            time, start_step = ck["time"], ck["step"]

    current_writer = None
    output_counter = 0
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        current_writer = CurrentWriter(os.path.join(output_dir, "current.dat"))
        for name, vec in (("phi", uphi), ("cp", ucp), ("cm", ucm)):
            write_dat(space, host_copy(vec),
                      os.path.join(output_dir, f"{name}.dat"))

    history, step_ms = [], []
    species_its, poisson_its, rebuilt, kinds = [], [], [], []
    use_ras_reuse = ras_refresh_every > 1 and system.factor_kind == "ras"
    ras_factor = None
    try:
        for i in range(start_step, n_steps):
            with span("pnp.step", step=i):
                t_step = _time.perf_counter()
                # species stages, then the Poisson re-solve on the cadence
                fresh = True
                if use_ras_reuse:
                    fresh = ras_factor is None or i % ras_refresh_every == 0
                    if fresh:
                        ras_factor = system.species_factor(uphi)
                    ucp, ucm, k = system.species_step_reuse(ras_factor, uphi,
                                                            ucp, ucm)
                else:
                    ucp, ucm, k = system.species_step(uphi, ucp, ucm)
                kp = 0
                if i % sys.potentialUpdateFreq == 0:
                    uphi, kp = system.poisson_solve(uphi, ucp, ucm)
                synchronize(device)
                step_ms.append(1e3 * (_time.perf_counter() - t_step))
                species_its.append(k)
                poisson_its.append(kp)
                rebuilt.append(fresh)
                kinds.append(system.kind_of(ras_factor))
                time += dt
                if i % sys.outputFreq == 0:
                    output_counter += 1
                    with span("pnp.output"):
                        ip, im = calc_ion_flux(system.ionflux_tables, uphi,
                                               ucp, ucm,
                                               convention=flux_convention)
                        ip, im = host_copy(ip), host_copy(im)
                        history.append((time, ip, im))
                        if output_dir:
                            fields = {"phi": host_copy(uphi),
                                      "cp": host_copy(ucp),
                                      "cm": host_copy(ucm)}
                            for name, vec in fields.items():
                                write_dat(space, vec, os.path.join(
                                    output_dir,
                                    f"{name}{output_counter:03d}.dat"))
                            write_vtu(space, fields, os.path.join(
                                output_dir, f"data{output_counter:03d}.vtu"))
                            current_writer.write(time, ip, im)
                if (writes and checkpoint_path and checkpoint_freq
                        and (i + 1) % checkpoint_freq == 0):
                    with span("pnp.checkpoint"):
                        save_checkpoint(checkpoint_path, sys, i + 1, time,
                                        host_copy(uphi), host_copy(ucp),
                                        host_copy(ucm))
                # failure guard: detect a non-finite state, dump an
                # emergency checkpoint, and abort with a diagnosable error
                if (i + 1) % 16 == 0 or i + 1 == n_steps:
                    if not host_read(torch.isfinite(uphi).all()
                                     & torch.isfinite(ucp).all()
                                     & torch.isfinite(ucm).all()):
                        if writes and checkpoint_path:
                            save_checkpoint(
                                checkpoint_path + ".emergency", sys, i + 1,
                                time, host_copy(uphi), host_copy(ucp),
                                host_copy(ucm))
                        raise FloatingPointError(
                            f"non-finite state at step {i + 1} (t={time:g}); "
                            "reduce tau or enable presolve_potential")
    finally:
        if current_writer:
            current_writer.close()

    uphi, _ = system.poisson_solve(uphi, ucp, ucm)  # final solve (ref :454)
    return PnpRunResult(
        phi=uphi, cp=ucp, cm=ucm, time=time, steps=n_steps,
        pb_newton_iterations=system.pb_newton_iterations,
        current_history=history, space=space, setup_seconds=setup_seconds,
        pb_seconds=system.pb_seconds,
        poisson_setup_seconds=system.poisson_setup_seconds, step_ms=step_ms,
        species_iterations=species_its, poisson_iterations=poisson_its,
        factor_rebuilt=rebuilt, factor_kinds=kinds, system=system)
