"""The production workload: instationary PNP bootstrapped from a PB solve.

Port of ``pnp_tpu.workloads.instationary_pnp_from_pb``, dense tier
(ndof <= ``dense_poisson_threshold``, one device, uniform tableau
diagonal). Parity: reference ``instationary_pnp_md``
(src/instationary_pnp_from_pb_md.hh:112-456). Phases:

  A. nonlinear PB Newton solve on the coulomb BC table (workloads/pb.py;
     element residual and Jacobian from the fused PB kernel)
  B. initial (phi, c+, c-) from the PB solution: phi = phi_PB,
     c+- = c0 exp(-+ phi_PB), Dirichlet dofs from config
  C. one-time setup: species mass and Poisson stiffness blocks, and the
     exact affine Poisson form phi* = q + P (cm - cp) from a host-grade
     f64 inverse of the constant constrained Poisson matrix
  D. time loop: both species' Alexander-2 stages solved together as one
     (2, ndof) batch — f32 stage matrices (P1 drift as one rank-1 matmul)
     inverted by the Gauss-Jordan kernel, then f64 refinement against the
     exact element operator — and the Poisson re-solve every
     potentialUpdateFreq; ion flux + output every outputFreq; final
     Poisson solve.

Reference behaviours kept: the species operators carry NO axisymmetric
weight even in cylindrical runs (src/diffusion_operator.hh:100; PB and
Poisson do carry it); quadrature orders 3 (PB/Poisson), 2 (species
spatial), 5 (species mass); dt = tau.

Not ported yet (ROADMAP): the block-RAS tier above the dense threshold,
the multi-device mesh, the species Krylov path of non-uniform tableau
diagonals, and the factor-reuse entry points (``species_factor``,
``species_step_reuse``, ``fused_step_reuse``).
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Any, Callable, Optional

import numpy as np
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
from ..solvers.direct import batched_inv_f32, make_inv_refine_solver
from .common import make_scalar_context
from .pb import solve_pb

F32 = torch.float32
F64 = torch.float64


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


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
    species_step: Callable       # (uphi, ucp, ucm) -> (ucp', ucm', refinements)
    poisson_solve: Callable      # (uphi, ucp, ucm) -> (uphi', iters)
    fused_step: Callable         # (uphi, ucp, ucm) -> (uphi', ucp', ucm')
    scan_steps: Callable         # ((uphi, ucp, ucm), n) -> (uphi', ucp', ucm')
    ionflux_tables: Any
    dt: float
    # (uphi) -> (2, ndof, ndof) f32 constrained stage matrices
    species_dense_f32: Any = None
    pb_seconds: float = 0.0      # phase A wall time (host clock, synced)


def build_pnp_system(
    sys: Sysparams,
    space: FunctionSpace,
    tableau: Optional[Tableau] = None,
    device_mesh=None,
    pb_field=None,
    dense_poisson_threshold: int = 8192,
    stage_reduction: float = 1e-5,
    device="cpu",
) -> PnpSystem:
    """Build the production pipeline on ``device`` (dense tier).

    ``stage_reduction``: relative tolerance of the species stage solves
    (reference 1e-5, src/instationary_pnp_from_pb_md.hh:383-386).
    ``dense_poisson_threshold``: the dense tier's size bound; above it the
    reference switches to block-RAS, which is not ported yet.
    """
    tab = tableau if tableau is not None else alexander2()
    dt = sys.tau
    pi = sys.pi
    ndof = space.ndof
    if device_mesh is not None:
        raise NotImplementedError(
            "multi-device runs are not ported yet "
            "(ROADMAP: modules to port, 'Multi-device')")
    if ndof > dense_poisson_threshold:
        raise NotImplementedError(
            f"{ndof} dofs is above the dense tier ({dense_poisson_threshold});"
            " the block-RAS tier is not ported yet "
            "(ROADMAP: modules to port, 'Block-RAS tier')")
    a_tab = [[float(v) for v in row] for row in tab.A]
    b_tab = [[float(v) for v in row] for row in tab.B]
    stages = tab.stages
    if not all(a_tab[i][i + 1] == a_tab[0][1] and b_tab[i][i + 1] == b_tab[0][1]
               for i in range(stages)):
        raise NotImplementedError(
            "non-uniform tableau diagonals need the species Krylov path "
            "(ROADMAP: modules to port, 'Species Krylov path')")
    a01, b01 = a_tab[0][1], b_tab[0][1]
    if sys.linearSolver == "CG_AMG_SSOR":
        raise NotImplementedError(
            "CG_AMG_SSOR is not ported yet (ROADMAP: modules to port, 'AMG')")

    # ---- Phase A: PB bootstrap ------------------------------------------
    t0 = _time.perf_counter()
    if pb_field is None:
        pb_res = solve_pb(sys, space, device=device)
        pb, pb_iters = pb_res.u, pb_res.iterations
    else:
        pb, pb_iters = torch.as_tensor(pb_field, dtype=F64, device=device), 0
    _sync(device)
    pb_seconds = _time.perf_counter() - t0

    # ---- Phase B: constraints + initial fields --------------------------
    ctx_phi = make_scalar_context(sys, space, component=0, quad_order=3,
                                  device=device)
    masks = [torch.as_tensor(C.free_dof_mask(space, sys, c), device=device)
             for c in (1, 2)]
    free_pair = torch.stack(masks)                          # (2, ndof)
    g_pair = torch.stack([f64(C.dirichlet_dof_values(space, sys, c), device)
                          for c in (1, 2)])
    pb_np = _host(pb)
    uphi0, ucp0, ucm0 = (
        f64(C.interpolate_with_pb_fallback(space, sys, c, pb_np), device)
        for c in (0, 1, 2))

    # ---- Phase C: operators + the exact affine Poisson form -------------
    # species orders 2 (spatial) / 5 (mass), raised with the space degree
    vt2 = build_volume_tables(space, max(2, 2 * space.degree), device)
    vt5 = build_volume_tables(space, max(5, 2 * space.degree + 1), device)
    vt_phi = ctx_phi.vt

    M_el = V.mass_jacobian_el(vt5, 1.0, False, pi)   # planar (ref behaviour)
    A_phi_el = V.poisson_jacobian_el(vt_phi, sys.cylindrical, pi)
    A_phi_dense = FA.dense_constrained_matrix(A_phi_el, vt_phi.dofmap, ndof,
                                              ctx_phi.free)
    # charge coupling: the Poisson residual is affine in w = cm - cp,
    # r = A u + M4 w + flux; M4 dense with Dirichlet rows zeroed
    M4_el = V.mass_jacobian_el(vt_phi, 4.0 * sys.l_b * pi, sys.cylindrical,
                               pi)
    M4_dense = torch.zeros((ndof, ndof), dtype=F64, device=device)
    E_phi, n_phi = vt_phi.dofmap.shape
    M4_dense.index_put_(
        (vt_phi.dofmap[:, :, None].expand(E_phi, n_phi, n_phi),
         vt_phi.dofmap[:, None, :].expand(E_phi, n_phi, n_phi)),
        M4_el, accumulate=True)
    M4_dense = M4_dense * ctx_phi.free.to(F64)[:, None]
    u_bc = torch.where(ctx_phi.free, 0.0, ctx_phi.dirichlet)
    rhs_bc = ctx_phi.constrain(FA.spmv(A_phi_el, u_bc, vt_phi.dofmap, ndof)
                               + ctx_phi.flux_vector)
    # phi* = q + P (cm - cp),  P = -Ainv M4,  q = u_bc - Ainv r(u_bc): exact
    # for any current phi (the decoupled Poisson operator is constant).
    # One-time f64 inverse, outside any kernel (as in the reference).
    Ainv = torch.linalg.inv(A_phi_dense)
    P_phi = -(Ainv @ M4_dense)
    q_phi = u_bc - Ainv @ rhs_bc
    del Ainv, A_phi_dense, M4_dense

    # ---- species stage matrices ------------------------------------------
    use_fast_dense = space.degree == 1
    if use_fast_dense:
        # P1: grad(phi) and the basis gradients are constant per element,
        # so the drift block is rank-1, A_drift[e,i,j] = u_el[e,i] w_el[e,j]
        # with w_el = sum_q f shape independent of phi; the dense drift
        # matrix is U^T W, one (N,E)x(E,N) f32 matmul per step. The
        # constant part a M + dt b K_diff is assembled once.
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

    def _drift_u_el(uphi_):
        """P1 rank-1 drift row factor u_el[e,i] = grad(phi)_e . grad(N_i)_e."""
        gphi_e = torch.einsum("ei,eid->ed", uphi_[vt2.dofmap], g_el)
        return torch.einsum("ed,eid->ei", gphi_e, g_el)

    def _build_K_pair(uphi_, u_el=None):
        """Species drift-diffusion element Jacobians for z = +1, -1."""
        if use_fast_dense:
            if u_el is None:
                u_el = _drift_u_el(uphi_)
            drift = u_el[:, :, None] * w_el[:, None, :]
            return K_diff_el[None] + pm_pair * drift[None]
        gphi = interp_grad(uphi_[vt2.dofmap], vt2.gradphi)
        return torch.stack([
            V.drift_diffusion_jacobian_el(gphi, vt2, +1.0, False, pi),
            V.drift_diffusion_jacobian_el(gphi, vt2, -1.0, False, pi)])

    def _species_dense_f32(uphi_, u_el=None):
        """(2, ndof, ndof) f32 constrained stage matrices at the current
        potential (the preconditioner target; exactness lives in the f64
        element blocks the refinement uses)."""
        if use_fast_dense:
            if u_el is None:
                u_el = _drift_u_el(uphi_)
            U32 = torch.zeros((E2, ndof), dtype=F32, device=device)
            U32.index_put_((eidx, vt2.dofmap), u_el.to(F32))
            D = U32.T @ W32                                  # (N, N) f32
            return A0m32 + coef_pair[:, None, None] * (
                fpair32[:, :, None] * fpair32[:, None, :] * D[None])
        A_stage = a01 * M_el[None] + (dt * b01) * _build_K_pair(uphi_)
        return FA.dense_constrained_matrix_batched(
            A_stage, vt2.dofmap, ndof, free_pair).to(F32)

    def _species_pair_onestep(K_pair, u_old, factor):
        """All DIRK stages for both species as one batched (2, ndof)
        system: stage solves to ``stage_reduction`` by inverse-
        preconditioned f64 refinement (one inverse serves every stage of
        the uniform diagonal)."""
        A_stage = a01 * M_el[None] + (dt * b01) * K_pair
        solve = make_inv_refine_solver(factor, A_stage, vt2.dofmap, ndof,
                                       free_pair)
        mass, alpha = {}, {}      # per-level scatters, reused across stages

        def mass_apply(j, levels):
            if j not in mass:
                ye = torch.einsum("eij,sej->sei", M_el,
                                  levels[j][:, vt5.dofmap])
                out = torch.zeros((2, ndof), dtype=F64, device=device)
                mass[j] = out.index_add_(1, vt5.dofmap.reshape(-1),
                                         ye.reshape(2, -1))
            return mass[j]

        def alpha_apply(j, levels):
            if j not in alpha:
                alpha[j] = FA.spmv_batched(K_pair, levels[j], vt2.dofmap,
                                           ndof)
            return alpha[j]

        levels = [u_old]
        refinements = 0
        for i in range(stages):
            hist = torch.zeros((2, ndof), dtype=F64, device=device)
            for j in range(i + 1):
                if a_tab[i][j] != 0.0:
                    hist = hist + a_tab[i][j] * mass_apply(j, levels)
                if b_tab[i][j] != 0.0:
                    hist = hist + dt * b_tab[i][j] * alpha_apply(j, levels)
            guess = torch.where(free_pair, levels[-1], g_pair)
            r = hist + FA.spmv_batched(A_stage, guess, vt2.dofmap, ndof)
            r = torch.where(free_pair, r, 0.0)
            z, k = solve(r, stage_reduction)
            levels.append(guess - z)
            refinements += k
        return levels[-1], refinements

    def species_step(uphi_, ucp_, ucm_):
        """Fresh stage inverse + both species' DIRK stages."""
        u_el = _drift_u_el(uphi_) if use_fast_dense else None
        K_pair = _build_K_pair(uphi_, u_el)
        factor = batched_inv_f32(_species_dense_f32(uphi_, u_el))
        out, refinements = _species_pair_onestep(
            K_pair, torch.stack([ucp_, ucm_]), factor)
        return out[0], out[1], refinements

    def poisson_solve(uphi_, ucp_, ucm_):
        """SLP apply at tolerance 1e-10 (reference :349-350), exactly, as
        the affine form's one matvec."""
        return q_phi + P_phi @ (ucm_ - ucp_), 1

    def fused_step(uphi_, ucp_, ucm_):
        ucp_, ucm_, _ = species_step(uphi_, ucp_, ucm_)
        uphi_, _ = poisson_solve(uphi_, ucp_, ucm_)
        return uphi_, ucp_, ucm_

    def scan_steps(state, n_steps: int):
        for _ in range(n_steps):
            state = fused_step(*state)
        return state

    return PnpSystem(
        sys=sys, space=space, pb=pb, pb_newton_iterations=pb_iters,
        uphi0=uphi0, ucp0=ucp0, ucm0=ucm0,
        species_step=species_step, poisson_solve=poisson_solve,
        fused_step=fused_step, scan_steps=scan_steps,
        ionflux_tables=build_ionflux_tables(space, sys.cylindrical, pi,
                                            sys.n_surfaces, device),
        dt=dt, species_dense_f32=_species_dense_f32, pb_seconds=pb_seconds)


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
    step_ms: list = dataclasses.field(default_factory=list)
    refinements: list = dataclasses.field(default_factory=list)


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
    stage_reduction: float = 1e-5,
    dense_poisson_threshold: int = 8192,
    device="cpu",
) -> PnpRunResult:
    """Run phases A-D on ``device``. ``presolve_potential`` solves Poisson
    once before the loop (a deviation switch: the reference's first
    species step sees the raw Dirichlet bias jump)."""
    n_steps = sys.nSteps if n_steps is None else n_steps
    t_setup = _time.perf_counter()
    system = build_pnp_system(sys, space, tableau, device_mesh,
                              stage_reduction=stage_reduction,
                              dense_poisson_threshold=dense_poisson_threshold,
                              device=device)
    uphi, ucp, ucm = system.uphi0, system.ucp0, system.ucm0
    dt = system.dt
    if presolve_potential:
        uphi, _ = system.poisson_solve(uphi, ucp, ucm)
    _sync(device)
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
            write_dat(space, _host(vec), os.path.join(output_dir, f"{name}.dat"))

    history, step_ms, refinements = [], [], []
    try:
        for i in range(start_step, n_steps):
            t_step = _time.perf_counter()
            # species stages, then the Poisson re-solve on the cadence
            ucp, ucm, k = system.species_step(uphi, ucp, ucm)
            if i % sys.potentialUpdateFreq == 0:
                uphi, _ = system.poisson_solve(uphi, ucp, ucm)
            _sync(device)
            step_ms.append(1e3 * (_time.perf_counter() - t_step))
            refinements.append(k)
            time += dt
            if i % sys.outputFreq == 0:
                output_counter += 1
                ip, im = calc_ion_flux(system.ionflux_tables, uphi, ucp, ucm,
                                       convention=flux_convention)
                ip, im = _host(ip), _host(im)
                history.append((time, ip, im))
                if output_dir:
                    fields = {"phi": _host(uphi), "cp": _host(ucp),
                              "cm": _host(ucm)}
                    for name, vec in fields.items():
                        write_dat(space, vec, os.path.join(
                            output_dir, f"{name}{output_counter:03d}.dat"))
                    write_vtu(space, fields, os.path.join(
                        output_dir, f"data{output_counter:03d}.vtu"))
                    current_writer.write(time, ip, im)
            if (checkpoint_path and checkpoint_freq
                    and (i + 1) % checkpoint_freq == 0):
                save_checkpoint(checkpoint_path, sys, i + 1, time,
                                _host(uphi), _host(ucp), _host(ucm))
            # failure guard: detect a non-finite state, dump an emergency
            # checkpoint, and abort with a diagnosable error
            if (i + 1) % 16 == 0 or i + 1 == n_steps:
                if not bool(torch.isfinite(uphi).all()
                            & torch.isfinite(ucp).all()
                            & torch.isfinite(ucm).all()):
                    if checkpoint_path:
                        save_checkpoint(checkpoint_path + ".emergency", sys,
                                        i + 1, time, _host(uphi), _host(ucp),
                                        _host(ucm))
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
        pb_seconds=system.pb_seconds, step_ms=step_ms,
        refinements=refinements)
