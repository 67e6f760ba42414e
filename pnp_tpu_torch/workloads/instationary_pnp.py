"""Monolithic instationary PNP: explicit species steps + stationary phi
(port of ``pnp_tpu.workloads.instationary_pnp``).

Parity: reference ``instationary_pnp`` (src/instationary_pnp_from_pb.hh:
95-504, call stack SURVEY.md 3.3): PB bootstrap, composite PNP operator +
tau-scaled mass operator, ``ExplicitEulerParameter`` with
``CFLTimeController(0.001)`` and per-stage mass solves.

Documented deviation: the reference's mass operator has zero phi rows
(src/pnp_toperator.hh:96-99), making the explicit stage system singular in
phi -- that program is non-compiling spec code (SURVEY.md 2.1). We close the
DAE the standard index-1 way: explicit mass-solve update for the species
rows, then a stationary linear solve of the phi rows (the monolithic
operator's Poisson block) against the fresh concentrations each step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..config import Sysparams
from ..fem import assembly as FA
from ..fem import constraints as C
from ..fem.space import FunctionSpace
from ..fem.geometry import build_volume_tables, build_boundary_tables
from ..operators import volume as V
from ..operators import pnp as P
from ..operators import boundary as OB
from ..operators.common import qfactor
from ..solvers.linear_problem import make_krylov_solver
from ..timestepping.onestep import cfl_timestep
from ..utils.device import resolve_device
from .pb import solve_pb
from .stationary_pnp import composite_state


@dataclasses.dataclass
class ExplicitPnpResult:
    phi: Any
    cp: Any
    cm: Any
    time: float
    dt: float
    steps: int


def min_edge_length(space: FunctionSpace) -> float:
    mesh = space.mesh
    x = mesh.nodes[mesh.tris]
    e = np.concatenate([x[:, 1] - x[:, 0], x[:, 2] - x[:, 1], x[:, 0] - x[:, 2]])
    return float(np.linalg.norm(e, axis=1).min())


def run_instationary_pnp(sys: Sysparams, space: FunctionSpace,
                         n_steps: Optional[int] = None,
                         cfl_safety: float = 0.001,
                         device=None) -> ExplicitPnpResult:
    """Explicit-Euler species steps with a stationary phi solve each step,
    on ``device`` (default: the current CUDA device; raises without one)."""
    device = resolve_device(device)
    n_steps = sys.nSteps if n_steps is None else n_steps
    pb = solve_pb(sys, space, device=device).u
    u0, free, _ = composite_state(sys, space, pb, device=device)
    ndof = space.ndof
    phi, cp, cm = u0[:ndof], u0[ndof:2 * ndof], u0[2 * ndof:]
    free_phi = free[:ndof]
    free_cp, free_cm = free[ndof:2 * ndof], free[2 * ndof:]

    vt = build_volume_tables(space, 3, device)
    bt = build_boundary_tables(space, 3, C.flux_table(sys, space.mesh),
                               C.neumann_flags(sys, space.mesh), device)
    cmap = P.composite_dofmap(vt.dofmap, ndof)
    dofmap = vt.dofmap

    # tau-scaled species mass (cylindrical-weighted, src/pnp_toperator.hh)
    M_el = V.mass_jacobian_el(vt, sys.tau, sys.cylindrical, sys.pi)
    K_phi_el = V.stiffness_matrix(vt, qfactor(vt, sys.cylindrical, sys.pi))
    flux = torch.cat([
        FA.scatter_add(OB.flux_residual_el(bt, comp, sys.cylindrical, sys.pi),
                       bt.dofmap, ndof) for comp in range(3)])
    flux_phi = flux[:ndof]

    # CFL-controlled dt (reference CFLTimeController(0.001))
    dt = min(sys.tau, cfl_timestep(min_edge_length(space), 1.0, cfl_safety))

    krylov = make_krylov_solver("CG_Jacobi", sys.linearSolverIterations)
    coef = 4.0 * sys.pi * sys.l_b
    M_mass = V.mass_jacobian_el(vt, 1.0, sys.cylindrical, sys.pi)

    diag_M = FA.diagonal(M_el, dofmap, ndof)
    diag_K = FA.constrained_diagonal(K_phi_el, dofmap, ndof, free_phi)
    op_phi = FA.make_constrained_operator(K_phi_el, dofmap, ndof, free_phi)

    def mass_solve(rhs, free_c):
        rhs = torch.where(free_c, rhs, 0.0)
        op = FA.make_constrained_operator(M_el, dofmap, ndof, free_c)
        res = krylov(op, rhs, torch.zeros_like(rhs),
                     torch.where(free_c, diag_M, 1.0), 1e-10)
        return res.x

    def step(phi, cp, cm):
        # explicit species stage: tau M (c_new - c_old) = -dt * alpha(c_old)
        u = torch.cat([phi, cp, cm])
        r_el = P.pnp_residual_el(u[cmap], vt, sys.l_b, sys.cylindrical, sys.pi)
        r = FA.scatter_add(r_el, cmap, 3 * ndof) + flux
        cp_new = cp - mass_solve(dt * r[ndof:2 * ndof], free_cp)
        cm_new = cm - mass_solve(dt * r[2 * ndof:], free_cm)

        # index-1 closure: stationary phi solve against fresh concentrations
        rho = FA.spmv(M_mass, cp_new - cm_new, dofmap, ndof)
        r_phi = FA.spmv(K_phi_el, phi, dofmap, ndof) + coef * rho + flux_phi
        r_phi = torch.where(free_phi, r_phi, 0.0)
        res = krylov(op_phi, r_phi, torch.zeros_like(r_phi), diag_K, 1e-10)
        return phi - res.x, cp_new, cm_new

    t = 0.0
    for _ in range(n_steps):
        phi, cp, cm = step(phi, cp, cm)
        t += dt
    return ExplicitPnpResult(phi=phi, cp=cp, cm=cm, time=t, dt=dt, steps=n_steps)
