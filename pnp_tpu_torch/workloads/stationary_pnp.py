"""Monolithic stationary PNP: 3-field Newton solve (phi, c+, c-) (port of
``pnp_tpu.workloads.stationary_pnp``).

Parity: reference ``stationary_pnp`` (src/stationary_pnp.hh:92-365) and the
PB-initialized variant ``stationary_pnp_from_pb``
(src/stationary_pnp_from_pb.hh:93-440, call stack SURVEY.md 3.2):
lexicographic composite space, BCExtension initial interpolation (Gibbs
c0*exp(-+phi_PB) when bootstrapped from PB, phi_PB = 0 otherwise), full
3-field Newton on the coupled residual, BiCGSTAB linear solves
(the reference hardcodes NOVLP_BCGS_NOPREC at
src/stationary_pnp_from_pb.hh:329-331; CG variants are remapped to
BiCGSTAB here because the coupled Jacobian is nonsymmetric).

Note these reference files are behavioral specs that do not compile as-is
against datawriter.hh (SURVEY.md section 2.1); the workload surface is
reproduced, their dead writer calls are not.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Sysparams
from ..fem import assembly as FA
from ..fem import constraints as C
from ..fem.space import FunctionSpace
from ..fem.geometry import build_volume_tables, build_boundary_tables, f64
from ..operators import pnp as P
from ..operators import boundary as OB
from ..solvers.newton import newton_solve, NewtonParams, NewtonResult
from ..solvers.linear_problem import make_krylov_solver
from ..utils.device import resolve_device
from .pb import solve_pb

_MONOLITHIC_SOLVER = {
    # nonsymmetric coupled Jacobian: CG variants fall back to BiCGSTAB
    # peers, and the SPD-interval Chebyshev ("SSORk") smoother falls back
    # to plain Jacobi (valid for any spectrum shape)
    "BCGS_SSORk": "BCGS_Jacobi", "BCGS_NOPREC": "BCGS_NOPREC",
    "CG_NOPREC": "BCGS_NOPREC", "CG_Jacobi": "BCGS_Jacobi",
    "CG_AMG_SSOR": "BCGS_Jacobi",
}


def composite_state(sys: Sysparams, space: FunctionSpace, pb_dofs,
                    convention: str = "bce", device=None):
    """Initial composite vector + masks + Dirichlet values (3 * ndof), on
    ``device`` (default: the current CUDA device; raises without one).

    ``convention="bce"`` reproduces the reference BCExtension interpolation
    (c+- = c0 exp(-+ phi_PB), src/dirichlet_bc.hh:94-118). The monolithic
    operator's own equilibrium is the species MIRROR of that (see
    operators/pnp.py CONVENTION NOTE); ``convention="monolithic"`` boots
    c+- = c0 exp(+- phi_PB) so Newton starts near its operator's root --
    essential at large |phi| (e.g. the cylinder case, |phi| ~ 5, where the
    bce bootstrap is e^10 away from the monolithic equilibrium).
    """
    device = resolve_device(device)
    if isinstance(pb_dofs, torch.Tensor):
        pb_dofs = pb_dofs.detach().cpu().numpy()
    pb_true = np.asarray(pb_dofs)
    pb = pb_true
    if convention == "monolithic":
        pb = -pb   # mirror: swaps the exp signs in the fallback
    u0 = np.concatenate([
        C.interpolate_with_pb_fallback(
            space, sys, 0, pb_true),              # phi keeps the true sign
        C.interpolate_with_pb_fallback(space, sys, 1, pb),
        C.interpolate_with_pb_fallback(space, sys, 2, pb),
    ])
    free = np.concatenate([C.free_dof_mask(space, sys, c) for c in range(3)])
    g = np.concatenate([C.dirichlet_dof_values(space, sys, c) for c in range(3)])
    return (f64(u0, device), torch.as_tensor(free, device=device),
            f64(g, device))


def run_stationary_pnp(sys: Sysparams, space: FunctionSpace,
                       from_pb: bool = True,
                       quad_order: int = 3,
                       bootstrap: str = "monolithic",
                       device=None) -> NewtonResult:
    """The 3-field Newton solve on ``device`` (default: the current CUDA
    device; raises without one)."""
    device = resolve_device(device)
    ndof = space.ndof
    pb = (solve_pb(sys, space, device=device).u if from_pb
          else torch.zeros(ndof, dtype=torch.float64, device=device))
    u0, free, _ = composite_state(sys, space, pb, convention=bootstrap,
                                  device=device)

    quad_order = max(quad_order, 2 * space.degree)
    vt = build_volume_tables(space, quad_order, device)
    bt = build_boundary_tables(space, quad_order,
                               C.flux_table(sys, space.mesh),
                               C.neumann_flags(sys, space.mesh), device)
    cmap = P.composite_dofmap(vt.dofmap, ndof)

    # per-component Neumann flux vectors at their composite offsets
    flux = torch.zeros(3 * ndof, dtype=torch.float64, device=device)
    for comp in range(3):
        r_el = OB.flux_residual_el(bt, comp, sys.cylindrical, sys.pi)
        flux.index_add_(0, (bt.dofmap + comp * ndof).reshape(-1),
                        r_el.reshape(-1))

    def residual(u):
        r_el = P.pnp_residual_el(u[cmap], vt, sys.l_b, sys.cylindrical, sys.pi)
        r = FA.scatter_add(r_el, cmap, 3 * ndof) + flux
        return torch.where(free, r, 0.0)

    krylov = make_krylov_solver(_MONOLITHIC_SOLVER[sys.linearSolver],
                                sys.linearSolverIterations)

    # split assemble/solve: newtonReassembleThreshold (reference binding
    # src/stationary_pnp.hh:284) reuses the monolithic Jacobian across
    # fast-converging iterations
    def assemble(u):
        A_el = P.pnp_jacobian_el(u[cmap], vt, sys.l_b, sys.cylindrical, sys.pi)
        diag = FA.constrained_diagonal(A_el, cmap, 3 * ndof, free)
        return A_el, diag

    def assembled_solve(jac_ctx, r, reduction):
        A_el, diag = jac_ctx
        op = FA.make_constrained_operator(A_el, cmap, 3 * ndof, free)
        res = krylov(op, torch.where(free, r, 0.0), torch.zeros_like(r),
                     diag, reduction)
        return res.x, res.iterations

    params = NewtonParams(
        reduction=sys.newtonReduction,
        min_linear_reduction=sys.newtonMinLinearReduction,
        max_iterations=int(sys.newtonMaxIterations),
        line_search_max=int(sys.newtonLineSearchMaxIteration),
        verbosity=sys.verbosity,
        reassemble_threshold=sys.newtonReassembleThreshold,
    )
    return newton_solve(residual, None, u0, params,
                        assemble_fn=assemble, assembled_solve_fn=assembled_solve)


def split_fields(space: FunctionSpace, u):
    n = space.ndof
    return u[:n], u[n:2 * n], u[2 * n:]
