"""Phase A: nonlinear Poisson-Boltzmann solve (port of
``pnp_tpu.workloads.pb``, dense tier).

P_k space on the full mesh, coulomb (component 0) BC table, Newton with
the accept-best line search over the config knobs, Krylov backend selected
by config. The element residual and Jacobian both come from the fused PB
kernel (:func:`..operators.kernels.pb_residual_jacobian`: CUDA on a CUDA
device, its plain version on the CPU).

As in the reference, Dirichlet values are not interpolated into the
initial iterate (u0 = 0), so PB is solved with phi = 0 on all Dirichlet
surfaces; ``dirichlet_from_config=True`` imposes the configured values.
"""

from __future__ import annotations

import torch

from ..config import Sysparams
from ..fem import assembly as A
from ..fem.space import FunctionSpace
from ..operators import kernels as K
from ..solvers.newton import newton_solve, NewtonParams, NewtonResult
from ..solvers.linear_problem import make_krylov_solver
from .common import ScalarContext, make_scalar_context


def _pb_element(ctx: ScalarContext, u):
    sys, vt = ctx.sys, ctx.vt
    return K.pb_residual_jacobian(u[ctx.dofmap], vt.shape, vt.gradphi,
                                  vt.qw, vt.qy, sys.l_b, sys.c0,
                                  sys.cylindrical, sys.pi)


def make_pb_residual(ctx: ScalarContext):
    def residual(u):
        r_el, _ = _pb_element(ctx, u)
        return ctx.constrain(ctx.scatter(r_el) + ctx.flux_vector)

    return residual


def make_pb_assemble_solve(ctx: ScalarContext, ras_threshold: int = 8192):
    """Split (assemble, solve) pair for the reassemble-threshold Newton:
    ``assemble(u)`` builds the element Jacobian and the assembled diagonal,
    ``solve(jac_ctx, r, red)`` runs the configured Krylov variant."""
    sys = ctx.sys
    if sys.linearSolver == "BCGS_SSORk" and ctx.ndof > ras_threshold:
        raise NotImplementedError(
            f"PB at {ctx.ndof} dofs needs the block-RAS preconditioner "
            "(ROADMAP: modules to port, 'Block-RAS tier')")
    krylov = make_krylov_solver(sys.linearSolver, sys.linearSolverIterations)

    def assemble(u):
        _, A_el = _pb_element(ctx, u)
        return A_el, A.constrained_diagonal(A_el, ctx.dofmap, ctx.ndof,
                                            ctx.free)

    def solve(jac_ctx, r, reduction):
        A_el, diag = jac_ctx
        op = A.make_constrained_operator(A_el, ctx.dofmap, ctx.ndof, ctx.free)
        res = krylov(op, ctx.constrain(r), torch.zeros_like(r), diag,
                     reduction, A_el=A_el)
        return res.x, res.iterations

    return assemble, solve


def solve_pb(sys: Sysparams, space: FunctionSpace,
             dirichlet_from_config: bool = False, quad_order: int = 3,
             device="cpu") -> NewtonResult:
    ctx = make_scalar_context(sys, space, component=0, quad_order=quad_order,
                              device=device)
    u0 = torch.zeros(ctx.ndof, dtype=torch.float64, device=ctx.device)
    if dirichlet_from_config:
        u0 = torch.where(ctx.free, u0, ctx.dirichlet)
    params = NewtonParams(
        reduction=sys.newtonReduction,
        min_linear_reduction=sys.newtonMinLinearReduction,
        max_iterations=int(sys.newtonMaxIterations),
        line_search_max=int(sys.newtonLineSearchMaxIteration),
        verbosity=sys.verbosity,
        reassemble_threshold=sys.newtonReassembleThreshold,
    )
    assemble, solve = make_pb_assemble_solve(ctx)
    return newton_solve(make_pb_residual(ctx), None, u0, params,
                        assemble_fn=assemble, assembled_solve_fn=solve)
