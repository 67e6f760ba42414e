"""Phase A: nonlinear Poisson-Boltzmann solve (port of
``pnp_tpu.workloads.pb``).

P_k space on the full mesh, coulomb (component 0) BC table, Newton with
the accept-best line search over the config knobs, Krylov backend selected
by config; above ``ras_threshold`` dofs ``BCGS_SSORk`` becomes BiCGSTAB
under block-RAS with exact local inverses (:mod:`..solvers.block_ras`),
rebuilt at every Jacobian assembly. The element residual and the element
Jacobian come from the fused PB kernel, each from the variant that writes
that output alone (:class:`..operators.kernels.PBElement`, prepared once
per context: CUDA on a CUDA device, its plain version on the CPU).

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
from ..solvers import block_ras as BR
from ..solvers.amg import make_amg_context
from ..solvers.krylov import bicgstab
from ..solvers.newton import newton_solve, NewtonParams, NewtonResult
from ..solvers.linear_problem import make_krylov_solver
from .common import ScalarContext, make_scalar_context


def pb_element(ctx: ScalarContext) -> K.PBElement:
    """The context's prepared PB element kernel, made at first use."""
    if ctx.pb_element is None:
        sys, vt = ctx.sys, ctx.vt
        ctx.pb_element = K.PBElement(vt.shape, vt.gradphi, vt.qw, vt.qy,
                                     sys.l_b, sys.c0, sys.cylindrical, sys.pi)
    return ctx.pb_element


def make_pb_residual(ctx: ScalarContext):
    element = pb_element(ctx)

    def residual(u):
        r_el, _ = element(u[ctx.dofmap], "residual")
        return ctx.constrain(ctx.scatter(r_el) + ctx.flux_vector)

    return residual


def make_pb_assemble_solve(ctx: ScalarContext, ras_threshold: int = 8192,
                           ras_block_size: int = 256):
    """Split (assemble, solve) pair for the reassemble-threshold Newton.

    ``assemble(u)`` builds the element Jacobian and the preconditioner
    factor: block-RAS local inverses above ``ras_threshold`` dofs (with
    ``BCGS_SSORk``), the assembled diagonal below; ``solve(jac_ctx, r,
    red)`` runs BiCGSTAB + RAS or the configured Krylov variant."""
    sys = ctx.sys
    amg_ctx = None
    if sys.linearSolver == "CG_AMG_SSOR":
        amg_ctx = make_amg_context(ctx.dofmap, ctx.ndof, ctx.free,
                                   dof_coords=ctx.space.dof_coords)
    krylov = make_krylov_solver(sys.linearSolver, sys.linearSolverIterations,
                                amg_ctx=amg_ctx)
    element = pb_element(ctx)
    ctx_ras = None
    if sys.linearSolver == "BCGS_SSORk" and ctx.ndof > ras_threshold:
        ctx_ras = BR.build_block_context_for_space(ctx.space, ras_block_size,
                                                   ctx.device)

    def assemble(u):
        _, A_el = element(u[ctx.dofmap], "jacobian")
        if ctx_ras is not None:
            return A_el, BR.build_local_inverses(ctx_ras, A_el, ctx.free)
        return A_el, A.constrained_diagonal(A_el, ctx.dofmap, ctx.ndof,
                                            ctx.free)

    def solve(jac_ctx, r, reduction):
        A_el, factor = jac_ctx
        op = A.make_constrained_operator(A_el, ctx.dofmap, ctx.ndof, ctx.free)
        if ctx_ras is not None:
            M = BR.make_ras_precond(ctx_ras, factor, ctx.free)
            rs = ctx.constrain(r)
            res = bicgstab(op, rs, torch.zeros_like(rs), M, reduction,
                           sys.linearSolverIterations)
            return res.x, res.iterations
        res = krylov(op, ctx.constrain(r), torch.zeros_like(r), factor,
                     reduction, A_el=A_el)
        return res.x, res.iterations

    return assemble, solve


def make_pb_linear_solver(ctx: ScalarContext, ras_threshold: int = 8192,
                          ras_block_size: int = 256):
    """Combined per-iteration assembly + solve (always reassembles)."""
    assemble, solve = make_pb_assemble_solve(ctx, ras_threshold,
                                             ras_block_size)

    def combined(u, r, reduction):
        return solve(assemble(u), r, reduction)

    return combined


def solve_pb(sys: Sysparams, space: FunctionSpace,
             dirichlet_from_config: bool = False, quad_order: int = 3,
             device=None) -> NewtonResult:
    """Solve PB on ``device`` (default: the current CUDA device; raises
    without one)."""
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
