"""Stationary diffusion / Debye-Hueckel workload (linear solve only) (port
of ``pnp_tpu.workloads.stationary_diffusion``).

Parity: reference ``stationary_diffusion`` (src/stationary_diffusion.hh:7-102)
-- P1 space, component-0 (coulomb) BC table, pure Laplace operator with
scalar Neumann fluxes (src/diff_operator.hh:95-101, no axisymmetric factor),
single ``StationaryLinearProblemSolver`` apply at tolerance 1e-10, then VTK
+ gnuplot output. The reference instantiates BCExtension without a PB field
(its fallback path cannot compile there); the interior initial values here
are 0.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import Sysparams
from ..fem import assembly as FA
from ..fem.space import FunctionSpace
from ..io.writers import write_dat, write_vtu
from ..operators import volume as V
from ..solvers.amg import make_amg_context
from ..solvers.linear_problem import make_krylov_solver
from .common import make_scalar_context


def run_stationary_diffusion(sys: Sysparams, space: FunctionSpace,
                             reduction: float = 1e-10,
                             output_dir: Optional[str] = None, device=None):
    """Returns the solved scalar field u (ndof,) and the Krylov result, on
    ``device`` (default: the current CUDA device; raises without one)."""
    # DiffOperator carries no axisymmetric factor (src/diff_operator.hh);
    # its boundary flux term likewise (":150-157")
    ctx = make_scalar_context(sys, space, component=0, quad_order=2,
                              flux_cylindrical=False, device=device)
    A_el = V.laplace_jacobian_el(ctx.vt)
    op = FA.make_constrained_operator(A_el, ctx.dofmap, ctx.ndof, ctx.free)
    diag = FA.constrained_diagonal(A_el, ctx.dofmap, ctx.ndof, ctx.free)
    amg_ctx = None
    if sys.linearSolver == "CG_AMG_SSOR":
        amg_ctx = make_amg_context(ctx.dofmap, ctx.ndof, ctx.free,
                                   dof_coords=space.dof_coords)
    krylov = make_krylov_solver(sys.linearSolver, sys.linearSolverIterations,
                                amg_ctx=amg_ctx)

    if sys.printStiffnessMatrix:
        # reference flag exists but its Dune::printmatrix call is commented
        # out (src/stationary_pnp_from_pb.hh:322); here it works: dump the
        # assembled constrained dense matrix alongside the outputs
        A = FA.dense_constrained_matrix(A_el, ctx.dofmap, ctx.ndof, ctx.free)
        np.save("stiffness_matrix.npy", A.cpu().numpy())

    u0 = torch.where(ctx.free, 0.0, ctx.dirichlet)
    r_el = V.laplace_residual_el(u0[ctx.dofmap], ctx.vt)
    r = ctx.constrain(ctx.scatter(r_el) + ctx.flux_vector)
    res = krylov(op, r, torch.zeros_like(r), diag, reduction, A_el=A_el)
    u = u0 - res.x
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        u_host = u.cpu().numpy()
        write_dat(space, u_host, os.path.join(output_dir, "solution.dat.dat"))
        write_vtu(space, {"solution": u_host},
                  os.path.join(output_dir, "yeah.vtu"))
    return u, res
