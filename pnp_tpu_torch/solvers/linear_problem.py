"""Stationary linear problem solver + Krylov backend selection (port of
``pnp_tpu.solvers.linear_problem``).

``make_krylov_solver`` maps the reference's compile-time linear-solver
variants (src/instationary_pnp_from_pb_md.hh:20-32) to runtime-selected
solvers. ``CG_AMG_SSOR`` is not ported yet (ROADMAP, "AMG").
"""

from __future__ import annotations

from typing import Callable

import torch

from .krylov import cg, bicgstab
from .precond import (jacobi_precond, chebyshev_jacobi_precond,
                      estimate_dinv_spectral_radius)


def make_krylov_solver(name: str, maxiter: int, ssor_k: int = 3):
    """Return ``solve(op, b, x0, diag, reduction, A_el=None, lam=None)``.

      BCGS_SSORk  -> BiCGSTAB + Chebyshev-Jacobi(k)
      BCGS_NOPREC -> BiCGSTAB
      CG_NOPREC   -> CG
      CG_Jacobi   -> CG + Jacobi
      BCGS_Jacobi -> BiCGSTAB + Jacobi (rebuild-only variant)
    """
    if name == "BCGS_NOPREC":
        def solve(op, b, x0, diag, reduction, A_el=None, lam=None):
            return bicgstab(op, b, x0, None, reduction, maxiter)
    elif name == "CG_NOPREC":
        def solve(op, b, x0, diag, reduction, A_el=None, lam=None):
            return cg(op, b, x0, None, reduction, maxiter)
    elif name == "CG_Jacobi":
        def solve(op, b, x0, diag, reduction, A_el=None, lam=None):
            return cg(op, b, x0, jacobi_precond(diag), reduction, maxiter)
    elif name == "BCGS_Jacobi":
        def solve(op, b, x0, diag, reduction, A_el=None, lam=None):
            return bicgstab(op, b, x0, jacobi_precond(diag), reduction,
                            maxiter)
    elif name == "BCGS_SSORk":
        def solve(op, b, x0, diag, reduction, A_el=None, lam=None):
            # lam: a precomputed lambda_max(D^-1 A) skips the power iteration
            if lam is None:
                lam = estimate_dinv_spectral_radius(op, diag, b + 1e-30)
            M = chebyshev_jacobi_precond(op, diag, lam, degree=ssor_k)
            return bicgstab(op, b, x0, M, reduction, maxiter)
    elif name == "CG_AMG_SSOR":
        raise NotImplementedError(
            "CG_AMG_SSOR is not ported yet (ROADMAP: modules to port, 'AMG')")
    else:
        raise ValueError(f"unknown linear solver variant '{name}'")
    return solve


def stationary_linear_solve(residual_fn: Callable, operator_fn: Callable,
                            diag, u, krylov_solve, reduction: float = 1e-10,
                            A_el=None):
    """One PDELab-style SLP apply: r = residual(u); J z = r; u -= z."""
    r = residual_fn(u)
    res = krylov_solve(operator_fn, r, torch.zeros_like(u), diag, reduction,
                       A_el=A_el)
    return u - res.x, res
