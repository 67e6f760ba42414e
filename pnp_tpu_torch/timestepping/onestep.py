"""One-step time stepper for linear(ized) spatial operators (port of
``pnp_tpu.timestepping.onestep``).

Counterpart of PDELab's ``OneStepGridOperator`` + ``OneStepMethod``
composition (reference: src/instationary_pnp_from_pb_md.hh:372-391): stage
systems are formed from per-element mass and stiffness blocks

    (A[i][i] M + dt B[i][i] K) u_i = -(accumulated history + dt B[i][i] f)

and solved matrix-free by the configured Krylov backend with homogeneous
Dirichlet corrections (the stage iterate's constrained dofs are pre-set to
the boundary values at the stage time, as PDELab's ``osm.apply(t, dt, u,
bc_fn, unew)`` interpolates them; src/instationary_pnp_from_pb_md.hh:422).

``explicit`` tableaux yield a mass-matrix solve per stage (PDELab
``ExplicitOneStepMethod``, src/instationary_pnp_from_pb.hh:375-381), with
the CFL controller reproduced by :func:`cfl_timestep`.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..fem import assembly as FA
from .tableaux import Tableau


class LinearOneStepMethod:
    """Integrates  d/dt m(u) + alpha(u) = 0  for one step of a tableau.

    Parameters
    ----------
    tableau:      the time-stepping scheme.
    mass_el:      (E, n, n) element mass blocks (the scheme's m residual).
    stiff_el:     (E, n, n) element spatial blocks (alpha's Jacobian).
    flux:         (ndof,) constant part of alpha (Neumann terms; 0 if none).
    dofmap:       (E, n) dof map.
    free:         (ndof,) bool mask (True = unconstrained).
    krylov_solve: (op, b, x0, diag, reduction) -> KrylovResult.
    reduction:    linear solve reduction per stage (reference: 1e-5,
                  src/instationary_pnp_from_pb_md.hh:383-386).
    dirichlet_fn: stage_time -> (ndof,) Dirichlet values (constrained dofs).

    Every tensor lies on one device; the step runs there.
    """

    def __init__(self, tableau: Tableau, mass_el, stiff_el, flux, dofmap,
                 ndof: int, free, krylov_solve, reduction: float,
                 dirichlet_fn: Callable):
        self.tab = tableau
        self.M_el = mass_el
        self.K_el = stiff_el
        self.flux = flux
        self.dofmap = dofmap
        self.ndof = ndof
        self.free = free
        self.krylov = krylov_solve
        self.reduction = reduction
        self.dirichlet_fn = dirichlet_fn

    def _mass(self, u):
        return FA.spmv(self.M_el, u, self.dofmap, self.ndof)

    def _alpha(self, u):
        return FA.spmv(self.K_el, u, self.dofmap, self.ndof) + self.flux

    def apply(self, t, dt, u_old):
        """One full step; returns (u_new, total_krylov_iters)."""
        tab = self.tab
        levels = [u_old]
        total_iters = 0
        for i in range(tab.stages):
            a_ii = float(tab.A[i, i + 1])
            b_ii = float(tab.B[i, i + 1])
            stage_time = t + float(tab.D[i + 1]) * dt
            # history residual from previous levels
            hist = torch.zeros(self.ndof, dtype=u_old.dtype,
                               device=u_old.device)
            for j in range(i + 1):
                a_ij = float(tab.A[i, j])
                b_ij = float(tab.B[i, j])
                if a_ij != 0.0:
                    hist = hist + a_ij * self._mass(levels[j])
                if b_ij != 0.0:
                    hist = hist + dt * b_ij * self._alpha(levels[j])
            g = self.dirichlet_fn(stage_time)
            u_guess = torch.where(self.free, levels[-1], g)
            if b_ii == 0.0:
                # explicit stage: mass-only system
                A_el = a_ii * self.M_el
                r_full = hist + a_ii * self._mass(u_guess)
            else:
                A_el = a_ii * self.M_el + (dt * b_ii) * self.K_el
                r_full = hist + a_ii * self._mass(u_guess) \
                    + dt * b_ii * self._alpha(u_guess)
            op = FA.make_constrained_operator(A_el, self.dofmap, self.ndof,
                                              self.free)
            diag = FA.constrained_diagonal(A_el, self.dofmap, self.ndof,
                                           self.free)
            r = torch.where(self.free, r_full, 0.0)
            res = self.krylov(op, r, torch.zeros_like(r), diag,
                              self.reduction)
            levels.append(u_guess - res.x)
            total_iters += int(res.iterations)
        return levels[-1], total_iters


def cfl_timestep(mesh_h_min: float, diffusion: float = 1.0,
                 safety: float = 0.001) -> float:
    """Explicit-Euler CFL bound (reference CFLTimeController(0.001),
    src/instationary_pnp_from_pb.hh:377): dt = safety * h_min^2 / D."""
    return safety * mesh_h_min ** 2 / diffusion
