"""Neumann flux boundary terms (port of ``pnp_tpu.operators.boundary``).

Parity: the reference accumulates ``j * phi_i * factor`` on non-Dirichlet
boundary faces (src/pb_operator.hh:180-191). The flux is independent of
the solution, so it contributes nothing to the Jacobian.
"""

from __future__ import annotations

import torch

from ..fem.geometry import BoundaryTables
from .common import bqfactor


def flux_residual_el(t: BoundaryTables, component: int, cylindrical, pi):
    """Per-boundary-edge residual (B, ndof_el) for one field component."""
    f = bqfactor(t, cylindrical, pi)                    # (B, nqb)
    j = t.flux[:, component] * t.neumann[:, component]  # (B,)
    return torch.einsum("b,bq,bqi->bi", j, f, t.shape)
