"""Shared helpers for batched weak-form kernels (port of
``pnp_tpu.operators.common``).

The reference chunks the element axis to bound XLA's lane-padded TPU
temporaries; the port contracts all elements at once.
"""

from __future__ import annotations

import torch

from ..fem.geometry import VolumeTables, BoundaryTables


def qfactor(t: VolumeTables, cylindrical: bool, pi: float):
    """Quadrature factor w*|detJ| with optional axisymmetric 2*pi*y weight.

    Parity: the reference multiplies by ``globalpos[1]*2*PI`` when
    ``cylindrical`` (src/pb_operator.hh:85-86), in the PB/Poisson/PNP
    operators but NOT in the species drift-diffusion and scalar mass
    operators — callers wire the flag per operator.
    """
    f = t.qw
    if cylindrical:
        f = f * t.qy * (2.0 * pi)
    return f


def bqfactor(t: BoundaryTables, cylindrical: bool, pi: float):
    f = t.qw
    if cylindrical:
        f = f * t.qy * (2.0 * pi)
    return f


def interp(ue, shape):
    """Element dof values (E, n) x shape table (nq, n) -> u at quad (E, nq)."""
    return torch.einsum("ei,qi->eq", ue, shape)


def interp_grad(ue, gradphi):
    """(E, n) x (E, nq, n, 2) -> grad u at quad points (E, nq, 2)."""
    return torch.einsum("ei,eqid->eqd", ue, gradphi)
