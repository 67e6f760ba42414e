"""Scalar volume weak forms as batched element kernels (port of
``pnp_tpu.operators.volume``).

Each kernel maps element dof values (E, n) -> per-element residual (E, n)
and analytic per-element Jacobian blocks (E, n, n); all integrals carry
the quadrature factor from :func:`.common.qfactor`. The fused CUDA kernel
(:func:`.kernels.pb_residual_jacobian`) and its plain version compute the
PB pair here, and are held against it by the tests.
"""

from __future__ import annotations

import math

import torch

from ..fem.geometry import VolumeTables
from .common import qfactor, interp, interp_grad


def stiffness_matrix(t: VolumeTables, f):
    """Element stiffness  A_ij = sum_q f_q grad(phi_i).grad(phi_j)."""
    return torch.einsum("eq,eqid,eqjd->eij", f, t.gradphi, t.gradphi)


def mass_matrix(t: VolumeTables, f):
    """Element mass  M_ij = sum_q f_q phi_i phi_j."""
    return torch.einsum("eq,qi,qj->eij", f, t.shape, t.shape)


# --- Poisson-Boltzmann:  grad u . grad v + 8 pi l_b c0 sinh(u) v -----------
# (reference: src/pb_operator.hh:117)

def pb_residual_el(ue, t: VolumeTables, l_b, c0, cylindrical, pi):
    f = qfactor(t, cylindrical, pi)
    u = interp(ue, t.shape)
    gu = interp_grad(ue, t.gradphi)
    coef = 8.0 * pi * l_b * c0
    r = torch.einsum("eqd,eqid,eq->ei", gu, t.gradphi, f)
    return r + torch.einsum("eq,qi,eq->ei", coef * torch.sinh(u), t.shape, f)


def pb_jacobian_el(ue, t: VolumeTables, l_b, c0, cylindrical, pi):
    f = qfactor(t, cylindrical, pi)
    u = interp(ue, t.shape)
    coef = 8.0 * pi * l_b * c0
    A = stiffness_matrix(t, f)
    return A + torch.einsum("eq,qi,qj->eij", f * coef * torch.cosh(u),
                            t.shape, t.shape)


# --- decoupled Poisson:  grad u . grad v + 4 pi l_b (cm - cp) v ------------
# (reference: src/poisson_operator.hh:121-123; cp/cm are frozen fields)

def poisson_residual_el(ue, cpe, cme, t: VolumeTables, l_b, cylindrical, pi):
    f = qfactor(t, cylindrical, pi)
    gu = interp_grad(ue, t.gradphi)
    cp = interp(cpe, t.shape)
    cm = interp(cme, t.shape)
    r = torch.einsum("eqd,eqid,eq->ei", gu, t.gradphi, f)
    return r + torch.einsum("eq,qi,eq->ei", 4.0 * pi * l_b * (cm - cp),
                            t.shape, f)


def poisson_jacobian_el(t: VolumeTables, cylindrical, pi):
    return stiffness_matrix(t, qfactor(t, cylindrical, pi))


# --- linear diffusion (Laplace):  grad u . grad v ---------------------------
# (reference: src/diff_operator.hh:95-101; no axisymmetric factor there)

def laplace_residual_el(ue, t: VolumeTables):
    gu = interp_grad(ue, t.gradphi)
    return torch.einsum("eqd,eqid,eq->ei", gu, t.gradphi, t.qw)


def laplace_jacobian_el(t: VolumeTables):
    return stiffness_matrix(t, t.qw)


# --- species drift-diffusion:  grad c . grad v + z c (grad phi . grad v) ---
# (reference: src/diffusion_operator.hh:110; valency z = +-1; the reference
#  does NOT apply the axisymmetric factor here even in cylindrical runs —
#  reproduced, the flag is the caller's choice)

def drift_diffusion_residual_el(ce, gphi, t: VolumeTables, valency,
                                cylindrical=False, pi=math.pi):
    """``gphi`` is grad(phi) at quad points (E, nq, 2), from the frozen
    potential's dof vector via :func:`.common.interp_grad`."""
    f = qfactor(t, cylindrical, pi)
    c = interp(ce, t.shape)
    gc = interp_grad(ce, t.gradphi)
    r = torch.einsum("eqd,eqid,eq->ei", gc, t.gradphi, f)
    return r + valency * torch.einsum("eq,eqd,eqid,eq->ei", c, gphi,
                                      t.gradphi, f)


def drift_diffusion_jacobian_el(gphi, t: VolumeTables, valency,
                                cylindrical=False, pi=math.pi):
    f = qfactor(t, cylindrical, pi)
    A = stiffness_matrix(t, f)
    return A + valency * torch.einsum("eq,eqd,eqid,qj->eij", f, gphi,
                                      t.gradphi, t.shape)


# --- scalar L2 mass:  c v ---------------------------------------------------
# (reference: src/diffusion_toperator.hh:69-71, no tau scaling, no
#  axisymmetric factor by default)

def mass_residual_el(ce, t: VolumeTables, scale=1.0, cylindrical=False,
                     pi=math.pi):
    f = qfactor(t, cylindrical, pi) * scale
    c = interp(ce, t.shape)
    return torch.einsum("eq,qi,eq->ei", c, t.shape, f)


def mass_jacobian_el(t: VolumeTables, scale=1.0, cylindrical=False,
                     pi=math.pi):
    return mass_matrix(t, qfactor(t, cylindrical, pi) * scale)
