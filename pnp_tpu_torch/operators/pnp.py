"""Monolithic 3-field Poisson-Nernst-Planck operator (phi, c+, c-) (port of
``pnp_tpu.operators.pnp``).

Parity: reference src/pnp_operator.hh:165-193 (volume) and :198-315
(per-component Neumann boundary), on a lexicographically-blocked composite
space (phi dofs, then c+ dofs, then c- dofs). Weak form per quad point,
all terms axisymmetric-weighted when cylindrical:

  phi rows:  grad(phi).grad(v) + 4 pi l_b (c+ - c-) v
  c+  rows:  grad(c+).grad(v) - c+ (grad(phi).grad(v))
  c-  rows:  grad(c-).grad(v) + c- (grad(phi).grad(v))

CONVENTION NOTE: these signs are the reference's own and are internally
self-consistent (equilibria c+ = C e^{+phi}, c- = C e^{-phi} combine with
the phi row to reproduce PB), but they are the c+/c- MIRROR of the
operator-splitting production workload, whose DiffusionOperator uses
valency +1 for c+ giving c+ = C e^{-phi}
(src/diffusion_operator.hh:110 vs src/pnp_operator.hh:176-193 -- the
monolithic workloads also interpolate initial values with the e^{-phi}
convention, another latent inconsistency in that spec code).

The mass operator for instationary runs is tau * c (+/-) * v on the species
blocks only (reference src/pnp_toperator.hh:96-99; its wrong-row
accumulation bug is NOT replicated, see SURVEY.md "quirks").

Element dof layout: concat([phi_e, cp_e, cm_e]) of size 3n; the composite
global dofmap offsets each field block by the scalar space size.
"""

from __future__ import annotations

import torch

from ..fem.geometry import VolumeTables
from .common import qfactor, interp, interp_grad
from .volume import stiffness_matrix, mass_matrix


def composite_dofmap(dofmap, ndof_scalar: int):
    """(E, n) scalar dofmap -> (E, 3n) composite map with field offsets."""
    return torch.cat(
        [dofmap, dofmap + ndof_scalar, dofmap + 2 * ndof_scalar], dim=1)


def split_el(ue):
    n = ue.shape[-1] // 3
    return ue[..., :n], ue[..., n:2 * n], ue[..., 2 * n:]


def pnp_residual_el(ue, t: VolumeTables, l_b, cylindrical, pi):
    phie, cpe, cme = split_el(ue)
    f = qfactor(t, cylindrical, pi)
    cp = interp(cpe, t.shape)
    cm = interp(cme, t.shape)
    gphi = interp_grad(phie, t.gradphi)
    gcp = interp_grad(cpe, t.gradphi)
    gcm = interp_grad(cme, t.gradphi)
    # advective projection (grad phi . grad v_i) per test function
    adv = torch.einsum("eqd,eqid->eqi", gphi, t.gradphi)     # (E, nq, n)
    coef = 4.0 * pi * l_b

    r_phi = torch.einsum("eqd,eqid,eq->ei", gphi, t.gradphi, f)
    r_phi = r_phi + torch.einsum("eq,qi,eq->ei", coef * (cp - cm), t.shape, f)
    r_cp = torch.einsum("eqd,eqid,eq->ei", gcp, t.gradphi, f)
    r_cp = r_cp - torch.einsum("eq,eqi,eq->ei", cp, adv, f)
    r_cm = torch.einsum("eqd,eqid,eq->ei", gcm, t.gradphi, f)
    r_cm = r_cm + torch.einsum("eq,eqi,eq->ei", cm, adv, f)
    return torch.cat([r_phi, r_cp, r_cm], dim=1)


def pnp_jacobian_el(ue, t: VolumeTables, l_b, cylindrical, pi):
    phie, cpe, cme = split_el(ue)
    f = qfactor(t, cylindrical, pi)
    cp = interp(cpe, t.shape)
    cm = interp(cme, t.shape)
    gphi = interp_grad(phie, t.gradphi)
    adv = torch.einsum("eqd,eqid->eqi", gphi, t.gradphi)     # (E, nq, n)
    coef = 4.0 * pi * l_b

    K = stiffness_matrix(t, f)
    M = mass_matrix(t, f)

    # species blocks: d/d(phi_j) of the advective term is a c-weighted
    # stiffness kernel; d/d(c_j) adds shape-weighted advection
    J_cp_phi = -torch.einsum("eq,eqid,eqjd->eij", f * cp, t.gradphi,
                             t.gradphi)
    J_cm_phi = torch.einsum("eq,eqid,eqjd->eij", f * cm, t.gradphi,
                            t.gradphi)
    J_cp_cp = K - torch.einsum("eq,eqi,qj->eij", f, adv, t.shape)
    J_cm_cm = K + torch.einsum("eq,eqi,qj->eij", f, adv, t.shape)

    Z = torch.zeros_like(K)
    row_phi = torch.cat([K, coef * M, -coef * M], dim=2)
    row_cp = torch.cat([J_cp_phi, J_cp_cp, Z], dim=2)
    row_cm = torch.cat([J_cm_phi, Z, J_cm_cm], dim=2)
    return torch.cat([row_phi, row_cp, row_cm], dim=1)


def pnp_mass_residual_el(ue, t: VolumeTables, tau, cylindrical, pi):
    _, cpe, cme = split_el(ue)
    f = qfactor(t, cylindrical, pi)
    cp = interp(cpe, t.shape)
    cm = interp(cme, t.shape)
    r_cp = tau * torch.einsum("eq,qi,eq->ei", cp, t.shape, f)
    r_cm = tau * torch.einsum("eq,qi,eq->ei", cm, t.shape, f)
    return torch.cat([torch.zeros_like(r_cp), r_cp, r_cm], dim=1)


def pnp_mass_jacobian_el(t: VolumeTables, tau, cylindrical, pi):
    M = mass_matrix(t, qfactor(t, cylindrical, pi)) * tau
    Z = torch.zeros_like(M)
    row_phi = torch.cat([Z, Z, Z], dim=2)
    row_cp = torch.cat([Z, M, Z], dim=2)
    row_cm = torch.cat([Z, Z, M], dim=2)
    return torch.cat([row_phi, row_cp, row_cm], dim=1)
