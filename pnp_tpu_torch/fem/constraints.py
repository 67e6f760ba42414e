"""Dirichlet constraints and boundary-value interpolation.

Numpy copy of ``pnp_tpu.fem.constraints`` (tests pin identical arrays).
Replacement for the reference's BC machinery:
  * ``BCType::isDirichlet`` (src/btype.hh:30-51): per-surface integer table,
    0 = Dirichlet / 1 = Neumann, per field component (0=phi, 1=c+, 2=c-)
    -> here: boolean edge/dof masks.
  * ``NonoverlappingConformingDirichletConstraints`` + ``constraints()``
    (src/instationary_pnp_from_pb_md.hh:127-144): a dof on ANY Dirichlet
    edge for a component is constrained for that component.
  * ``BCExtension`` Dirichlet/initial values (src/dirichlet_bc.hh:94-118):
    on Dirichlet dofs the configured value; elsewhere the PB-derived
    fallback phi_PB / c0*exp(-phi_PB) / c0*exp(+phi_PB). The reference's
    missing-``break`` fall-through in its bctype() helper (dirichlet_bc.hh:
    40-51) is deliberately NOT replicated (SURVEY.md quirks).
  * the per-boundary-segment flux container
    (src/instationary_pnp_from_pb_md.hh:151-176).

All of this is host-side numpy setup producing device-ready arrays.
"""

from __future__ import annotations

import numpy as np

from ..config import Sysparams, DIRICHLET
from ..meshio.mesh import Mesh
from .space import FunctionSpace

N_COMPONENTS = 3  # phi, c+, c-


def edge_btype(sys: Sysparams, mesh: Mesh) -> np.ndarray:
    """(B, 3) int BC type per boundary edge per component."""
    table = np.array(
        [[surf.btype(c) for c in range(N_COMPONENTS)] for surf in sys.surfaces],
        dtype=np.int32).reshape(-1, N_COMPONENTS)
    return table[mesh.edge_phys]


def flux_table(sys: Sysparams, mesh: Mesh) -> np.ndarray:
    """(B, 3) flux values per boundary edge per component (fluxContainer)."""
    table = np.array(
        [[surf.flux_value(c) for c in range(N_COMPONENTS)] for surf in sys.surfaces],
        dtype=np.float64).reshape(-1, N_COMPONENTS)
    return table[mesh.edge_phys]


def neumann_flags(sys: Sysparams, mesh: Mesh) -> np.ndarray:
    """(B, 3) 1.0 where the edge is Neumann (flux term active) per component."""
    return (edge_btype(sys, mesh) != DIRICHLET).astype(np.float64)


def dirichlet_dof_mask(space: FunctionSpace, sys: Sysparams, component: int) -> np.ndarray:
    """(ndof,) True where the dof is Dirichlet-constrained for the component."""
    bt = edge_btype(sys, space.mesh)[:, component]
    return space.boundary_dof_mask(bt == DIRICHLET)


def free_dof_mask(space: FunctionSpace, sys: Sysparams, component: int) -> np.ndarray:
    return ~dirichlet_dof_mask(space, sys, component)


def dirichlet_dof_values(space: FunctionSpace, sys: Sysparams, component: int) -> np.ndarray:
    """(ndof,) configured Dirichlet value per constrained dof (0 elsewhere).

    A dof shared by two Dirichlet edges of different surfaces takes the value
    of the higher-indexed boundary edge (deterministic; the reference's
    element-search order makes an arbitrary but analogous choice).
    """
    values = np.zeros(space.ndof)
    bt = edge_btype(sys, space.mesh)[:, component]
    val_per_surface = np.array(
        [surf.dirichlet_value(component) for surf in sys.surfaces])
    for e in np.nonzero(bt == DIRICHLET)[0]:
        values[space.bedge_dofs[e]] = val_per_surface[space.mesh.edge_phys[e]]
    return values


def interpolate_with_pb_fallback(
    space: FunctionSpace, sys: Sysparams, component: int,
    phi_pb_dofs: np.ndarray) -> np.ndarray:
    """BCExtension interpolation over the whole space (initial fields).

    Parity: Dune::PDELab::interpolate(bce, gfs, u)
    (src/instationary_pnp_from_pb_md.hh:329-331) with BCExtension's value
    logic (src/dirichlet_bc.hh:94-118): Gibbs-distribution concentrations
    c0*exp(-/+ phi_PB) away from Dirichlet boundaries.
    """
    phi = np.asarray(phi_pb_dofs)
    if component == 0:
        out = phi.copy()
    elif component == 1:
        out = sys.c0 * np.exp(-phi)
    else:
        out = sys.c0 * np.exp(+phi)
    mask = dirichlet_dof_mask(space, sys, component)
    out[mask] = dirichlet_dof_values(space, sys, component)[mask]
    return out
