"""Precomputed per-element geometry/basis tables for batched assembly.

Port of ``pnp_tpu.fem.geometry``: the tables are computed in numpy f64
exactly as there, then placed on ``device`` as f64 tensors (dof maps as
int64, the index type torch's scatters take).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..meshio.mesh import Mesh, LOCAL_EDGES
from .quadrature import triangle_rule, interval_rule
from .space import FunctionSpace

_REF_VERTS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


@dataclasses.dataclass(frozen=True)
class VolumeTables:
    """Per-element volume quadrature tables.

    shape:   (nq, ndof_el) basis values at reference quad points.
    gradphi: (E, nq, ndof_el, 2) physical basis gradients.
    qw:      (E, nq) quad weight * |det J|  (no axisymmetric factor).
    qy:      (E, nq) global y coordinate at quad points (axisymmetric radius).
    dofmap:  (E, ndof_el) int64 global dof map.
    """

    shape: Any
    gradphi: Any
    qw: Any
    qy: Any
    dofmap: Any

    @property
    def num_elements(self) -> int:
        return self.gradphi.shape[0]


@dataclasses.dataclass(frozen=True)
class BoundaryTables:
    """Per-boundary-edge quadrature tables (element-basis trace).

    shape:  (B, nqb, ndof_el) adjacent-element basis values at edge quad pts.
    qw:     (B, nqb) quad weight * edge length.
    qy:     (B, nqb) global y at edge quad points.
    dofmap: (B, ndof_el) int64 dof map of the adjacent element.
    flux:   (B, ncomp) flux value per edge per field component.
    neumann:(B, ncomp) 1.0 where the edge is Neumann for that component.
    """

    shape: Any
    qw: Any
    qy: Any
    dofmap: Any
    flux: Any
    neumann: Any


def f64(a, device) -> torch.Tensor:
    """Host array -> f64 tensor on ``device``."""
    return torch.as_tensor(np.array(a, np.float64), device=device)


def index(a, device) -> torch.Tensor:
    """Host integer array -> int64 tensor on ``device``."""
    return torch.as_tensor(np.array(a, np.int64), device=device)


def element_jacobians(mesh: Mesh):
    """Affine maps: J (E,2,2), |detJ| (E,), J^{-T} (E,2,2) as numpy."""
    x = mesh.nodes[mesh.tris]  # (E, 3, 2)
    J = np.stack([x[:, 1] - x[:, 0], x[:, 2] - x[:, 0]], axis=2)  # columns
    det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    inv = np.empty_like(J)
    inv[:, 0, 0] = J[:, 1, 1]
    inv[:, 0, 1] = -J[:, 0, 1]
    inv[:, 1, 0] = -J[:, 1, 0]
    inv[:, 1, 1] = J[:, 0, 0]
    inv /= det[:, None, None]
    jinv_t = np.swapaxes(inv, 1, 2)
    return J, np.abs(det), jinv_t


def build_volume_tables(space: FunctionSpace, quad_order: int,
                        device="cpu") -> VolumeTables:
    mesh = space.mesh
    pts, wts = triangle_rule(quad_order)
    shape = space.ref.values(pts)                  # (nq, ndof)
    gref = space.ref.gradients(pts)                # (nq, ndof, 2)
    J, absdet, jinv_t = element_jacobians(mesh)
    gradphi = np.einsum("eab,qib->eqia", jinv_t, gref)
    qw = wts[None, :] * absdet[:, None]
    x0 = mesh.nodes[mesh.tris[:, 0]]               # (E, 2)
    qpts = x0[:, None, :] + np.einsum("eab,qb->eqa", J, pts)
    return VolumeTables(
        shape=f64(shape, device),
        gradphi=f64(gradphi, device),
        qw=f64(qw, device),
        qy=f64(qpts[..., 1], device),
        dofmap=index(space.dofmap, device),
    )


def build_boundary_tables(
    space: FunctionSpace,
    quad_order: int,
    flux: np.ndarray,
    neumann: np.ndarray,
    device="cpu",
) -> BoundaryTables:
    """Edge quadrature tables; ``flux``/``neumann`` are (B, ncomp)."""
    mesh = space.mesh
    t, w = interval_rule(quad_order)               # (nqb,), on [0, 1]
    nqb = t.shape[0]
    B = mesh.num_boundary_edges

    la = LOCAL_EDGES[mesh.edge_local, 0]           # (B,)
    lb = LOCAL_EDGES[mesh.edge_local, 1]
    ra = _REF_VERTS[la]                            # (B, 2)
    rb = _REF_VERTS[lb]
    locs = ra[:, None, :] * (1 - t)[None, :, None] + rb[:, None, :] * t[None, :, None]

    vals = space.ref.values(locs.reshape(-1, 2))   # (B*nqb, ndof)
    shape = vals.reshape(B, nqb, -1)

    xa = mesh.nodes[mesh.tris[mesh.edge_tri, 0]]   # x0 of adjacent tri, (B, 2)
    J, _, _ = element_jacobians(mesh)
    Jb = J[mesh.edge_tri]                          # (B, 2, 2)
    qpts = xa[:, None, :] + np.einsum("bij,bqj->bqi", Jb, locs)
    pa = mesh.nodes[mesh.edges[:, 0]]
    pb = mesh.nodes[mesh.edges[:, 1]]
    length = np.linalg.norm(pb - pa, axis=1)       # (B,)
    qw = w[None, :] * length[:, None]

    return BoundaryTables(
        shape=f64(shape, device),
        qw=f64(qw, device),
        qy=f64(qpts[..., 1], device),
        dofmap=index(space.dofmap[mesh.edge_tri], device),
        flux=f64(flux, device),
        neumann=f64(neumann, device),
    )
