"""Scalar Pk function space on a triangle mesh: global dof numbering.

Numpy copy of ``pnp_tpu.fem.space`` (tests pin identical arrays).
Replacement for PDELab's ``GridFunctionSpace`` (bound by the
reference at src/instationary_pnp_from_pb_md.hh:125-131): dof maps are dense
int32 arrays so that residual assembly is gather -> batched kernel ->
segment-sum scatter, with no per-element dispatch.

Global dof order: vertex dofs [0, N), then edge dofs, then cell dofs.
For P3, the two dofs on a shared edge are stored in the direction
lo-vertex -> hi-vertex so both adjacent triangles agree on their identity.
"""

from __future__ import annotations

import numpy as np

from ..meshio.mesh import Mesh, LOCAL_EDGES
from .reference import ReferenceTriangle


class FunctionSpace:
    """Pk scalar space.

    Attributes:
      mesh:       the underlying :class:`Mesh`.
      degree:     polynomial degree (1..3).
      ref:        :class:`ReferenceTriangle` shape tables.
      ndof:       number of global dofs.
      dofmap:     (E, ndof_el) int32 element-to-global dof map.
      dof_coords: (ndof, 2) float64 coordinates of each global dof.
      bedge_dofs: (B, degree+1) int32 global dofs on each boundary edge.
    """

    def __init__(self, mesh: Mesh, degree: int = 1):
        self.mesh = mesh
        self.degree = degree
        self.ref = ReferenceTriangle(degree)
        self._build()

    def _build(self) -> None:
        mesh, p = self.mesh, self.degree
        N, E = mesh.num_nodes, mesh.num_tris
        tris = mesh.tris

        # global unique edges (sorted vertex pairs), id per edge
        all_edges = np.concatenate(
            [np.sort(tris[:, LOCAL_EDGES[k]], axis=1) for k in range(3)], axis=0)
        uniq, inv = np.unique(all_edges, axis=0, return_inverse=True)
        n_edges = uniq.shape[0]
        tri_edge = inv.reshape(3, E).T  # (E, 3) global edge id of local edge k
        self._uniq_edges = uniq

        ndof_el = self.ref.ndof
        dofmap = np.empty((E, ndof_el), dtype=np.int32)
        dofmap[:, :3] = tris
        if p == 1:
            ndof = N
        elif p == 2:
            dofmap[:, 3:6] = N + tri_edge
            ndof = N + n_edges
        else:  # p == 3: two dofs per edge (ordered lo->hi) + one cell dof
            for k in range(3):
                a = tris[:, LOCAL_EDGES[k, 0]]
                b = tris[:, LOCAL_EDGES[k, 1]]
                base = N + 2 * tri_edge[:, k]
                fwd = a < b  # local direction matches global lo->hi storage
                dofmap[:, 3 + 2 * k] = np.where(fwd, base, base + 1)
                dofmap[:, 4 + 2 * k] = np.where(fwd, base + 1, base)
            dofmap[:, 9] = N + 2 * n_edges + np.arange(E)
            ndof = N + 2 * n_edges + E
        self.ndof = int(ndof)
        self.dofmap = dofmap

        # dof coordinates
        coords = np.zeros((ndof, 2))
        coords[:N] = mesh.nodes
        if p == 2:
            coords[N:] = 0.5 * (mesh.nodes[uniq[:, 0]] + mesh.nodes[uniq[:, 1]])
        elif p == 3:
            lo, hi = mesh.nodes[uniq[:, 0]], mesh.nodes[uniq[:, 1]]
            coords[N:N + 2 * n_edges:2] = (2 * lo + hi) / 3.0
            coords[N + 1:N + 2 * n_edges:2] = (lo + 2 * hi) / 3.0
            coords[N + 2 * n_edges:] = mesh.nodes[tris].mean(axis=1)
        self.dof_coords = coords

        # dofs on each boundary edge (for Dirichlet constraints/interpolation)
        B = mesh.num_boundary_edges
        bdofs = np.empty((B, p + 1), dtype=np.int32)
        bdofs[:, 0] = mesh.edges[:, 0]
        bdofs[:, 1] = mesh.edges[:, 1]
        if p >= 2:
            lo = np.minimum(mesh.edges[:, 0], mesh.edges[:, 1])
            hi = np.maximum(mesh.edges[:, 0], mesh.edges[:, 1])
            key = np.stack([lo, hi], axis=1)
            # locate each boundary edge in the unique edge array
            idx = _rows_index_in(uniq, key)
            if p == 2:
                bdofs[:, 2] = N + idx
            else:
                bdofs[:, 2] = N + 2 * idx
                bdofs[:, 3] = N + 2 * idx + 1
        self.bedge_dofs = bdofs

    def boundary_dof_mask(self, edge_select: np.ndarray) -> np.ndarray:
        """Boolean (ndof,) mask of dofs lying on any selected boundary edge.

        ``edge_select`` is boolean (B,). DUNE semantics (constraints assembled
        per intersection, src/instationary_pnp_from_pb_md.hh:298-306): a dof
        on both a Dirichlet and a Neumann edge is constrained.
        """
        mask = np.zeros(self.ndof, dtype=bool)
        sel = self.bedge_dofs[edge_select]
        mask[sel.ravel()] = True
        return mask


def _rows_index_in(table: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Index of each row of ``rows`` in lexicographically unique ``table``."""
    # table is sorted lexicographically by np.unique; scalar key preserves order
    table = table.astype(np.int64)
    rows = rows.astype(np.int64)
    stride = table[:, 1].max() + 1
    idx = np.searchsorted(
        table[:, 0] * stride + table[:, 1], rows[:, 0] * stride + rows[:, 1])
    assert (table[idx] == rows).all(), "boundary edge missing from mesh edges"
    return idx
