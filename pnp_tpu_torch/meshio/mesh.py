"""Host-side unstructured triangle mesh as dense arrays.

Numpy copy of ``pnp_tpu.meshio.mesh``; tests pin the two to identical
arrays. Replacement for the reference's UGGrid<2> + GmshReader physical
group maps (reference: src/pnp_solver_main.cc:77-114): the mesh is a set of
statically-shaped int32/float64 numpy arrays that are uploaded to the
device once and consumed by batched element kernels. The reference's
``boundaryIndexToEntity[boundarySegmentIndex] -> physical group`` vector
becomes the ``edge_phys`` array indexed by boundary-edge id.
"""

from __future__ import annotations

import dataclasses
import numpy as np

# Local edges of a triangle (v0, v1, v2): edge k = (tri[k], tri[(k+1) % 3]).
LOCAL_EDGES = np.array([[0, 1], [1, 2], [2, 0]], dtype=np.int32)


@dataclasses.dataclass
class Mesh:
    """2-D triangle mesh with physical-group-tagged boundary edges.

    Attributes:
      nodes:       (N, 2) float64 vertex coordinates.
      tris:        (E, 3) int32 vertex indices (counter-clockwise).
      tri_phys:    (E,)  int32 physical group of each triangle.
      edges:       (B, 2) int32 boundary edge vertex indices.
      edge_phys:   (B,)  int32 physical group of each boundary edge
                   (the reference's boundaryIndexToEntity map).
      edge_tri:    (B,)  int32 index of the (unique) adjacent triangle.
      edge_local:  (B,)  int32 local edge index (0..2) within that triangle.
    """

    nodes: np.ndarray
    tris: np.ndarray
    tri_phys: np.ndarray
    edges: np.ndarray
    edge_phys: np.ndarray
    edge_tri: np.ndarray
    edge_local: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_tris(self) -> int:
        return self.tris.shape[0]

    @property
    def num_boundary_edges(self) -> int:
        return self.edges.shape[0]

    def validate(self) -> None:
        """Cheap structural sanity checks (orientation, adjacency)."""
        x = self.nodes[self.tris]  # (E, 3, 2)
        det = (x[:, 1, 0] - x[:, 0, 0]) * (x[:, 2, 1] - x[:, 0, 1]) - (
            x[:, 2, 0] - x[:, 0, 0]) * (x[:, 1, 1] - x[:, 0, 1])
        if np.any(det == 0.0):
            raise ValueError("degenerate triangle(s) in mesh")
        # each boundary edge must be an edge of its adjacent triangle
        tri_v = self.tris[self.edge_tri]  # (B, 3)
        le = LOCAL_EDGES[self.edge_local]  # (B, 2)
        a = np.take_along_axis(tri_v, le, axis=1)  # (B, 2)
        ok = (np.sort(a, axis=1) == np.sort(self.edges, axis=1)).all()
        if not ok:
            raise ValueError("boundary edge / triangle adjacency is inconsistent")


def fix_orientation(nodes: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Flip triangles with negative signed area to counter-clockwise order."""
    x = nodes[tris]
    det = (x[:, 1, 0] - x[:, 0, 0]) * (x[:, 2, 1] - x[:, 0, 1]) - (
        x[:, 2, 0] - x[:, 0, 0]) * (x[:, 1, 1] - x[:, 0, 1])
    flipped = tris.copy()
    neg = det < 0
    flipped[neg] = flipped[neg][:, [0, 2, 1]]
    return flipped


def build_edge_adjacency(tris: np.ndarray, edges: np.ndarray):
    """For each boundary edge find the adjacent triangle and local edge index.

    Replaces the reference's intersection iteration
    (src/instationary_pnp_from_pb_md.hh:162-176) with a vectorized
    dictionary build: every triangle edge keyed by its sorted vertex pair.
    """
    E = tris.shape[0]
    edge_map = {}
    for k in range(3):
        a = tris[:, LOCAL_EDGES[k, 0]]
        b = tris[:, LOCAL_EDGES[k, 1]]
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        for e in range(E):
            edge_map[(int(lo[e]), int(hi[e]))] = (e, k)
    edge_tri = np.empty(edges.shape[0], dtype=np.int32)
    edge_local = np.empty(edges.shape[0], dtype=np.int32)
    for i, (a, b) in enumerate(edges):
        key = (int(min(a, b)), int(max(a, b)))
        if key not in edge_map:
            raise ValueError(f"boundary edge {key} not found in any triangle")
        edge_tri[i], edge_local[i] = edge_map[key]
    return edge_tri, edge_local
