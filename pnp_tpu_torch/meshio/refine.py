"""Uniform red refinement of triangle meshes.

The reference regenerates meshes through Gmsh .geo files (e.g.
test/pore_pnp/pore.geo) and has no in-code refinement; the rebuild needs
controlled mesh-size scaling for large-mesh solver validation and the
scaled benchmarks (a refined pore_pnp family at ~12k/~49k/~195k nodes).
Each triangle splits into 4 congruent children through its edge midpoints
(classic red refinement, no hanging nodes); boundary edges split in two and
inherit their physical group, so the Sysparams surface table and all BC
logic apply unchanged to any refinement level.

Midpoints of straight boundary segments stay on the boundary, so the
refined family solves the same polygonal domain the shipped .msh files
discretize (the .geo arcs are already polygonalized by Gmsh).
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh, build_edge_adjacency


def refine_uniform(mesh: Mesh, levels: int = 1) -> Mesh:
    """Red-refine ``levels`` times (4^levels elements, ~4x nodes/level)."""
    out = mesh
    for _ in range(levels):
        out = _refine_once(out)
    return out


def _refine_once(mesh: Mesh) -> Mesh:
    nodes, tris = mesh.nodes, mesh.tris
    N, E = mesh.num_nodes, mesh.num_tris

    # unique undirected edges of all triangles -> midpoint node ids
    pairs = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    lo = np.minimum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    hi = np.maximum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    key = lo * N + hi
    uniq, inv = np.unique(key, return_inverse=True)
    mid_id = N + np.arange(uniq.size, dtype=np.int64)          # new node ids
    mid_nodes = 0.5 * (nodes[(uniq // N)] + nodes[(uniq % N)])
    new_nodes = np.concatenate([nodes, mid_nodes], axis=0)

    m01 = mid_id[inv[:E]]
    m12 = mid_id[inv[E:2 * E]]
    m20 = mid_id[inv[2 * E:]]
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    # children keep parent orientation (CCW stays CCW)
    new_tris = np.concatenate([
        np.stack([a, m01, m20], axis=1),
        np.stack([m01, b, m12], axis=1),
        np.stack([m20, m12, c], axis=1),
        np.stack([m01, m12, m20], axis=1),
    ]).astype(np.int32)
    new_tri_phys = np.tile(mesh.tri_phys, 4).astype(np.int32)

    # boundary edges: (u, v) -> (u, m), (m, v), same physical group
    eu, ev = mesh.edges[:, 0].astype(np.int64), mesh.edges[:, 1].astype(np.int64)
    ekey = np.minimum(eu, ev) * N + np.maximum(eu, ev)
    pos = np.searchsorted(uniq, ekey)
    assert np.all(uniq[pos] == ekey), "boundary edge missing from triangles"
    em = mid_id[pos]
    new_edges = np.concatenate([
        np.stack([eu, em], axis=1),
        np.stack([em, ev], axis=1),
    ]).astype(np.int32)
    new_edge_phys = np.tile(mesh.edge_phys, 2).astype(np.int32)

    edge_tri, edge_local = build_edge_adjacency(new_tris, new_edges)
    out = Mesh(nodes=new_nodes, tris=new_tris, tri_phys=new_tri_phys,
               edges=new_edges, edge_phys=new_edge_phys,
               edge_tri=edge_tri, edge_local=edge_local)
    out.validate()
    return out
