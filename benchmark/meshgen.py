"""The benchmark's mesh generator: the structured axisymmetric pore without
DNA and its uniform red refinement, as arrays.

A frozen copy of the port's ``meshio/structured.pore_without_dna_mesh`` and
``meshio/refine.refine_uniform``, kept here so that a change to the
program's generator cannot change the benchmark's meshes. The boundary-edge
adjacency is found by sorting instead of a dictionary, which gives the
same arrays (each boundary edge has exactly one adjacent triangle) and
keeps the set-up of the 189,697-node mesh short.

A mesh is a dict of numpy arrays with the keys of the port's ``Mesh``:
nodes (N, 2) f64, tris (E, 3) i32 counter-clockwise, tri_phys (E,),
edges (B, 2), edge_phys (B,), edge_tri (B,), edge_local (B,).
"""

from __future__ import annotations

import numpy as np

#: local edge k of a triangle runs from vertex k to vertex (k + 1) % 3
LOCAL_EDGES = np.array([[0, 1], [1, 2], [2, 0]], dtype=np.int32)


def edge_adjacency(tris: np.ndarray, edges: np.ndarray):
    """(edge_tri, edge_local): the triangle each boundary edge belongs to
    and the edge's local index in it."""
    n = int(tris.max()) + 1
    a = tris[:, LOCAL_EDGES[:, 0]].astype(np.int64)          # (E, 3)
    b = tris[:, LOCAL_EDGES[:, 1]].astype(np.int64)
    keys = (np.minimum(a, b) * n + np.maximum(a, b)).ravel()
    order = np.argsort(keys, kind="stable")
    eu, ev = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    want = np.minimum(eu, ev) * n + np.maximum(eu, ev)
    pos = np.searchsorted(keys[order], want)
    if np.any(pos >= keys.size) or np.any(keys[order][np.minimum(
            pos, keys.size - 1)] != want):
        raise ValueError("a boundary edge lies in no triangle")
    flat = order[pos]
    return (flat // 3).astype(np.int32), (flat % 3).astype(np.int32)


def _mesh(nodes, tris, tri_phys, edges, edge_phys) -> dict:
    edge_tri, edge_local = edge_adjacency(tris, edges)
    return {"nodes": nodes, "tris": tris, "tri_phys": tri_phys,
            "edges": edges, "edge_phys": edge_phys, "edge_tri": edge_tri,
            "edge_local": edge_local}


def pore_without_dna(nx: int, ny: int) -> dict:
    """The 100 x 55 box (z in [-50, 50], r in [0, 55]) on an ``nx`` x
    ``ny`` grid of cells, each cut into two triangles, with the membrane
    (|z| < 10, r > 10) removed. Boundary groups: 0 pore and membrane
    walls, 1 axis (r = 0), 2 inflow (z = -50), 3 outflow (z = +50), 4 and
    5 the outer walls left and right of the membrane."""
    zl, zr, rmax = -50.0, 50.0, 55.0
    half_len, radius = 10.0, 10.0
    xs = np.linspace(zl, zr, nx + 1)
    ys = np.linspace(0.0, rmax, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel()], axis=1)
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i, j = i.ravel(), j.ravel()
    a, b = i * (ny + 1) + j, (i + 1) * (ny + 1) + j
    c, d = (i + 1) * (ny + 1) + j + 1, i * (ny + 1) + j + 1
    tris = np.stack([np.stack([a, b, c], 1), np.stack([a, c, d], 1)],
                    1).reshape(-1, 3)
    centers = nodes[tris].mean(axis=1)
    keep = ~((np.abs(centers[:, 0]) < half_len) & (centers[:, 1] > radius))
    tris = tris[keep]
    used = np.unique(tris)
    remap = np.full(nodes.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    nodes = nodes[used]
    tris = remap[tris].astype(np.int32)

    # boundary edges: those of exactly one triangle, in first-seen order
    pairs = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                            tris[:, [2, 0]]], axis=1).reshape(-1, 2)
    key = (np.minimum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
           * nodes.shape[0] + np.maximum(pairs[:, 0], pairs[:, 1]))
    uniq, first, count = np.unique(key, return_index=True,
                                   return_counts=True)
    once = np.sort(first[count == 1])
    n = nodes.shape[0]
    edges = np.stack([key[once] // n, key[once] % n], 1).astype(np.int32)
    mx, my = 0.5 * (nodes[edges[:, 0]] + nodes[edges[:, 1]]).T
    phys = np.zeros(mx.shape, dtype=np.int32)
    phys[np.abs(my) < 1e-9] = 1
    phys[np.abs(mx - zl) < 1e-9] = 2
    phys[np.abs(mx - zr) < 1e-9] = 3
    top = np.abs(my - rmax) < 1e-9
    phys[top & (mx < 0)] = 4
    phys[top & (mx > 0)] = 5
    return _mesh(nodes, tris, np.zeros(len(tris), dtype=np.int32), edges,
                 phys)


def refine(mesh: dict, levels: int) -> dict:
    """Red refinement ``levels`` times: each triangle into four through
    its edge midpoints (children keep the parent's orientation), each
    boundary edge into two with its group."""
    for _ in range(levels):
        nodes, tris = mesh["nodes"], mesh["tris"]
        N, E = nodes.shape[0], tris.shape[0]
        pairs = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                tris[:, [2, 0]]])
        lo = np.minimum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
        hi = np.maximum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
        uniq, inv = np.unique(lo * N + hi, return_inverse=True)
        mid_id = N + np.arange(uniq.size, dtype=np.int64)
        new_nodes = np.concatenate(
            [nodes, 0.5 * (nodes[uniq // N] + nodes[uniq % N])], axis=0)
        m01, m12, m20 = (mid_id[inv[k * E:(k + 1) * E]] for k in range(3))
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        new_tris = np.concatenate([
            np.stack([a, m01, m20], axis=1), np.stack([m01, b, m12], axis=1),
            np.stack([m20, m12, c], axis=1),
            np.stack([m01, m12, m20], axis=1)]).astype(np.int32)
        eu = mesh["edges"][:, 0].astype(np.int64)
        ev = mesh["edges"][:, 1].astype(np.int64)
        em = mid_id[np.searchsorted(uniq, np.minimum(eu, ev) * N
                                    + np.maximum(eu, ev))]
        new_edges = np.concatenate([np.stack([eu, em], axis=1),
                                    np.stack([em, ev], axis=1)]
                                   ).astype(np.int32)
        mesh = _mesh(new_nodes, new_tris,
                     np.tile(mesh["tri_phys"], 4).astype(np.int32),
                     new_edges,
                     np.tile(mesh["edge_phys"], 2).astype(np.int32))
    return mesh


def build(spec: dict) -> dict:
    """The mesh a configuration's ``mesh`` entry names."""
    if spec["generator"] != "pore_without_dna":
        raise ValueError(f"unknown mesh generator {spec['generator']!r}")
    return refine(pore_without_dna(spec["nx"], spec["ny"]),
                  spec.get("refine_levels", 0))
