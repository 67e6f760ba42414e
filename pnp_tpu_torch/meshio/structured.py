"""Structured rectangle meshes (testing + convergence studies).

Numpy copy of ``pnp_tpu.meshio.structured``; tests pin the two to
identical arrays.

The reference has no structured-mesh path (all Gmsh), but analytic
validation (SURVEY.md section 4, one_wall_dh) needs controlled refinement.

Boundary physical groups follow the one_wall convention
(test/one_wall_dh/one_wall.geo): 0 = left wall (x=0), 1 = right (x=Lx),
2 = bottom (y=0), 3 = top (y=Ly).
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh, build_edge_adjacency


def rect_mesh(nx: int, ny: int, Lx: float, Ly: float, y0: float = 0.0) -> Mesh:
    xs = np.linspace(0.0, Lx, nx + 1)
    ys = np.linspace(y0, y0 + Ly, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel()], axis=1)

    def nid(i, j):
        return i * (ny + 1) + j

    tris = []
    for i in range(nx):
        for j in range(ny):
            a, b = nid(i, j), nid(i + 1, j)
            c, d = nid(i + 1, j + 1), nid(i, j + 1)
            tris.append([a, b, c])
            tris.append([a, c, d])
    tris = np.array(tris, dtype=np.int32)

    edges, phys = [], []
    for j in range(ny):  # left (0) and right (1)
        edges.append([nid(0, j), nid(0, j + 1)]); phys.append(0)
        edges.append([nid(nx, j), nid(nx, j + 1)]); phys.append(1)
    for i in range(nx):  # bottom (2) and top (3)
        edges.append([nid(i, 0), nid(i + 1, 0)]); phys.append(2)
        edges.append([nid(i, ny), nid(i + 1, ny)]); phys.append(3)
    edges = np.array(edges, dtype=np.int32)
    edge_tri, edge_local = build_edge_adjacency(tris, edges)
    mesh = Mesh(nodes=nodes, tris=tris,
                tri_phys=np.zeros(len(tris), dtype=np.int32),
                edges=edges, edge_phys=np.array(phys, dtype=np.int32),
                edge_tri=edge_tri, edge_local=edge_local)
    mesh.validate()
    return mesh


def masked_rect_mesh(nx, ny, x0, x1, y0, y1, mask_fn, group_fn) -> Mesh:
    """Structured rectangle with elements removed where ``mask_fn`` is True.

    ``mask_fn(cx, cy)``: vectorized predicate on element centers (True =
    drop). ``group_fn(mx, my)``: vectorized map from boundary-edge midpoints
    to physical group ids. Boundary edges are recomputed after masking
    (edges adjacent to exactly one kept triangle).
    """
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel()], axis=1)

    def nid(i, j):
        return i * (ny + 1) + j

    tris = []
    for i in range(nx):
        for j in range(ny):
            a, b = nid(i, j), nid(i + 1, j)
            c, d = nid(i + 1, j + 1), nid(i, j + 1)
            tris.append([a, b, c])
            tris.append([a, c, d])
    tris = np.array(tris, dtype=np.int32)
    centers = nodes[tris].mean(axis=1)
    keep = ~mask_fn(centers[:, 0], centers[:, 1])
    tris = tris[keep]

    # compact node numbering
    used = np.unique(tris)
    remap = np.full(nodes.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    nodes = nodes[used]
    tris = remap[tris].astype(np.int32)

    # boundary edges: those appearing in exactly one triangle
    from collections import Counter
    cnt = Counter()
    for t in tris:
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            cnt[(min(a, b), max(a, b))] += 1
    edges = np.array([k for k, v in cnt.items() if v == 1], dtype=np.int32)
    mids = 0.5 * (nodes[edges[:, 0]] + nodes[edges[:, 1]])
    phys = group_fn(mids[:, 0], mids[:, 1]).astype(np.int32)

    edge_tri, edge_local = build_edge_adjacency(tris, edges)
    mesh = Mesh(nodes=nodes, tris=tris,
                tri_phys=np.zeros(len(tris), dtype=np.int32),
                edges=edges, edge_phys=phys,
                edge_tri=edge_tri, edge_local=edge_local)
    mesh.validate()
    return mesh


def pore_without_dna_mesh(nx: int = 100, ny: int = 55) -> Mesh:
    """Axisymmetric nanopore WITHOUT the DNA rod.

    Rebuild of the unshipped ``pore_without_dna.msh`` from its .geo
    dimensions (reference test/pore_without_dna/pore_without_dna.geo:1-14:
    box 100 x 55, pore length 20, pore radius 10; the reference ships no
    mesh for this workload). Physical groups follow the config
    (test/pore_without_dna/pore.cfg): 0 = pore/membrane walls, 1 = axis
    (r = 0), 2 = inflow (z = -50), 3 = outflow (z = +50), 4/5 = outer
    walls left/right of the membrane.
    """
    zl, zr, rmax = -50.0, 50.0, 55.0
    half_len, radius = 10.0, 10.0

    def membrane(cx, cy):
        return (np.abs(cx) < half_len) & (cy > radius)

    def groups(mx, my):
        g = np.zeros(mx.shape, dtype=np.int64)
        g[:] = 0                                   # default: pore walls
        g[np.abs(my - 0.0) < 1e-9] = 1             # axis
        g[np.abs(mx - zl) < 1e-9] = 2              # inflow
        g[np.abs(mx - zr) < 1e-9] = 3              # outflow
        top = np.abs(my - rmax) < 1e-9
        g[top & (mx < 0)] = 4                      # outer wall left
        g[top & (mx > 0)] = 5                      # outer wall right
        return g

    return masked_rect_mesh(nx, ny, zl, zr, 0.0, rmax, membrane, groups)
