"""Gmsh v2.x ASCII ``.msh`` parser -> :class:`Mesh` arrays.

Parity: the reference reads Gmsh 2.1/2.2 meshes through DUNE's GmshReader and
keeps the per-boundary-segment physical-group map
(reference: src/pnp_solver_main.cc:86-91; format seen in test/mesh.msh:1-8).
Element records are ``id type ntags tag0 tag1 ... v0 v1 ...`` where tag0 is
the physical group; type 1 = 2-node line (boundary), type 2 = 3-node triangle.

This parser is pure numpy (fast enough for the shipped meshes); the native
C++ meshkit (csrc/meshkit.cpp, bridged in native.py) provides the same
output for large meshes.
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh, build_edge_adjacency, fix_orientation

_LINE = 1
_TRI = 2


def read_gmsh(path: str) -> Mesh:
    with open(path, "r") as f:
        lines = f.read().split("\n")
    i = 0
    nodes = None
    node_ids = None
    raw_elems = []
    while i < len(lines):
        line = lines[i].strip()
        if line == "$MeshFormat":
            version = lines[i + 1].split()[0]
            if not version.startswith("2"):
                raise ValueError(f"only Gmsh v2.x ASCII supported, got {version}")
            i += 3
        elif line == "$Nodes":
            n = int(lines[i + 1])
            data = np.array(
                [lines[i + 2 + k].split() for k in range(n)], dtype=np.float64)
            node_ids = data[:, 0].astype(np.int64)
            nodes = data[:, 1:3].copy()
            i += n + 3
        elif line == "$Elements":
            n = int(lines[i + 1])
            for k in range(n):
                raw_elems.append(lines[i + 2 + k].split())
            i += n + 3
        else:
            i += 1
    if nodes is None:
        raise ValueError(f"no $Nodes section in {path}")

    # gmsh node ids may be non-contiguous; remap to 0-based dense indices
    id_to_idx = np.full(int(node_ids.max()) + 1, -1, dtype=np.int64)
    id_to_idx[node_ids] = np.arange(len(node_ids))

    tris, tri_phys, edges, edge_phys = [], [], [], []
    for rec in raw_elems:
        etype = int(rec[1])
        ntags = int(rec[2])
        phys = int(rec[3]) if ntags >= 1 else 0
        verts = [int(v) for v in rec[3 + ntags:]]
        if etype == _TRI:
            tris.append(verts)
            tri_phys.append(phys)
        elif etype == _LINE:
            edges.append(verts)
            edge_phys.append(phys)
        # other element types (points etc.) are ignored, as in GmshReader

    tris = id_to_idx[np.array(tris, dtype=np.int64)].astype(np.int32)
    edges = id_to_idx[np.array(edges, dtype=np.int64)].astype(np.int32)
    tris = fix_orientation(nodes, tris)
    edge_tri, edge_local = build_edge_adjacency(tris, edges)
    mesh = Mesh(
        nodes=nodes,
        tris=tris,
        tri_phys=np.array(tri_phys, dtype=np.int32),
        edges=edges,
        edge_phys=np.array(edge_phys, dtype=np.int32),
        edge_tri=edge_tri,
        edge_local=edge_local,
    )
    mesh.validate()
    return mesh
