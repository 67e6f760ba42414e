"""Mesh exploration / debug printing.

Parity: reference ``GridLearning`` (src/GridLearning.hh:5-80) — a debug
utility that prints element centers, corners and boundary intersections.
Compiled into the reference binary but unused at runtime; provided here as
a structured summary helper for interactive debugging.
"""

from __future__ import annotations

import numpy as np

from ..meshio.mesh import Mesh


def describe_mesh(mesh: Mesh, max_elements: int = 5) -> str:
    x = mesh.nodes[mesh.tris]
    centers = x.mean(axis=1)
    det = (x[:, 1, 0] - x[:, 0, 0]) * (x[:, 2, 1] - x[:, 0, 1]) - (
        x[:, 2, 0] - x[:, 0, 0]) * (x[:, 1, 1] - x[:, 0, 1])
    areas = 0.5 * np.abs(det)
    lines = [
        f"mesh: {mesh.num_nodes} nodes, {mesh.num_tris} triangles, "
        f"{mesh.num_boundary_edges} boundary edges",
        f"bbox: x [{mesh.nodes[:, 0].min():g}, {mesh.nodes[:, 0].max():g}], "
        f"y [{mesh.nodes[:, 1].min():g}, {mesh.nodes[:, 1].max():g}]",
        f"area: total {areas.sum():g}, min {areas.min():g}, max {areas.max():g}",
        f"boundary physical groups: "
        f"{dict(zip(*map(list, np.unique(mesh.edge_phys, return_counts=True))))}",
    ]
    for e in range(min(max_elements, mesh.num_tris)):
        lines.append(
            f"  element {e}: center ({centers[e, 0]:g}, {centers[e, 1]:g}), "
            f"corners {x[e].tolist()}")
    return "\n".join(lines)
