"""Output writers: gnuplot-style .dat, VTU (XML VTK), current.dat.

Numpy copy of ``pnp_tpu.io.writers``: fields arrive as host numpy arrays
(tests pin byte-identical files).

Parity:
  * ``DataWriter::writeData`` (src/datawriter.hh:45-97): one line per
    element — center coordinates, value, gradient — precision-5
    scientific. The reference's multi-rank truncation bug (every rank
    reopens with ios::out, last rank wins; datawriter.hh:59) is NOT
    replicated: we always write the complete global field.
  * VTK vertex data via ``VTKWriter``/``VTKGridFunctionAdapter``
    (src/instationary_pnp_from_pb_md.hh:233-235, 337-340) -> minimal VTU
    XML with triangle cells + named point arrays.
  * ``current.dat`` time series: time then per-surface (ip, im) pairs
    (src/instationary_pnp_from_pb_md.hh:444-451).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..fem.space import FunctionSpace


def write_dat(space: FunctionSpace, u, filename: str) -> None:
    """Element-center value + gradient, reference column layout."""
    from ..fem.geometry import element_jacobians
    mesh = space.mesh
    centers = mesh.nodes[mesh.tris].mean(axis=1)
    # value and gradient at the element center (ref coord (1/3, 1/3))
    ref_c = np.array([[1 / 3, 1 / 3]])
    shape_c = space.ref.values(ref_c)[0]             # (n,)
    gref_c = space.ref.gradients(ref_c)[0]           # (n, 2)
    _, _, jinv_t = element_jacobians(mesh)
    grad_c = np.einsum("eab,ib->eia", jinv_t, gref_c)
    ue = np.asarray(u)[space.dofmap]
    vals = ue @ shape_c
    grads = np.einsum("ei,eia->ea", ue, grad_c)
    with open(filename, "w") as f:
        for c, v, g in zip(centers, vals, grads):
            f.write(f"{c[0]:.5e} {c[1]:.5e}\t{v:.5e}\t{g[0]:.5e} {g[1]:.5e}\n")


def write_vtu(space: FunctionSpace, fields: Dict[str, np.ndarray],
              filename: str) -> None:
    """ASCII VTU with triangle cells and vertex (P1-projected) point data.

    Higher-degree fields are written at mesh vertices (their vertex dofs),
    matching the reference's conforming vertex-data VTK output.
    """
    mesh = space.mesh
    N, E = mesh.num_nodes, mesh.num_tris
    pts = np.column_stack([mesh.nodes, np.zeros(N)])
    with open(filename, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write(f'<UnstructuredGrid><Piece NumberOfPoints="{N}" '
                f'NumberOfCells="{E}">\n')
        f.write('<PointData Scalars="%s">\n' % next(iter(fields), "u"))
        for name, data in fields.items():
            arr = np.asarray(data)[:N]  # vertex dofs lead the numbering
            f.write(f'<DataArray type="Float64" Name="{name}" format="ascii">\n')
            f.write(" ".join(f"{v:.10e}" for v in arr))
            f.write("\n</DataArray>\n")
        f.write('</PointData>\n<Points>\n')
        f.write('<DataArray type="Float64" NumberOfComponents="3" format="ascii">\n')
        f.write(" ".join(f"{v:.10e}" for v in pts.ravel()))
        f.write("\n</DataArray>\n</Points>\n<Cells>\n")
        f.write('<DataArray type="Int32" Name="connectivity" format="ascii">\n')
        f.write(" ".join(str(v) for v in mesh.tris.ravel()))
        f.write("\n</DataArray>\n")
        f.write('<DataArray type="Int32" Name="offsets" format="ascii">\n')
        f.write(" ".join(str(3 * (i + 1)) for i in range(E)))
        f.write("\n</DataArray>\n")
        f.write('<DataArray type="UInt8" Name="types" format="ascii">\n')
        f.write(" ".join("5" for _ in range(E)))  # VTK_TRIANGLE
        f.write("\n</DataArray>\n</Cells>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")


class CurrentWriter:
    """Appends the reference's current.dat rows: time, then per-surface
    ip/im pairs (src/instationary_pnp_from_pb_md.hh:444-451)."""

    def __init__(self, path: str):
        self.f = open(path, "w")

    def write(self, time: float, ip, im) -> None:
        row = [f"{time:g}"]
        for p, m in zip(np.asarray(ip), np.asarray(im)):
            row.append(f"{p:.17g} {m:.17g}")
        self.f.write(" ".join(row) + "\n")
        self.f.flush()

    def close(self) -> None:
        self.f.close()


def write_pnp_dat(space: FunctionSpace, phi, cp, cm, filename: str) -> None:
    """Composite-field element-center writer.

    Parity: ``PNPDataWriter`` (src/pnp_datawriter.hh:23-244) — per element:
    center, phi, c+, c-, and the three gradients. The reference class is
    dead code (ctor name mismatch, colliding header guard, SURVEY.md
    quirks); this is the working equivalent. Multi-rank filename prefixes
    are unnecessary here (output is globally complete by construction).
    """
    from ..fem.geometry import element_jacobians
    mesh = space.mesh
    centers = mesh.nodes[mesh.tris].mean(axis=1)
    ref_c = np.array([[1 / 3, 1 / 3]])
    shape_c = space.ref.values(ref_c)[0]
    gref_c = space.ref.gradients(ref_c)[0]
    _, _, jinv_t = element_jacobians(mesh)
    grad_c = np.einsum("eab,ib->eia", jinv_t, gref_c)
    with open(filename, "w") as f:
        phi_e = np.asarray(phi)[space.dofmap]
        cp_e = np.asarray(cp)[space.dofmap]
        cm_e = np.asarray(cm)[space.dofmap]
        vals = [phi_e @ shape_c, cp_e @ shape_c, cm_e @ shape_c]
        grads = [np.einsum("ei,eia->ea", u, grad_c) for u in (phi_e, cp_e, cm_e)]
        for e in range(mesh.num_tris):
            cols = [f"{centers[e, 0]:.5e} {centers[e, 1]:.5e}"]
            cols += [f"{v[e]:.5e}" for v in vals]
            cols += [f"{g[e, 0]:.5e} {g[e, 1]:.5e}" for g in grads]
            f.write("\t".join(cols) + "\n")
