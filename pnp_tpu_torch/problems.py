"""In-code problem definitions for the port's runs and tests.

:func:`pore_case` is a pore-class case built in code because the
reference tree (with its ``pore.cfg`` and ``pore.msh``) is absent. It is
not the reference's ``pore.cfg``: it takes that workload's physics — an
axisymmetric nanopore under a 24.1 bias with charged pore walls — on the
in-repo structured pore mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import DIRICHLET, NEUMANN, Surface, Sysparams
from .fem.space import FunctionSpace
from .meshio.mesh import Mesh
from .meshio.structured import pore_without_dna_mesh, rect_mesh
from .timestepping.tableaux import Tableau

#: pore_pnp's surface charge and bias (SURVEY.md, pore_pnp configuration)
WALL_FLUX = 1.1
BIAS = 24.1


def _surface(phi_type, phi_value, phi_flux, c_type, c_value) -> Surface:
    return Surface(coulombBtype=phi_type, coulombPotential=phi_value,
                   coulombFlux=phi_flux,
                   plusDiffusionBtype=c_type,
                   plusDiffusionConcentration=c_value,
                   minusDiffusionBtype=c_type,
                   minusDiffusionConcentration=c_value)


def pore_sysparams(c0: float = 0.06) -> Sysparams:
    """Parameters of the pore-class case. Surfaces follow the groups of
    :func:`~.meshio.structured.pore_without_dna_mesh`: 0 pore/membrane
    walls (charged), 1 axis, 2 inflow (phi = 0), 3 outflow (phi = bias),
    4/5 outer walls."""
    walls = _surface(NEUMANN, 0.0, WALL_FLUX, NEUMANN, 0.0)
    closed = _surface(NEUMANN, 0.0, 0.0, NEUMANN, 0.0)
    inflow = _surface(DIRICHLET, 0.0, 0.0, DIRICHLET, c0)
    outflow = _surface(DIRICHLET, BIAS, 0.0, DIRICHLET, c0)
    return Sysparams(
        n_surfaces=6, cylindrical=True, l_b=0.7, c0=c0, tau=1.0,
        linearSolver="BCGS_SSORk", linearSolverIterations=3000,
        newtonReduction=1e-9, newtonMinLinearReduction=1e-5,
        outputFreq=1, potentialUpdateFreq=1,
        surfaces=[walls, closed, inflow, outflow, closed, closed])


def pore_case(nx: int = 100, ny: int = 55, degree: int = 1):
    """(Sysparams, FunctionSpace) of the pore-class case at P``degree`` on
    the ``(nx, ny)`` structured pore: (100, 55) has 4,801 nodes and 9,200
    triangles (the dense tier's full-size case), (30, 17) 488 nodes."""
    return pore_sysparams(), FunctionSpace(pore_without_dna_mesh(nx, ny),
                                           degree)


def one_wall_sysparams() -> Sysparams:
    """Parameters of a one-wall (Debye-Hueckel class) case on a
    :func:`~.meshio.structured.rect_mesh`: group 0 the charged wall at
    x = 0 (phi flux 0.2, no ion flux), 1 the far side (phi = 0,
    c+- = c0 = 0.06), 2/3 closed."""
    c0 = 0.06
    wall = _surface(NEUMANN, 0.0, 0.2, NEUMANN, 0.0)
    far = _surface(DIRICHLET, 0.0, 0.0, DIRICHLET, c0)
    closed = _surface(NEUMANN, 0.0, 0.0, NEUMANN, 0.0)
    return Sysparams(
        n_surfaces=4, cylindrical=False, l_b=1.0, c0=c0, tau=0.1, nSteps=4,
        linearSolver="BCGS_SSORk", linearSolverIterations=20000,
        newtonReduction=1e-9, newtonMinLinearReduction=1e-8,
        outputFreq=1, potentialUpdateFreq=1,
        surfaces=[wall, far, closed, closed])


def one_wall_case(nx: int = 40, ny: int = 4, degree: int = 1):
    """(Sysparams, FunctionSpace) of the one-wall case on a 5 x 0.5
    rectangle of ``nx`` x ``ny`` cells."""
    return one_wall_sysparams(), FunctionSpace(rect_mesh(nx, ny, 5.0, 0.5),
                                               degree)


def write_gmsh(mesh: Mesh, path: str) -> None:
    """Write ``mesh`` as a Gmsh 2.2 ASCII file (boundary lines, then
    triangles, each with its physical group), which
    :func:`~.meshio.gmsh.read_gmsh` reads back to the same arrays."""
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{mesh.num_nodes}\n")
        for i, (x, y) in enumerate(mesh.nodes, 1):
            f.write(f"{i} {float(x)!r} {float(y)!r} 0\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n{len(mesh.edges) + mesh.num_tris}\n")
        k = 1
        for (a, b), g in zip(mesh.edges, mesh.edge_phys):
            f.write(f"{k} 1 2 {g} {g} {a + 1} {b + 1}\n")
            k += 1
        for (a, b, c), g in zip(mesh.tris, mesh.tri_phys):
            f.write(f"{k} 2 2 {g} {g} {a + 1} {b + 1} {c + 1}\n")
            k += 1
        f.write("$EndElements\n")


def write_config(sys: Sysparams, path: str, meshfile: str) -> None:
    """Write ``sys`` as an INI file that :func:`~.config.read_config` reads
    back to the same values; ``meshfile`` goes in as given (a relative name
    is resolved against the config file's directory on reading)."""
    skip = {"meshfile", "surfaces"}
    lines = ["[mesh]", f"filename = {meshfile}", "", "[system]"]
    for fld in dataclasses.fields(Sysparams):
        if fld.name in skip:
            continue
        v = getattr(sys, fld.name)
        if isinstance(v, bool):
            v = int(v)
        lines.append(f"{fld.name} = {v!r}" if isinstance(v, float)
                     else f"{fld.name} = {v}")
    for i, surf in enumerate(sys.surfaces):
        lines += ["", f"[surface_{i}]"]
        for fld in ("coulombBtype", "coulombPotential", "coulombFlux",
                    "plusDiffusionBtype", "plusDiffusionConcentration",
                    "plusDiffusionFlux", "minusDiffusionBtype",
                    "minusDiffusionConcentration", "minusDiffusionFlux"):
            v = getattr(surf, fld)
            lines.append(f"{fld} = {v!r}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def substeps_tableau(lengths=(0.2, 0.3, 0.5)) -> Tableau:
    """Implicit-Euler substeps of the given lengths (which sum to one) as
    one tableau: consistent, and its stage diagonals differ, so no one
    factor serves every stage. The tableaux of
    :mod:`.timestepping.tableaux` all have one stage diagonal
    (``fractional_step_theta`` too: alpha theta = beta (1 - 2 theta)); this
    one drives the species Krylov path in the tests and ``chip_smoke.py``."""
    s = len(lengths)
    A = np.zeros((s, s + 1))
    B = np.zeros((s, s + 1))
    for i, h in enumerate(lengths):
        A[i, i], A[i, i + 1], B[i, i + 1] = -1.0, 1.0, h
    return Tableau("implicit_euler_substeps", A=A, B=B,
                   D=np.concatenate([[0.0], np.cumsum(lengths)]),
                   implicit=True)
