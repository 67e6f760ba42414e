"""In-code problem definitions for the port's runs and tests.

:func:`pore_case` is a pore-class case built in code because the
reference tree (with its ``pore.cfg`` and ``pore.msh``) is absent. It is
not the reference's ``pore.cfg``: it takes that workload's physics — an
axisymmetric nanopore under a 24.1 bias with charged pore walls — on the
in-repo structured pore mesh.
"""

from __future__ import annotations

from .config import DIRICHLET, NEUMANN, Surface, Sysparams
from .fem.space import FunctionSpace
from .meshio.structured import pore_without_dna_mesh

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
