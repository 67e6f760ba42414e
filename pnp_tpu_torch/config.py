"""Config system: INI files -> typed parameters.

Numpy copy of ``pnp_tpu.config`` (the port cannot import ``pnp_tpu``, whose
package import pulls in jax); tests pin the two to identical values.

Re-implements the reference ``Sysparams``/``Surface`` config surface
(reference: src/sysparams.hh:10-57, src/sysparams.cc:16-116) so the
reference's shipped ``.cfg`` files work verbatim.

Deviations from the reference (deliberate):
  * Missing keys fall back to documented defaults instead of throwing
    (the shipped ``sphere.cfg``/``cylinder_config.cfg`` are stale and lack
    Newton/solver keys the reference reader requires; reference would abort).
  * Boundary-condition type per surface: 0 = Dirichlet, 1 = Neumann
    (reference: src/btype.hh:25-29), unchanged.
  * The reference's compile-time LINEARSOLVER/PDEGREE build matrix
    (src/Makefile.am:53-111) becomes runtime config keys ``linearSolver``
    and ``degree`` — JIT specializes per static config anyway.
  * ``compat_pi``: the reference hard-codes PI = 3.1415 (src/pb_operator.hh:20);
    we default to true pi but keep the switch for golden-field comparisons.
"""

from __future__ import annotations

import configparser
import dataclasses
import math
import os
from typing import List

DIRICHLET = 0
NEUMANN = 1

# Runtime equivalents of the reference's five compile-time solver variants
# (reference: src/instationary_pnp_from_pb_md.hh:20-32).
LINEAR_SOLVERS = ("BCGS_SSORk", "BCGS_NOPREC", "CG_NOPREC", "CG_Jacobi", "CG_AMG_SSOR")


@dataclasses.dataclass
class Surface:
    """Per-physical-surface boundary condition table.

    Mirrors the reference ``Surface`` (src/sysparams.hh:40-57) with the same
    defaults (src/sysparams.cc:101-116).
    """

    coulombBtype: int = NEUMANN
    coulombPotential: float = 0.0
    coulombFlux: float = 0.0
    coulombSigma: float = 0.0
    coulombEpsilon: float = 1.0
    coulombChargeability: float = 0.0

    plusDiffusionBtype: int = NEUMANN
    plusDiffusionConcentration: float = 0.0
    plusDiffusionFlux: float = 0.0

    minusDiffusionBtype: int = NEUMANN
    minusDiffusionConcentration: float = 0.0
    minusDiffusionFlux: float = 0.0

    def btype(self, component: int) -> int:
        """BC type for field component (0=phi, 1=c+, 2=c-); src/btype.hh:30-51."""
        return (self.coulombBtype, self.plusDiffusionBtype, self.minusDiffusionBtype)[component]

    def dirichlet_value(self, component: int) -> float:
        return (
            self.coulombPotential,
            self.plusDiffusionConcentration,
            self.minusDiffusionConcentration,
        )[component]

    def flux_value(self, component: int) -> float:
        return (self.coulombFlux, self.plusDiffusionFlux, self.minusDiffusionFlux)[component]


@dataclasses.dataclass
class Sysparams:
    """Global solver parameters (reference: src/sysparams.hh:10-38)."""

    meshfile: str = ""
    n_surfaces: int = 0
    verbosity: int = 0
    cylindrical: bool = False
    l_b: float = 1.0
    linearSolverIterations: int = 5000
    newtonReassembleThreshold: float = 0.0
    newtonReduction: float = 1e-5
    newtonMinLinearReduction: float = 1e-5
    newtonMaxIterations: int = 50
    newtonLineSearchMaxIteration: int = 500
    c0: float = 0.06
    tau: float = 0.1
    nSteps: int = 100
    outputFreq: int = 1
    potentialUpdateFreq: int = 1
    printStiffnessMatrix: bool = False
    output_prefix: str = ""
    surfaces: List[Surface] = dataclasses.field(default_factory=list)

    # --- rebuild-only runtime knobs (compile-time in the reference) ---
    degree: int = 1                      # PDEGREE 1..3
    linearSolver: str = "BCGS_SSORk"     # LINEARSOLVER variant
    compat_pi: bool = False              # use reference PI=3.1415 for golden parity

    @property
    def pi(self) -> float:
        return 3.1415 if self.compat_pi else math.pi

    def surface(self, i: int) -> Surface:
        return self.surfaces[i]


def _get(cfg: configparser.ConfigParser, section: str, key: str, cast, default):
    try:
        raw = cfg.get(section, key)
    except (configparser.NoSectionError, configparser.NoOptionError):
        return default
    raw = raw.split("#", 1)[0].split(";", 1)[0].strip()
    if raw == "":
        return default
    if cast is bool:
        return bool(int(float(raw)))
    if cast is int:
        return int(float(raw))
    return cast(raw)


def read_config(path: str) -> Sysparams:
    """Read an INI config file into :class:`Sysparams`.

    Parity: reference ``Sysparams::readConfigFile`` (src/sysparams.cc:16-98),
    but missing keys get defaults instead of ``exit(1)``/throw (see module
    docstring). ``mesh.filename`` is resolved relative to the config file.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"Could not read config file '{path}'")
    cfg = configparser.ConfigParser(inline_comment_prefixes=("#", ";"), strict=False)
    cfg.read(path)

    s = Sysparams()
    g = lambda key, cast, default: _get(cfg, "system", key, cast, default)
    s.meshfile = _get(cfg, "mesh", "filename", str, "")
    if s.meshfile and not os.path.isabs(s.meshfile):
        s.meshfile = os.path.join(os.path.dirname(os.path.abspath(path)), s.meshfile)
    s.n_surfaces = g("n_surfaces", int, 0)
    s.verbosity = g("verbosity", int, 0)
    s.cylindrical = g("cylindrical", bool, False)
    s.l_b = g("l_b", float, 1.0)
    s.linearSolverIterations = g("linearSolverIterations", int, 5000)
    s.newtonReassembleThreshold = g("newtonReassembleThreshold", float, 0.0)
    s.newtonReduction = g("newtonReduction", float, 1e-5)
    s.newtonMinLinearReduction = g("newtonMinLinearReduction", float, 1e-5)
    s.newtonMaxIterations = g("newtonMaxIterations", int, 50)
    s.newtonLineSearchMaxIteration = g("newtonLineSearchMaxIteration", int, 500)
    s.c0 = g("c0", float, 0.06)
    s.tau = g("tau", float, 0.1)
    s.nSteps = g("nSteps", int, 100)
    s.outputFreq = g("outputFreq", int, 1)
    s.potentialUpdateFreq = g("potentialUpdateFreq", int, 1)
    s.printStiffnessMatrix = g("printStiffnessMatrix", bool, False)
    s.output_prefix = g("output_prefix", str, "")
    s.degree = g("degree", int, 1)
    s.linearSolver = g("linearSolver", str, "BCGS_SSORk")
    if s.linearSolver not in LINEAR_SOLVERS:
        raise ValueError(f"unknown linearSolver '{s.linearSolver}', expected one of {LINEAR_SOLVERS}")
    s.compat_pi = g("compat_pi", bool, False)

    for i in range(s.n_surfaces):
        sec = f"surface_{i}"
        surf = Surface()
        surf.coulombBtype = _get(cfg, sec, "coulombBtype", int, surf.coulombBtype)
        surf.coulombPotential = _get(cfg, sec, "coulombPotential", float, surf.coulombPotential)
        surf.coulombFlux = _get(cfg, sec, "coulombFlux", float, surf.coulombFlux)
        surf.plusDiffusionBtype = _get(cfg, sec, "plusDiffusionBtype", int, surf.plusDiffusionBtype)
        surf.plusDiffusionConcentration = _get(
            cfg, sec, "plusDiffusionConcentration", float, surf.plusDiffusionConcentration)
        surf.plusDiffusionFlux = _get(cfg, sec, "plusDiffusionFlux", float, surf.plusDiffusionFlux)
        surf.minusDiffusionBtype = _get(cfg, sec, "minusDiffusionBtype", int, surf.minusDiffusionBtype)
        surf.minusDiffusionConcentration = _get(
            cfg, sec, "minusDiffusionConcentration", float, surf.minusDiffusionConcentration)
        surf.minusDiffusionFlux = _get(cfg, sec, "minusDiffusionFlux", float, surf.minusDiffusionFlux)
        s.surfaces.append(surf)
    return s
