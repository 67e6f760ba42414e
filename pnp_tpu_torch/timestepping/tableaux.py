"""One-step time integration tableaux (PDELab parameter convention).

Numpy copy of ``pnp_tpu.timestepping.tableaux`` (tests pin identical
tables).

Parity: ``Dune::PDELab::TimeSteppingParameterInterface`` as used by the
reference (Alexander2Parameter at src/instationary_pnp_from_pb_md.hh:389,
ExplicitEulerParameter at src/instationary_pnp_from_pb.hh:375). A scheme
with ``s`` stages advances u^(0) = u(t) through u^(1)..u^(s) = u(t+dt); the
stage-i equation over time levels j = 0..i is

    sum_j [ A[i-1][j] * m(u^(j)) + dt * B[i-1][j] * alpha(u^(j), t + D[j] dt) ] = 0

where m is the mass residual and alpha the spatial residual (including any
Neumann flux terms). Dirichlet dofs of u^(i) are set at time t + D[i] dt.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tableau:
    name: str
    A: np.ndarray       # (stages, stages+1) mass weights
    B: np.ndarray       # (stages, stages+1) spatial weights (times dt)
    D: np.ndarray       # (stages+1,) stage time fractions
    implicit: bool

    @property
    def stages(self) -> int:
        return self.A.shape[0]


def implicit_euler() -> Tableau:
    return Tableau("implicit_euler",
                   A=np.array([[-1.0, 1.0]]),
                   B=np.array([[0.0, 1.0]]),
                   D=np.array([0.0, 1.0]), implicit=True)


def explicit_euler() -> Tableau:
    return Tableau("explicit_euler",
                   A=np.array([[-1.0, 1.0]]),
                   B=np.array([[1.0, 0.0]]),
                   D=np.array([0.0, 1.0]), implicit=False)


def one_step_theta(theta: float) -> Tableau:
    return Tableau(f"one_step_theta({theta})",
                   A=np.array([[-1.0, 1.0]]),
                   B=np.array([[1.0 - theta, theta]]),
                   D=np.array([0.0, 1.0]), implicit=theta > 0.0)


def alexander2() -> Tableau:
    """2-stage, 2nd-order, stiffly-accurate SDIRK (Alexander 1977) — the
    scheme the reference's production workload uses
    (src/instationary_pnp_from_pb_md.hh:389)."""
    a = 1.0 - 0.5 * math.sqrt(2.0)
    return Tableau("alexander2",
                   A=np.array([[-1.0, 1.0, 0.0],
                               [-1.0, 0.0, 1.0]]),
                   B=np.array([[0.0, a, 0.0],
                               [0.0, 1.0 - a, a]]),
                   D=np.array([0.0, a, 1.0]), implicit=True)


def fractional_step_theta() -> Tableau:
    """3-stage fractional-step-theta (PDELab FractionalStepParameter)."""
    th = 1.0 - math.sqrt(2.0) / 2.0
    thp = 1.0 - 2.0 * th
    al = 2.0 - math.sqrt(2.0)
    be = 1.0 - al
    return Tableau(
        "fractional_step_theta",
        A=np.array([[-1.0, 1.0, 0.0, 0.0],
                    [0.0, -1.0, 1.0, 0.0],
                    [0.0, 0.0, -1.0, 1.0]]),
        B=np.array([[be * th, al * th, 0.0, 0.0],
                    [0.0, al * thp, al * th, 0.0],
                    [0.0, 0.0, be * th, al * th]]),
        D=np.array([0.0, th, 1.0 - th, 1.0]), implicit=True)
