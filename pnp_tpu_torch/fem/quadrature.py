"""Gauss quadrature on the reference triangle and unit interval.

Numpy copy of ``pnp_tpu.fem.quadrature`` (tests pin identical tables).
Replacement for ``Dune::QuadratureRules`` (bound by the reference
at src/pb_operator.hh:69-70): rules are fixed numpy tables baked as constants
into the compiled assembly program. Orders used by the reference operators:
2 (species drift-diffusion, src/diffusion_operator.hh:36), 3 (PB/PNP/Poisson
default, src/pb_operator.hh:39), 5 (species mass operator ctor arg,
src/instationary_pnp_from_pb_md.hh:363).

Reference triangle: vertices (0,0), (1,0), (0,1); weights sum to area 1/2.
"""

from __future__ import annotations

import numpy as np

__all__ = ["triangle_rule", "interval_rule"]


def _perm3(a: float, b: float):
    """The three permutations of barycentric (a, b, b) as (x, y) points."""
    return [(b, b), (a, b), (b, a)]


def triangle_rule(order: int):
    """Symmetric Gauss (Dunavant) rule exact for polynomials of ``order``.

    Returns (points (nq,2), weights (nq,)) with weights summing to 1/2.
    """
    if order <= 1:
        pts = [(1 / 3, 1 / 3)]
        wts = [1.0]
    elif order == 2:
        pts = _perm3(2 / 3, 1 / 6)
        wts = [1 / 3] * 3
    elif order == 3:
        # 4-point Dunavant (one negative weight), exact to degree 3
        pts = [(1 / 3, 1 / 3)] + _perm3(0.6, 0.2)
        wts = [-27 / 48] + [25 / 48] * 3
    elif order == 4:
        a1, w1 = 0.445948490915965, 0.223381589678011
        a2, w2 = 0.091576213509771, 0.109951743655322
        pts = _perm3(1 - 2 * a1, a1) + _perm3(1 - 2 * a2, a2)
        wts = [w1] * 3 + [w2] * 3
    elif order == 5:
        a1, w1 = 0.470142064105115, 0.132394152788506
        a2, w2 = 0.101286507323456, 0.125939180544827
        pts = [(1 / 3, 1 / 3)] + _perm3(1 - 2 * a1, a1) + _perm3(1 - 2 * a2, a2)
        wts = [0.225] + [w1] * 3 + [w2] * 3
    else:
        # Duffy-transform tensor Gauss rule, exact for any polynomial order:
        # x = u, y = v (1 - u); the pulled-back integrand of a degree-d
        # polynomial has degree 2d+1 in u and d in v.
        nu = order + 1
        nv = (order + 2) // 2
        xu, wu = np.polynomial.legendre.leggauss(nu)
        xv, wv = np.polynomial.legendre.leggauss(nv)
        u = 0.5 * (xu + 1.0)
        v = 0.5 * (xv + 1.0)
        wu *= 0.5
        wv *= 0.5
        pts = [(ui, vj * (1.0 - ui)) for ui in u for vj in v]
        wts = [wi * wj * (1.0 - ui) * 2.0
               for ui, wi in zip(u, wu) for wj in wv]
    points = np.array(pts, dtype=np.float64)
    weights = np.array(wts, dtype=np.float64) * 0.5
    # normalize any tabulation round-off so constants integrate exactly
    weights *= 0.5 / weights.sum()
    return points, weights


def interval_rule(order: int):
    """Gauss-Legendre on [0, 1] exact to the given polynomial order."""
    n = max(1, (order + 2) // 2)
    x, w = np.polynomial.legendre.leggauss(n)
    return (0.5 * (x + 1.0)), (0.5 * w)
