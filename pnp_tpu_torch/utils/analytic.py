"""Analytic potential/force test functions.

Parity: reference src/potential.hh:5-43 — a parabolic test potential
K(1 - r^4) and a zero force functor (used only by the dead alternate main
stat_diff_eq.cc; kept for capability-surface completeness and as handy
manufactured-solution helpers).
"""

from __future__ import annotations

import numpy as np


def parabolic_potential(K: float):
    """phi(x) = K * (1 - |x|^4)   (reference potential.hh Potential)."""

    def f(x):
        x = np.asarray(x)
        r2 = (x ** 2).sum(axis=-1)
        return K * (1.0 - r2 ** 2)

    return f


def zero_force(x):
    """Zero force functor (reference potential.hh Force)."""
    x = np.asarray(x)
    return np.zeros_like(x)
