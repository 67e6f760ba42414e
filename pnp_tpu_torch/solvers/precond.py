"""Preconditioners without sequential triangular sweeps (port of
``pnp_tpu.solvers.precond``).

The SSOR(k)-class option of the reference's solver variants is a
Chebyshev-accelerated Jacobi polynomial of degree k: matrix-free, built
from the same diagonal.
"""

from __future__ import annotations

from typing import Callable

import torch

Op = Callable[[torch.Tensor], torch.Tensor]


def identity_precond() -> Op:
    return lambda r: r


def jacobi_precond(diag) -> Op:
    """M^-1 r = r / diag (constrained rows must carry diag = 1)."""
    inv = 1.0 / diag
    return lambda r: r * inv


def estimate_dinv_spectral_radius(op: Op, diag, probe, iters: int = 12):
    """Power-iteration estimate of lambda_max(D^-1 A), a 0-d tensor."""
    inv = 1.0 / diag
    v = probe / torch.linalg.vector_norm(probe)
    lam = torch.ones((), dtype=probe.dtype, device=probe.device)
    for _ in range(iters):
        w = inv * op(v)
        lam = torch.linalg.vector_norm(w)
        v = w / torch.clamp_min(lam, 1e-300)
    return lam


def chebyshev_jacobi_precond(op: Op, diag, lam_max, degree: int = 3,
                             lam_min_frac: float = 0.06) -> Op:
    """Degree-k Chebyshev polynomial in D^-1 A over [lam_min, lam_max]."""
    inv = 1.0 / diag
    lmax = 1.1 * lam_max
    lmin = lam_min_frac * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def M(r):
        d = (inv * r) / theta
        z = d
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            resid = r - op(z)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (inv * resid)
            z = z + d
            rho = rho_new
        return z

    return M
