"""Matrix-free Krylov solvers (port of ``pnp_tpu.solvers.krylov``).

The reference runs each solver as one ``lax.while_loop``; here it is a
Python loop whose convergence test reads the residual norm on the host
(one device sync per iteration — logged in ROADMAP as the first
performance target).

Vectors may be (S, N): S independent systems advanced together, dots
reducing over the last axis, until every system converges. Termination:
``||r|| <= reduction * ||r0||`` per system, or the iteration cap.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Op = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class KrylovResult:
    x: Any
    iterations: int
    relres: Any          # (…,) per-system relative residual
    converged: bool


def _norm(x):
    # f64 accumulation regardless of the vector dtype (as the reference)
    s = torch.sum((x * x).to(torch.float64), dim=-1, keepdim=True)
    return torch.sqrt(s).to(x.dtype)


def _dot(a, b):
    return torch.sum((a * b).to(torch.float64), dim=-1,
                     keepdim=True).to(a.dtype)


def _nz(x):
    return torch.where(x == 0.0, 1.0, x)


def _unconverged(r, tol) -> bool:
    return bool(torch.any(_norm(r) > tol))


def _result(x, r, k, norm0, reduction) -> KrylovResult:
    relres = (_norm(r) / torch.clamp_min(norm0, 1e-300))[..., 0]
    return KrylovResult(x=x, iterations=k, relres=relres,
                        converged=bool(torch.all(relres <= reduction)))


def cg(op: Op, b, x0, precond: Op | None = None, reduction: float = 1e-8,
       maxiter: int = 5000) -> KrylovResult:
    """Preconditioned conjugate gradients (SPD operator + preconditioner)."""
    M = precond if precond is not None else (lambda r: r)
    r = b - op(x0)
    z = M(r)
    norm0 = _norm(r)
    tol = reduction * torch.clamp_min(norm0, 1e-300)
    x, p, k, rz = x0, z, 0, _dot(r, z)
    while k < maxiter and _unconverged(r, tol):
        Ap = op(p)
        alpha = rz / _nz(_dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        beta = rz_new / _nz(rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    return _result(x, r, k, norm0, reduction)


def bicgstab(op: Op, b, x0, precond: Op | None = None,
             reduction: float = 1e-8, maxiter: int = 5000) -> KrylovResult:
    """Preconditioned BiCGSTAB (van der Vorst), right-preconditioned form."""
    M = precond if precond is not None else (lambda r: r)
    r = b - op(x0)
    norm0 = _norm(r)
    tol = reduction * torch.clamp_min(norm0, 1e-300)
    rhat = r
    one = torch.ones_like(norm0)
    x, p, v = x0, torch.zeros_like(b), torch.zeros_like(b)
    rho, alpha, omega, k = one, one, one, 0
    while k < maxiter and _unconverged(r, tol):
        rho_new = _dot(rhat, r)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = op(phat)
        alpha = rho_new / _nz(_dot(rhat, v))
        s = r - alpha * v
        shat = M(s)
        t = op(shat)
        omega = _dot(t, s) / _nz(_dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    return _result(x, r, k, norm0, reduction)
