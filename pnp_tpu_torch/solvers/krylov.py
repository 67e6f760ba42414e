"""Matrix-free Krylov solvers (port of ``pnp_tpu.solvers.krylov``).

The reference runs each solver as one ``lax.while_loop``; here it is a
Python loop whose convergence test reads the residual norm on the host
(one device sync per iteration, through ``utils.profiling.host_read`` —
logged in ROADMAP as the first performance target). Each solve is a
``krylov.cg`` or ``krylov.bicgstab`` span with its ``iterations`` and
``converged``.

Vectors may be (S, N): S independent systems advanced together, dots
reducing over the last axis, until every system converges. Termination:
``||r|| <= reduction * ||r0||`` per system, or the iteration cap.

``reduce``: where each process holds a part of the vectors (ranks of the
owner-partitioned driver), a function that sums the f64 partial sums over
the processes (``DistContext.allreduce_sum``), so that every process tests
convergence on the same number and takes the same branch. None: the
vectors are whole here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..utils.profiling import host_read, span

Op = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class KrylovResult:
    x: Any
    iterations: int
    relres: Any          # (…,) per-system relative residual
    converged: bool


def _sum(v, reduce):
    s = torch.sum(v.to(torch.float64), dim=-1, keepdim=True)
    return s if reduce is None else reduce(s)


def _norm(x, reduce=None):
    # f64 accumulation regardless of the vector dtype (as the reference)
    return torch.sqrt(_sum(x * x, reduce)).to(x.dtype)


def _dot(a, b, reduce=None):
    return _sum(a * b, reduce).to(a.dtype)


def _nz(x):
    return torch.where(x == 0.0, 1.0, x)


def _unconverged(r, tol, reduce) -> bool:
    return host_read(torch.any(_norm(r, reduce) > tol))


def _result(x, r, k, norm0, reduction, reduce) -> KrylovResult:
    relres = (_norm(r, reduce) / torch.clamp_min(norm0, 1e-300))[..., 0]
    return KrylovResult(x=x, iterations=k, relres=relres,
                        converged=host_read(torch.all(relres <= reduction)))


def cg(op: Op, b, x0, precond: Op | None = None, reduction: float = 1e-8,
       maxiter: int = 5000, reduce=None) -> KrylovResult:
    """Preconditioned conjugate gradients (SPD operator + preconditioner)."""
    with span("krylov.cg") as sp:
        M = precond if precond is not None else (lambda r: r)
        r = b - op(x0)
        z = M(r)
        norm0 = _norm(r, reduce)
        tol = reduction * torch.clamp_min(norm0, 1e-300)
        x, p, k, rz = x0, z, 0, _dot(r, z, reduce)
        while k < maxiter and _unconverged(r, tol, reduce):
            Ap = op(p)
            alpha = rz / _nz(_dot(p, Ap, reduce))
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rz_new = _dot(r, z, reduce)
            beta = rz_new / _nz(rz)
            p = z + beta * p
            rz = rz_new
            k += 1
        res = _result(x, r, k, norm0, reduction, reduce)
        sp.set(iterations=k, converged=res.converged)
    return res


def bicgstab(op: Op, b, x0, precond: Op | None = None,
             reduction: float = 1e-8, maxiter: int = 5000,
             reduce=None) -> KrylovResult:
    """Preconditioned BiCGSTAB (van der Vorst), right-preconditioned form."""
    with span("krylov.bicgstab") as sp:
        M = precond if precond is not None else (lambda r: r)
        r = b - op(x0)
        norm0 = _norm(r, reduce)
        tol = reduction * torch.clamp_min(norm0, 1e-300)
        rhat = r
        one = torch.ones_like(norm0)
        x, p, v = x0, torch.zeros_like(b), torch.zeros_like(b)
        rho, alpha, omega, k = one, one, one, 0
        while k < maxiter and _unconverged(r, tol, reduce):
            rho_new = _dot(rhat, r, reduce)
            beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
            p = r + beta * (p - omega * v)
            phat = M(p)
            v = op(phat)
            alpha = rho_new / _nz(_dot(rhat, v, reduce))
            s = r - alpha * v
            shat = M(s)
            t = op(shat)
            omega = _dot(t, s, reduce) / _nz(_dot(t, t, reduce))
            x = x + alpha * phat + omega * shat
            r = s - omega * t
            rho = rho_new
            k += 1
        res = _result(x, r, k, norm0, reduction, reduce)
        sp.set(iterations=k, converged=res.converged)
    return res
