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

CG on request replays its iteration as a CUDA graph (``cg``'s ``graph``):
one launch an iteration in place of the ~50 of the operator and the
preconditioner, so the loop waits on the card and not on the host's
launches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..utils.profiling import host_read, is_recording, span

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
       maxiter: int = 5000, reduce=None, restart: int = 0,
       graph: bool = False) -> KrylovResult:
    """Preconditioned conjugate gradients (SPD operator + preconditioner).

    ``restart`` > 0: after every ``restart`` iterations the search
    direction starts again from the preconditioned residual (beta = 0).
    On an operator that is not symmetric (the species stage operators
    carry the drift) the directions lose their conjugacy and the residual
    stalls; each restarted cycle keeps CG's first, still-reducing steps.
    A solve that converges within ``restart`` iterations is plain CG.
    0 (the default): never, as the reference.

    ``graph``: on a CUDA device, with whole vectors (``reduce`` None) and
    outside ``recording()`` (whose spans are per apply), the second
    iteration is captured as a CUDA graph and every later one, but a
    restart, replays it. The iteration updates x, r, p and rz in place, so
    a replay runs the eager iteration's kernels on the same buffers: the
    same bits and the same count. ``op`` and ``precond`` must then launch
    on the current stream without a host sync."""
    with span("krylov.cg") as sp:
        M = precond if precond is not None else (lambda r: r)
        r = b - op(x0)
        z = M(r)
        norm0 = _norm(r, reduce)
        tol = reduction * torch.clamp_min(norm0, 1e-300)
        x, p, rz = x0.clone(), z.clone(), _dot(r, z, reduce)

        def step(keep: bool):
            """One iteration in place; the device flag "not converged"."""
            Ap = op(p)
            alpha = rz / _nz(_dot(p, Ap, reduce))
            x.add_(alpha * p)
            r.sub_(alpha * Ap)
            z = M(r)
            rz_new = _dot(r, z, reduce)
            if keep:
                p.mul_(rz_new / _nz(rz)).add_(z)
            else:
                p.copy_(z)
            rz.copy_(rz_new)
            return torch.any(_norm(r, reduce) > tol)

        graph = (graph and r.is_cuda and reduce is None
                 and not is_recording())
        captured = None
        k = 0
        more = _unconverged(r, tol, reduce)
        while k < maxiter and more:
            k += 1
            keep = not (restart and k % restart == 0)
            if graph and keep and k > 1:
                if captured is None:       # after one eager iteration
                    captured = _capture(lambda: step(True), r.device)
                captured[0].replay()
                flag = captured[1]
            else:
                flag = step(keep)
            more = host_read(flag)
        res = _result(x, r, k, norm0, reduction, reduce)
        sp.set(iterations=k, converged=res.converged)
    return res


#: per CUDA device: the side stream graphs are captured on, the memory
#: pool every capture shares, and the last graph captured (a solve's graph
#: is never replayed after the next capture, so the pool's blocks are
#: reused, not left behind a solve; the last graph keeps the pool open)
_graph_env: dict = {}


def _capture(fn, device):
    """``fn``'s launches captured as one CUDA graph, which nothing runs
    yet: ``(graph, out)``, where ``out`` is what ``fn`` returned and each
    ``graph.replay()`` (on the current stream) rewrites."""
    if device not in _graph_env:
        with torch.cuda.device(device):
            _graph_env[device] = [torch.cuda.Stream(),
                                  torch.cuda.graph_pool_handle(), None]
    env = _graph_env[device]
    stream, pool = env[0], env[1]
    g = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        g.capture_begin(pool=pool)
        try:
            out = fn()
        finally:
            g.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    env[2] = g
    return g, out


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
