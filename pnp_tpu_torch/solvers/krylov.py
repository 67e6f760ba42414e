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

Both solvers on request replay their iteration as a CUDA graph
(``graph``): one launch an iteration in place of the ~50 (CG under AMG) or
~110 (BiCGSTAB under two-level RAS) of the operator, the preconditioner
and the updates, so the loop waits on the card and not on the host's
launches. ``graph_counts`` says how often that engaged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..operators import kernels as K
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


def _unconverged(r, tol, reduce):
    """The device flag "some system's residual is above its tolerance"."""
    return torch.any(_norm(r, reduce) > tol)


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

        def step(keep: bool = True):
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
            return _unconverged(r, tol, reduce)

        k = _iterate(step, _unconverged(r, tol, reduce), maxiter,
                     _graphed(graph, r, reduce), restart)
        res = _result(x, r, k, norm0, reduction, reduce)
        sp.set(iterations=k, converged=res.converged)
    return res


#: how often the solvers' CUDA graphs engaged since the process began:
#: ``captures`` (one a solve that reaches its second iteration on the
#: graphed path) and ``replays`` (one an iteration after it); counted
#: always, as ``kernels.launches``, since inside ``recording()`` no graph
#: is made
graph_counts = {"captures": 0, "replays": 0}


def _graphed(graph: bool, r, reduce):
    """The device to replay the iteration on as a CUDA graph, or None: the
    graph asked for, ``r`` on a CUDA device, whole vectors (``reduce``
    None) and no ``recording()`` open (its spans are per apply)."""
    if graph and r.is_cuda and reduce is None and not is_recording():
        return r.device
    return None


def _iterate(step, flag, maxiter: int, device, restart: int = 0) -> int:
    """Run ``step`` (one iteration in place, returning the device flag "not
    converged") from the device flag ``flag`` until a flag reads False or
    ``maxiter`` iterations, reading one flag an iteration; the number of
    iterations. ``restart`` > 0: every ``restart``-th iteration is
    ``step(keep=False)``. ``device`` (from :func:`_graphed`): the first
    iteration runs eagerly, the second is captured as a CUDA graph, and
    every later one but a restart replays it, on the same buffers: the
    eager loop's kernels, bits and count."""
    captured = None
    k = 0
    more = host_read(flag)
    while k < maxiter and more:
        k += 1
        keep = not (restart and k % restart == 0)
        if device is not None and keep and k > 1:
            if captured is None:
                captured = _capture(step, device)
                graph_counts["captures"] += 1
            captured[0]()
            graph_counts["replays"] += 1
            flag = captured[1]
        else:
            flag = step() if keep else step(keep=False)
        if k < maxiter:
            more = host_read(flag)
    return k


#: per CUDA device: the side stream graphs are captured on, the memory
#: pool every capture shares, and the last graph captured (a solve's graph
#: is never replayed after the next capture, so the pool's blocks are
#: reused, not left behind a solve; the last graph keeps the pool open)
_graph_env: dict = {}


def _capture(fn, device):
    """``fn``'s launches captured as one CUDA graph, which nothing runs
    yet: ``(replay, out)``, where ``out`` is what ``fn`` returned and each
    ``replay()`` (on the current stream) rewrites. The wrappers' calls
    while ``fn`` is captured launch nothing: ``kernels.launches`` counts
    them at each ``replay()``, where they launch, and not at the capture."""
    if device not in _graph_env:
        with torch.cuda.device(device):
            _graph_env[device] = [torch.cuda.Stream(),
                                  torch.cuda.graph_pool_handle(), None]
    env = _graph_env[device]
    stream, pool = env[0], env[1]
    g = torch.cuda.CUDAGraph()
    before = dict(K.launches)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        g.capture_begin(pool=pool)
        try:
            out = fn()
        finally:
            g.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    env[2] = g
    inside = {name: n - before[name] for name, n in K.launches.items()}
    K.launches.update(before)

    def replay():
        g.replay()
        for name, n in inside.items():
            K.launches[name] += n
    return replay, out


def bicgstab(op: Op, b, x0, precond: Op | None = None,
             reduction: float = 1e-8, maxiter: int = 5000,
             reduce=None, graph: bool = False) -> KrylovResult:
    """Preconditioned BiCGSTAB (van der Vorst), right-preconditioned form.

    The iteration updates x, r, p, v, s and the scalars rho, alpha and
    omega in place (r-hat is a copy of the first residual), so that with
    ``graph`` it is captured and replayed as ``cg``'s is, on the same
    conditions; the same bits and count as the eager loop."""
    with span("krylov.bicgstab") as sp:
        M = precond if precond is not None else (lambda r: r)
        r = b - op(x0)
        norm0 = _norm(r, reduce)
        tol = reduction * torch.clamp_min(norm0, 1e-300)
        x, rhat = x0.clone(), r.clone()
        p, v, s = (torch.zeros_like(b) for _ in range(3))
        rho, alpha, omega = (torch.ones_like(norm0) for _ in range(3))

        def step():
            """One iteration in place; the device flag "not converged"."""
            rho_new = _dot(rhat, r, reduce)
            beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
            p.sub_(omega * v).mul_(beta).add_(r)  # r + beta (p - omega v)
            phat = M(p)
            v.copy_(op(phat))
            alpha.copy_(rho_new / _nz(_dot(rhat, v, reduce)))
            torch.sub(r, alpha * v, out=s)
            shat = M(s)
            t = op(shat)
            omega.copy_(_dot(t, s, reduce) / _nz(_dot(t, t, reduce)))
            x.add_(alpha * phat).add_(omega * shat)
            torch.sub(s, omega * t, out=r)
            rho.copy_(rho_new)
            return _unconverged(r, tol, reduce)

        k = _iterate(step, _unconverged(r, tol, reduce), maxiter,
                     _graphed(graph, r, reduce))
        res = _result(x, r, k, norm0, reduction, reduce)
        sp.set(iterations=k, converged=res.converged)
    return res
