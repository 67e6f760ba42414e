"""Matrix-free Krylov solvers (port of ``pnp_tpu.solvers.krylov``).

The reference runs each solver as one ``lax.while_loop``; here it is a
Python loop whose convergence test reads the residual norm on the host
(through ``utils.profiling``'s ``host_read`` and ``host_copy``): once an
iteration in the eager loop, once a run of iterations in the graphed one
(below). Each solve is a
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

Both solvers on request run their iteration as a CUDA graph
(``graph``), in place of the ~50 (CG under AMG) or ~110 (BiCGSTAB under
two-level RAS) launches of the operator, the preconditioner and the
updates: the iteration is captured once a solve and run as the body of a
device-side while loop (``kernels.GraphLoop``), one launch and one read a
segment of iterations, so the card runs from one read to the next without
waiting on the host. ``graph_counts`` says how often that engaged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..operators import kernels as K
from ..operators.kernels import nonzero_or_one as _nz
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


def _unconverged(r, tol, reduce):
    """The device flag "some system's residual is above its tolerance"
    (``kernels.krylov_unconverged``: one launch on the card)."""
    return K.krylov_unconverged(_sum(r * r, reduce), tol)


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
    outside ``recording()`` (whose spans are per apply), the iteration is
    captured as a CUDA graph and every iteration after the first, but a
    restart, runs it in a device-side loop (:func:`_iterate`). The
    iteration updates x, r, p and rz in place, so the loop runs the eager
    iteration's kernels on the same buffers: the same bits and the same
    count. ``op`` and ``precond`` must then launch on the current stream
    without a host sync."""
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
            K.cg_update(x, r, p, Ap, _dot(p, Ap, reduce), rz)
            z = M(r)
            rz_new = _dot(r, z, reduce)
            if keep:
                K.cg_direction(p, z, rz_new, rz)
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
#: graphed path), ``loops`` (the captured graph's launches as a device-side
#: loop, one a segment of iterations between restarts) and ``replays``
#: (the iterations those loops ran); counted always, as
#: ``kernels.launches``, since inside ``recording()`` no graph is made
graph_counts = {"captures": 0, "replays": 0, "loops": 0}


def _graphed(graph: bool, r, reduce):
    """The device to run the iteration on as a CUDA graph, or None: the
    graph asked for, ``r`` on a CUDA device, whole vectors (``reduce``
    None) and no ``recording()`` open (its spans are per apply)."""
    if graph and r.is_cuda and reduce is None and not is_recording():
        return r.device
    return None


def _segment(k: int, maxiter: int, restart: int = 0, graphed: bool = True):
    """What :func:`_iterate` runs after ``k`` < ``maxiter`` iterations of
    an unconverged solve: ``("restart", 1)`` where iteration k + 1 is a
    restart (``restart`` > 0 and k + 1 a multiple of it), ``("eager", 1)``
    for the first iteration or off the graphed path, else ``("loop", n)``:
    the captured iteration up to n times, through the iteration before the
    next restart or ``maxiter``. Expanded to the end, the eager loop's
    sequence of kept and restarted iterations."""
    if restart and (k + 1) % restart == 0:
        return "restart", 1
    if k == 0 or not graphed:
        return "eager", 1
    end = maxiter if not restart else min(maxiter,
                                          (k // restart + 1) * restart - 1)
    return "loop", end - k


def _iterate(step, flag, maxiter: int, device, restart: int = 0) -> int:
    """Run ``step`` (one iteration in place, returning the device flag "not
    converged") from the device flag ``flag`` until a flag reads False or
    ``maxiter`` iterations; the number of iterations. ``restart`` > 0:
    every ``restart``-th iteration is ``step(keep=False)``.

    ``device`` None: every iteration eager, one flag read after each.
    ``device`` (from :func:`_graphed`): segments as :func:`_segment` plans
    them. The first iteration and the restarts run eagerly, each read
    after; the first segment of the rest captures the iteration as a CUDA
    graph, and each such segment is one launch of it as a device-side loop
    and one read of the iterations it ran and its last flag (at L3 under
    AMG: a Poisson solve's ~600 iterations in one, a species stage's in
    one a restart period). The loop runs the eager loop's kernels on the
    same buffers in the same order, and stops where it does: the same bits
    and count."""
    loop = None
    k = 0
    more = host_read(flag)
    while k < maxiter and more:
        kind, n = _segment(k, maxiter, restart, device is not None)
        if kind == "loop":
            if loop is None:
                loop = _capture(step, device)
                graph_counts["captures"] += 1
            ran, more = loop(n)
            graph_counts["loops"] += 1
            graph_counts["replays"] += ran
            k += ran
            continue
        flag = step() if kind == "eager" else step(keep=False)
        k += 1
        if k < maxiter:
            more = host_read(flag)
    return k


#: per CUDA device: the side stream graphs are captured on, the memory
#: pool every capture shares, and the last loop made (a solve's loop is
#: never launched after the next capture, so it is freed then and the
#: pool's blocks are reused, not left behind a solve; the last loop keeps
#: the pool open)
_graph_env: dict = {}


def _capture(fn, device):
    """``fn``'s launches captured as one CUDA graph and made the body of a
    ``kernels.GraphLoop`` on the flag ``fn`` returns; nothing runs yet.
    Returns ``run(n)``: one launch of the loop on the current stream, up
    to n iterations, and ``(ran, more)`` after one read. The wrappers'
    calls while ``fn`` is captured launch nothing: ``kernels.launches``
    counts them ``ran`` times at each ``run``, and not at the capture."""
    if device not in _graph_env:
        with torch.cuda.device(device):
            _graph_env[device] = [torch.cuda.Stream(),
                                  torch.cuda.graph_pool_handle(), None]
    env = _graph_env[device]
    stream, pool = env[0], env[1]
    g = torch.cuda.CUDAGraph(keep_graph=True)
    before = dict(K.launches)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        g.capture_begin(pool=pool)
        try:
            out = fn()
        finally:
            g.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    inside = {name: n - before[name] for name, n in K.launches.items()}
    K.launches.update(before)
    if env[2] is not None:
        env[2].free()
    loop = env[2] = K.GraphLoop(g, out)

    def run(n: int):
        ran, more = loop.run(n)
        for name, c in inside.items():
            K.launches[name] += c * ran
        return ran, more
    return run


def bicgstab(op: Op, b, x0, precond: Op | None = None,
             reduction: float = 1e-8, maxiter: int = 5000,
             reduce=None, graph: bool = False) -> KrylovResult:
    """Preconditioned BiCGSTAB (van der Vorst), right-preconditioned form.

    The iteration updates x, r, p, v, s and the scalars rho, alpha and
    omega in place (r-hat is a copy of the first residual), so that with
    ``graph`` it is captured and run in a device-side loop as ``cg``'s is,
    on the same conditions; the same bits and count as the eager loop."""
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
