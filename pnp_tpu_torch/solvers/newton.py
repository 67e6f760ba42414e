"""Line-searched Newton with Hackbusch-Reusken accept-best strategy (port of
``pnp_tpu.solvers.newton``).

Defect-based convergence (relative ``newtonReduction`` + absolute floor),
dynamic linear reduction min(minLinearReduction, (defect/prev)^2), and the
accept-best backtracking line search: halve lambda until the new defect
<= (1 - lambda/4) * defect, keeping the best iterate seen. The reference's
jitted line-search ``while_loop`` is a Python loop here, with the same
accept/keep-best decisions; trial steps whose result the reference
discards are not evaluated.

``reduce``: as for :mod:`.krylov`, the sum over processes of the defect's
f64 partial sum where each holds a part of the vector (None: it is whole
here), so that every process tests convergence and accepts a line-search
trial on the same number.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..utils.profiling import host_read


@dataclasses.dataclass(frozen=True)
class NewtonParams:
    reduction: float = 1e-5
    abs_limit: float = 1e-12
    min_linear_reduction: float = 1e-5
    max_iterations: int = 50
    line_search_max: int = 500
    line_search_damping: float = 0.5
    verbosity: int = 0
    # reassemble the Jacobian only when defect/prev_defect > threshold
    # (PDELab setReassembleThreshold; 0.0 always reassembles)
    reassemble_threshold: float = 0.0


@dataclasses.dataclass
class NewtonResult:
    u: Any
    defect: float
    initial_defect: float
    iterations: int
    converged: bool
    linear_iterations: int = 0
    jacobian_builds: int = 0


def _defect(r, reduce=None) -> float:
    s = torch.dot(r, r)
    return host_read(torch.sqrt(s if reduce is None else reduce(s)))


def newton_solve(
    residual_fn: Callable,
    linear_solve_fn: Callable,
    u0,
    params: NewtonParams,
    assemble_fn: Callable = None,
    assembled_solve_fn: Callable = None,
    reduce: Callable = None,
) -> NewtonResult:
    """Solve residual_fn(u) = 0.

    ``linear_solve_fn(u, r, lin_red) -> (z, lin_iters)`` solves J(u) z = r
    with homogeneous constraints; or pass the split pair
    ``assemble_fn(u) -> jac_ctx`` / ``assembled_solve_fn(jac_ctx, r,
    lin_red)``, which enables ``params.reassemble_threshold``.
    """
    split = assemble_fn is not None
    if split != (assembled_solve_fn is not None):
        raise ValueError("assemble_fn and assembled_solve_fn come as a pair")
    u = u0
    r = residual_fn(u)
    defect0 = _defect(r, reduce)
    defect = defect0
    if defect0 < params.abs_limit:
        return NewtonResult(u=u, defect=defect0, initial_defect=defect0,
                            iterations=0, converged=True)

    total_lin = 0
    jac_builds = 0
    jac_ctx = None
    prev_defect = defect
    for it in range(params.max_iterations):
        if defect <= params.reduction * defect0 or defect <= params.abs_limit:
            return NewtonResult(u=u, defect=defect, initial_defect=defect0,
                                iterations=it, converged=True,
                                linear_iterations=total_lin,
                                jacobian_builds=jac_builds)
        if it == 0:
            lin_red = params.min_linear_reduction
        else:
            lin_red = min(params.min_linear_reduction,
                          (defect / prev_defect) ** 2)
        if split:
            rate = defect / prev_defect if it > 0 else float("inf")
            if jac_ctx is None or rate > params.reassemble_threshold:
                jac_ctx = assemble_fn(u)
                jac_builds += 1
            z, lin_iters = assembled_solve_fn(jac_ctx, r, lin_red)
        else:
            z, lin_iters = linear_solve_fn(u, r, lin_red)
            jac_builds += 1
        total_lin += int(lin_iters)
        prev_defect = defect
        u, r, defect = _line_search(residual_fn, params, u, z, defect,
                                    reduce)
        if params.verbosity >= 2:
            print(f"  Newton {it + 1}: defect {defect:.6e} "
                  f"(reduction {defect / defect0:.3e}, lin iters {lin_iters})")
        if not math.isfinite(defect):
            break

    converged = defect <= params.reduction * defect0 or defect <= params.abs_limit
    return NewtonResult(u=u, defect=defect, initial_defect=defect0,
                        iterations=params.max_iterations,
                        converged=bool(converged),
                        linear_iterations=total_lin,
                        jacobian_builds=jac_builds)


def _line_search(residual_fn, params: NewtonParams, u, z, defect: float,
                 reduce=None):
    """Hackbusch-Reusken accept-best backtracking. ``line_search_max == 0``
    takes the plain Newton step."""

    def try_lambda(lam):
        u_new = u - lam * z
        r_new = residual_fn(u_new)
        return u_new, r_new, _defect(r_new, reduce)

    if params.line_search_max == 0:
        return try_lambda(1.0)
    lam = 1.0
    u_c, r_c, d = try_lambda(lam)
    best_d, best_lam = d, lam
    accepted = False
    for _ in range(params.line_search_max):
        if d <= (1.0 - lam / 4.0) * defect:
            accepted = True
            break
        if d < best_d:
            best_d, best_lam = d, lam
        lam = lam * params.line_search_damping
        u_c, r_c, d = try_lambda(lam)
    if not accepted and best_d < d:
        return try_lambda(best_lam)
    return u_c, r_c, d
