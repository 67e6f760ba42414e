"""Batched dense direct solves: f32 explicit inverses + f64 refinement
(port of the dense-tier part of ``pnp_tpu.solvers.direct``).

The advection-dominated species stage systems are inverted densely in f32
(:func:`batched_inv_f32`, the hand-written Gauss-Jordan kernel on CUDA) and
solved to f64 accuracy by iterative refinement against the exact f64
element-block operator:

    x_{k+1} = x_k + X_f32 (b - A_f64 x_k)

Each refinement step cuts the error by about kappa(A) * eps_f32. The
refinement loop checks its residual on the host once per step.
"""

from __future__ import annotations

import torch

from ..fem import assembly as FA
from ..operators import kernels as K

# contraction-probe failures of batched_inv_f32 in this process (each one
# raises; the count lets a caller report how many it saw)
probe_failures = {"count": 0}


def probe_vectors(n: int, batch_shape=(), device="cpu"):
    """The contraction probe's test vectors: (2, *batch, n) f32, smooth
    (all ones) and rough (alternating +-1). Both must contract."""
    smooth = torch.ones(tuple(batch_shape) + (n,), dtype=torch.float32,
                        device=device)
    alt = torch.where(torch.arange(n, device=device) % 2 == 0, 1.0, -1.0)
    rough = alt.to(torch.float32).expand(tuple(batch_shape) + (n,))
    return torch.stack([smooth, rough])


def contraction_ok(A32, X) -> bool:
    """Two-step refinement contraction verdict for an (S, N, N) inverse:
    on b = A v for both probe vectors, two refinement steps must cut the
    residual to <= 0.25 ||b||, per matrix and per vector, and X must be
    finite."""
    mv = lambda M, v: torch.einsum("sij,psj->psi", M, v)
    b = mv(A32, probe_vectors(A32.shape[-1], A32.shape[:1], A32.device))
    x1 = mv(X, b)
    r1 = b - mv(A32, x1)
    r2 = r1 - mv(A32, mv(X, r1))
    nb = torch.linalg.vector_norm(b, dim=-1)
    nr2 = torch.linalg.vector_norm(r2, dim=-1)
    return bool(torch.all(torch.isfinite(nr2)) & torch.all(nr2 <= 0.25 * nb)
                & torch.all(torch.isfinite(X)))


def batched_inv_f32(A_dense):
    """(S, N, N) -> f32 explicit inverses through :func:`kernels.gj_inverse`
    (the CUDA kernel on a CUDA tensor, its plain version on the CPU),
    checked by :func:`contraction_ok`. A failed probe raises: the
    reference's fallback to a library inverse is not carried over."""
    A32 = A_dense.to(torch.float32)
    X = K.gj_inverse(A32)
    if not contraction_ok(A32, X):
        probe_failures["count"] += 1
        raise FloatingPointError(
            f"batched_inv_f32: Gauss-Jordan inverse of {tuple(A32.shape)} "
            "failed the contraction probe")
    return X


def scaled_inv_apply(Ainv, rk):
    """Preconditioner apply d = X rk in true f32, output in rk's dtype.

    The reference's scaled ``(X_eq, s)`` form belongs to its very-large
    Poisson tier (ROADMAP, block-RAS tier) and is not ported yet."""
    if isinstance(Ainv, tuple):
        raise NotImplementedError(
            "scaled (X_eq, s) inverses belong to the block-RAS tier "
            "(ROADMAP: modules to port, 'Block-RAS tier')")
    d = torch.einsum("sij,sj->si", Ainv, rk.to(torch.float32))
    return d.to(rk.dtype)


def make_inv_refine_solver_arg(A_el, dofmap, ndof: int, free,
                               maxrefine: int = 40):
    """Return solve(Ainv, r, reduction) -> (x, n_refinements).

    Correctness comes from the exact f64 element-block residual; the
    inverse only sets the contraction rate. ``r`` must be zero on
    constrained rows."""
    op = FA.make_constrained_operator_batched(A_el, dofmap, ndof, free)

    def solve(Ainv, r, reduction: float):
        norm0 = torch.sqrt(torch.sum(r * r, dim=-1, keepdim=True))
        tol = reduction * torch.clamp_min(norm0, 1e-300)
        # the first two refinements always run (as the reference unrolls them)
        x = scaled_inv_apply(Ainv, r)
        x = x + scaled_inv_apply(Ainv, r - op(x))
        rk = r - op(x)
        k = 2
        while k < maxrefine:
            nk = torch.sqrt(torch.sum(rk * rk, dim=-1, keepdim=True))
            diverged = ~torch.all(torch.isfinite(nk))
            if not bool(torch.any(nk > tol) | diverged):
                break
            x = x + scaled_inv_apply(Ainv, rk)
            rk = r - op(x)
            k += 1
        return x, k

    return solve


def make_inv_refine_solver(Ainv, A_el, dofmap, ndof: int, free,
                           maxrefine: int = 40):
    """Closure form of :func:`make_inv_refine_solver_arg`."""
    solve = make_inv_refine_solver_arg(A_el, dofmap, ndof, free, maxrefine)
    return lambda r, reduction: solve(Ainv, r, reduction)
