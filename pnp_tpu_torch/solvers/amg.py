"""Two-level aggregation AMG preconditioner, the ``CG_AMG_SSOR`` variant
(port of ``pnp_tpu.solvers.amg``).

The counterpart of ISTL's ``CG_AMG_SSOR`` backend (bound by the reference
at src/instationary_pnp_from_pb_md.hh:209-211) as a two-level scheme:

  * unsmoothed aggregation of the free dofs (host numpy setup, reused
    across Jacobians): Morton-ordered contiguous runs where dof
    coordinates are given (every production call site), else a capped
    greedy element-seeded aggregation;
  * Galerkin coarse matrices A_c = P^T A P formed from the element blocks
    with one accumulating ``index_put_`` (no SpMV probing);
  * a dense Cholesky coarse solve, batched over the systems;
  * damped-Jacobi pre- and post-smoothing (omega = 0.6), which keeps M
    symmetric positive definite for CG.

The aggregation is copied from the reference line for line: it decides
the coarse space, so the arrays must be identical.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..fem import assembly as FA
from .block_ras import morton_order


@dataclasses.dataclass(frozen=True)
class AmgContext:
    """Static aggregation data (host setup, reused across Jacobians)."""

    agg: Any             # (ndof,) int64 aggregate id; -1 for constrained dofs
    n_agg: int
    dofmap: Any          # (E, n) int64
    free: Any            # (ndof,) bool
    omega: float = 0.6   # Jacobi damping


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_aggregates(dofmap: np.ndarray, ndof: int, free: np.ndarray,
                     target_coarse: int = 256,
                     dof_coords: np.ndarray = None):
    """Aggregation of free dofs into <= target_coarse compact groups:
    ``(agg (ndof,) int32, n_agg)``.

    With ``dof_coords``: the free dofs in Morton order, split into ~equal
    contiguous runs (spatially compact aggregates). Without: element-seeded
    greedy aggregation with a size cap, ids folded modulo
    ``target_coarse`` where more aggregates arise."""
    dofmap = np.asarray(dofmap)
    free = np.asarray(free)
    agg = np.full(ndof, -1, dtype=np.int64)
    free_ids = np.where(free)[0]
    if len(free_ids) == 0:
        return agg.astype(np.int32), 0

    if dof_coords is not None:
        perm = morton_order(np.asarray(dof_coords)[free_ids])
        n_agg = min(target_coarse, len(free_ids))
        bounds = np.linspace(0, len(free_ids), n_agg + 1).astype(np.int64)
        for k in range(n_agg):
            agg[free_ids[perm[bounds[k]:bounds[k + 1]]]] = k
        return agg.astype(np.int32), n_agg

    cap = max(3, -(-len(free_ids) // target_coarse))
    size = []
    next_id = 0
    for e in range(dofmap.shape[0]):
        dofs = [d for d in dofmap[e] if free[d]]
        unassigned = [d for d in dofs if agg[d] < 0]
        if not unassigned:
            continue
        assigned = [d for d in dofs if agg[d] >= 0]
        if assigned and size[agg[assigned[0]]] < cap:
            a = agg[assigned[0]]
        else:
            a = next_id
            next_id += 1
            size.append(0)
        for d in unassigned:
            agg[d] = a
        size[a] += len(unassigned)
    if next_id > target_coarse:
        sel = agg >= 0
        agg[sel] = agg[sel] % target_coarse
        next_id = target_coarse
    return agg.astype(np.int32), next_id


def make_amg_context(dofmap, ndof: int, free, target_coarse: int = 256,
                     omega: float = 0.6, dof_coords=None,
                     device=None) -> AmgContext:
    """The aggregation of ``dofmap``'s free dofs, on ``device`` (default:
    ``dofmap``'s device when it is a tensor, else the CPU). A (S, ndof)
    ``free`` (the two species) aggregates the union of the masks; each
    system's own mask is applied in :func:`two_level_precond`."""
    if device is None:
        device = (dofmap.device if isinstance(dofmap, torch.Tensor)
                  else torch.device("cpu"))
    free = _host(free)
    if free.ndim == 2:
        free = free.any(axis=0)
    dofmap = _host(dofmap)
    agg, n_agg = build_aggregates(dofmap, ndof, free, target_coarse,
                                  dof_coords=dof_coords)
    return AmgContext(
        agg=torch.as_tensor(agg.astype(np.int64), device=device),
        n_agg=n_agg,
        dofmap=torch.as_tensor(dofmap.astype(np.int64), device=device),
        free=torch.as_tensor(free, device=device), omega=omega)


def two_level_precond(A_el, ctx: AmgContext, diag, free=None):
    """M^-1 from element Jacobian blocks for this aggregation.

    Flat inputs (A_el (E, n, n), diag/free (ndof,)) or batched systems
    (A_el (S, E, n, n), diag/free (S, ndof)); the returned M applies to
    residuals of the matching shape. ``free`` defaults to the
    aggregation's (union) mask."""
    free = ctx.free if free is None else free
    squeeze = A_el.ndim == 3
    A_b = A_el[None] if squeeze else A_el
    S, E, n, _ = A_b.shape
    ndof = diag.shape[-1]
    dev, dt = A_b.device, A_b.dtype
    diag_b = (diag if diag.ndim == 2 else diag[None]).expand(S, ndof)
    free_b = (free if free.ndim == 2 else free[None]).expand(S, ndof)
    n_agg = ctx.n_agg
    nc = n_agg + 1
    # element-local aggregate ids; constrained dofs land in slot n_agg
    safe = torch.where(ctx.agg < 0, n_agg, ctx.agg)
    eagg = safe[ctx.dofmap]                                  # (E, n)
    shape = (S, E, n, n)
    Ac = torch.zeros((S, nc, nc), dtype=dt, device=dev)
    Ac.index_put_(
        (torch.arange(S, device=dev)[:, None, None, None].expand(shape),
         eagg[None, :, :, None].expand(shape),
         eagg[None, :, None, :].expand(shape)), A_b, accumulate=True)
    Ac = Ac[:, :n_agg, :n_agg] + 1e-12 * torch.eye(n_agg, dtype=dt,
                                                   device=dev)
    Lc = torch.linalg.cholesky(Ac)                           # batched factor

    inv_d = torch.where(free_b, ctx.omega / diag_b, 0.0)
    agg_ok = ctx.agg >= 0
    prolong_ix = torch.clamp_min(ctx.agg, 0)

    def apply_A(x):
        y = FA.spmv_batched(A_b, torch.where(free_b, x, 0.0), ctx.dofmap,
                            ndof)
        return torch.where(free_b, y, x)

    def restrict(r):
        rc = torch.zeros((S, nc), dtype=r.dtype, device=dev)
        rc.index_add_(1, safe, torch.where(free_b, r, 0.0))
        return rc[:, :n_agg]

    def prolong(zc):
        z = torch.where(agg_ok[None], zc[:, prolong_ix], 0.0)
        return torch.where(free_b, z, 0.0)

    def M(r):
        rb = r[None] if squeeze else r
        z = inv_d * rb                                       # pre-smooth
        resid = rb - apply_A(z)
        zc = torch.cholesky_solve(restrict(resid)[..., None], Lc)[..., 0]
        z = z + prolong(zc)                                  # coarse correction
        z = z + inv_d * (rb - apply_A(z))                    # post-smooth
        out = torch.where(free_b, z, rb)
        return out[0] if squeeze else out

    return M
