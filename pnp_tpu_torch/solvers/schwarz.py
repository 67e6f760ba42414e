"""Distributed Schwarz preconditioners over a DistContext (port of
``pnp_tpu.solvers.schwarz``).

The counterpart of the SSOR/ILU smoothing inside the reference's NOVLP
Krylov solvers (src/instationary_pnp_from_pb_md.hh:188): each shard
assembles the TRUE principal submatrix A[loc, loc] of its [owned | halo]
local dof set (its own element blocks plus the gathered blocks of its
env elements), inverts it in f32 (one (S*K_l, L, L) batch of this
process's shards through :func:`.direct.batched_inv_f32`, the
Gauss-Jordan kernel on CUDA, behind the contraction probe), and one
preconditioner apply is one halo exchange plus one batched f32 matvec a
shard. With the halo layer as overlap this is restricted additive
Schwarz (RAS) with exact subdomain solves: pair it with BiCGSTAB;
``restricted=False`` (symmetric additive Schwarz) with CG.

Floating subdomains (interior shards of a pure-Laplace operator) are
regularized by a relative diagonal shift, which perturbs only the
preconditioner. ``factor_local_matrices``/``make_ras_precond`` keep the
reference's LU + triangular-solve path for A/B comparison
(``use_inverse=False``). The reference's ``shard_map`` plumbing
(``_shard_map_ok``, ``_local_spec``) has no counterpart: a process's
shards are a batch axis here. Under ranks (:mod:`..parallel.distributed`)
the env blocks come through one ``all_to_all_single`` an assembly
(:meth:`..parallel.dist.DistContext.env_blocks`), the probe's verdict is
summed over ranks, and the coarse level of :func:`build_p1_coarse_dist`
is refused, as the reference's multi-process driver keeps to one level.

Memory: S * K_l * L^2 f32 with L = B_N + B_H; the assembly's f64
scratch is S * K_l * (L+1)^2.
"""

from __future__ import annotations

import numpy as np
import torch

from .direct import batched_inv_f32

F32 = torch.float32


def build_local_matrices(ctx, A_el, free, rel_shift: float = 1e-7,
                         env: bool = True):
    """Per-shard dense local matrices, (K_l, L, L) / (S, K_l, L, L) in
    A_el's dtype, with identity on constrained and padded slots and a
    ``rel_shift * max|diag|`` shift on the free diagonals.

    ctx:   :class:`..parallel.dist.DistContext`.
    A_el:  flat element blocks (K_l*B_E, n, n) or batched (S, K_l*B_E, n,
           n).
    free:  (Kb,) / (S, Kb) bool masks (False = Dirichlet or padding).
    env:   True (default) adds each shard's env-element blocks, so the
           local matrix is the true principal submatrix; False keeps the
           shard's own elements only (the partial "Neumann" matrix)."""
    squeeze = A_el.ndim == 3
    if squeeze:
        A_el, free = A_el[None], free[None]
    S = A_el.shape[0]
    plan = ctx.plan
    K, B_E, n = ctx.K_local, plan.B_E, ctx.n
    L = plan.B_N + plan.B_H
    dev, dt = A_el.device, A_el.dtype

    f_loc = ctx.local_with_halo(free.to(dt))                  # (S, K_l, L)
    s_ix = torch.arange(S, device=dev)[:, None, None, None, None]
    k_ix = torch.arange(K, device=dev)[None, :, None, None, None]

    def add_blocks(A, blocks, dm):
        shape = blocks.shape                                 # (S, K, B, n, n)
        A.index_put_((s_ix.expand(shape), k_ix.expand(shape),
                      dm[None, :, :, :, None].expand(shape),
                      dm[None, :, :, None, :].expand(shape)), blocks,
                     accumulate=True)

    # L+1-wide scratch: slot L is the drop slot for env dofs outside the
    # shard's local set (own-element dofs are always < L)
    A = torch.zeros((S, K, L + 1, L + 1), dtype=dt, device=dev)
    add_blocks(A, A_el.reshape(S, K, B_E, n, n),
               ctx.dofmap_local.reshape(K, B_E, n))
    if env:
        add_blocks(A, ctx.env_blocks(A_el), ctx.env_tables()[0])
    A = A[:, :, :L, :L] * f_loc[:, :, :, None] * f_loc[:, :, None, :]
    diag = torch.diagonal(A, dim1=-2, dim2=-1).abs()
    shift = rel_shift * diag.amax(dim=2, keepdim=True)
    A = A + torch.diag_embed((1.0 - f_loc) + shift * f_loc)
    return A[0] if squeeze else A


def factor_local_matrices(A_loc):
    """f32 LU factors ``(LU, pivots)`` of (..., K, L, L) local matrices."""
    return torch.linalg.lu_factor(A_loc.to(F32))


def invert_local_matrices(ctx, A_loc):
    """f32 explicit inverses of (K_l, L, L) / (S, K_l, L, L) local
    matrices: one (S*K_l, L, L) batch through
    :func:`.direct.batched_inv_f32` (kernel 1 on a CUDA tensor, its plain
    version on the CPU), checked per matrix by the contraction probe. A
    failed probe raises on every rank at once (the count of failed
    matrices is summed over ranks first), naming the (system, shard of this
    process) it failed on; the reference's library fallback is not carried
    over."""
    squeeze = A_loc.ndim == 3
    A4 = A_loc[None] if squeeze else A_loc
    S, K, L = A4.shape[0], A4.shape[1], A4.shape[2]
    inv = batched_inv_f32(A4.reshape(S * K, L, L),
                          batch_names=("system", "shard"),
                          batch_shape=(S, K),
                          reduce=ctx.allreduce_sum).reshape(S, K, L, L)
    return inv[0] if squeeze else inv


def _finish(ctx, z, r, restricted: bool):
    """Owned rows of the local corrections (RAS), or with the halo rows
    returned to their owners (``restricted=False``), as r's shape."""
    B_N = ctx.plan.B_N
    z = z.to(r.dtype)
    out = z[:, :, :B_N]
    if not restricted:
        out = out + ctx._backward_b(z[:, :, B_N:])
    out = out.reshape(z.shape[0], -1)
    return out[0] if r.ndim == 1 else out


def make_ras_inv_precond(ctx, inv, restricted: bool = True):
    """M(r) from explicit local inverses: one halo exchange and one batched
    f32 matvec a shard (IEEE f32: the package keeps TF32 off).

    ``inv``: (K_l, L, L) / (S, K_l, L, L) from
    :func:`invert_local_matrices`; a (K_l, L, L) inverse serves every
    system of a batched residual."""
    iv = inv[None] if inv.ndim == 3 else inv                  # (Si, K, L, L)

    def precond(r):
        rb = r[None] if r.ndim == 1 else r
        r_loc = ctx.local_with_halo(rb).to(F32)               # (S, K_l, L)
        ivb = iv.expand(r_loc.shape[0], *iv.shape[1:])
        z = torch.einsum("skij,skj->ski", ivb, r_loc)
        return _finish(ctx, z, r, restricted)

    return precond


def make_ras_precond(ctx, lu_piv, restricted: bool = True):
    """M(r): one halo exchange + batched f32 triangular solves on the LU
    factors of :func:`factor_local_matrices` ((K_l, L, L) for flat
    vectors or (S, K_l, L, L) for batched stacks). Same restriction semantics as
    :func:`make_ras_inv_precond`."""
    lu, piv = lu_piv

    def precond(r):
        rb = r[None] if r.ndim == 1 else r
        r_loc = ctx.local_with_halo(rb).to(F32)               # (S, K_l, L)
        S = r_loc.shape[0]
        lu_b = lu.expand(S, *lu.shape[-3:]) if lu.ndim == 3 else lu
        piv_b = piv.expand(S, *piv.shape[-2:]) if piv.ndim == 2 else piv
        z = torch.linalg.lu_solve(lu_b, piv_b, r_loc[..., None])[..., 0]
        return _finish(ctx, z, r, restricted)

    return precond


def make_schwarz_precond(ctx, A_el, free, rel_shift: float = 1e-7,
                         restricted: bool = True, env: bool = True,
                         use_inverse: bool = True):
    """Assemble, invert (or LU-factor: ``use_inverse=False``) and return
    the preconditioner in one call."""
    A_loc = build_local_matrices(ctx, A_el, free, rel_shift, env=env)
    if use_inverse:
        return make_ras_inv_precond(ctx, invert_local_matrices(ctx, A_loc),
                                    restricted)
    return make_ras_precond(ctx, factor_local_matrices(A_loc), restricted)


def build_p1_coarse_dist(ctx, op, free_np, dof_coords):
    """Piecewise-linear per-shard coarse level: 3 coarse dofs a shard,
    span{1, x, y} in shard-centred, scaled coordinates over its free owned
    dofs. The Galerkin matrix is built through the constrained operator
    itself (3K column applies at setup, each one halo exchange + SpMV), so
    it is exact for whatever ``op`` applies; it is inverted on the host in
    f64. Intended for the constant Poisson operator, built once a run.

    ``free_np``: host (Kb,) bool mask (False = Dirichlet or padding).
    Returns ``(cinv (3K, 3K), W (Kb, 3K))``, f64 on ``ctx.device``, for
    :func:`make_two_level_inv_precond`. One process only: under ranks the
    reference's multi-process driver keeps the Poisson operator on one
    level (``pnp_tpu/workloads/distributed_pnp.py:224``), and so does the
    port's."""
    if ctx.layout.ranked and ctx.layout.world_size > 1:
        raise NotImplementedError(
            "build_p1_coarse_dist: no coarse level across ranks; the "
            "multi-process driver runs one-level Schwarz, as the reference's "
            "(pnp_tpu/workloads/distributed_pnp.py:224)")
    plan = ctx.plan
    K, B_N = plan.K, plan.B_N
    og = plan.owned_global                                    # (K, B_N)
    m = og >= 0
    coords = np.zeros((K, B_N, 2))
    coords[m] = np.asarray(dof_coords)[og[m]]
    cnt = np.maximum(m.sum(axis=1), 1)[:, None]
    cent = (coords * m[:, :, None]).sum(axis=1) / cnt          # (K, 2)
    span = np.maximum(
        (np.abs(coords - cent[:, None, :]) * m[:, :, None]).max(axis=1),
        1e-12)                                                 # (K, 2)
    xs = (coords - cent[:, None, :]) / span[:, None, :]
    base3 = np.concatenate([np.ones((K, B_N, 1)), xs], axis=2)  # (K, B_N, 3)
    w = base3 * (m & np.asarray(free_np).reshape(K, B_N))[:, :, None]
    W_np = np.zeros((K, B_N, 3 * K))
    for k in range(K):
        W_np[k, :, 3 * k:3 * k + 3] = w[k]
    W = torch.as_tensor(W_np.reshape(K * B_N, 3 * K), device=ctx.device)
    AW = torch.stack([op(W[:, c]) for c in range(3 * K)], dim=1)
    Ac = (W.T @ AW).cpu().numpy()
    # regularize empty/degenerate modes (all-Dirichlet shards, collinear
    # free dofs): identity-ish rows, as the single-device p1 coarse level
    d = np.abs(np.diagonal(Ac))
    scale = d.max() + 1.0
    Ac = Ac + np.diag(np.where(d > 1e-9 * scale, 1e-6 * d, 1.0))
    cinv = torch.as_tensor(np.linalg.inv(Ac), device=ctx.device)
    return cinv, W


def make_two_level_inv_precond(ctx, inv, p1_coarse, op, free,
                               restricted: bool = True):
    """Multiplicative RAS + the per-shard linear coarse correction, for
    flat vectors (the distributed Poisson solve):
    z1 = RAS(r); z = z1 + W Ac^-1 W^T (r - A z1). One extra operator apply
    a call. Nonsymmetric: pair with BiCGSTAB."""
    ras = make_ras_inv_precond(ctx, inv, restricted)
    cinv, W = p1_coarse

    def precond(r):
        z1 = ras(r)
        resid = torch.where(free, r - op(z1), 0.0)
        zc = cinv.to(r.dtype) @ (resid @ W.to(r.dtype))
        return z1 + torch.where(free, W.to(r.dtype) @ zc, 0.0)

    return precond
