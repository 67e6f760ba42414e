"""Single-device overlapping block preconditioner (RAS) for large meshes
(port of ``pnp_tpu.solvers.block_ras``).

Above the dense tier (8,192 dofs) the reference solves with BiCGSTAB under
restricted additive Schwarz with exact local solves:

  * dofs are Morton-ordered and split into K contiguous owned blocks of
    about ``block_size`` (spatially compact, so the overlap stays thin);
  * each block's local set is its owned dofs plus every dof sharing an
    element with them (one element layer of overlap);
  * the true principal submatrices A[loc, loc] are assembled from the
    element blocks with one accumulating scatter and inverted explicitly
    in f32 (:func:`..solvers.direct.batched_inv_f32`, the Gauss-Jordan
    kernel on CUDA); each preconditioner apply is then a gather, one
    batched matvec and an owner-restricted scatter;
  * optionally a Galerkin coarse level, piecewise constant or piecewise
    linear per block (two-level Schwarz).

The decomposition is host numpy, copied from the reference line for line:
the block layout decides solver trajectories, so it must be identical.
Only the final index arrays become device tensors. Pad entries are
``ndof`` in ``loc2glob`` and ``L`` in ``elem_dof_local``; every gather and
scatter here carries the one extra slot they address.

Precision: local matrices, inverses and coarse inverses are f32 (they
precondition only); Krylov vectors stay in the caller's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..fem.geometry import index
from ..utils.profiling import host_copy, host_read, span
from .direct import batched_inv_f32

F32 = torch.float32


def morton_order(points: np.ndarray) -> np.ndarray:
    """Z-order permutation of 2-D points (contiguous runs are compact)."""
    pts = np.asarray(points)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = np.minimum(((pts - lo) / span * 1024).astype(np.uint32), 1023)
    code = np.zeros(len(pts), dtype=np.uint64)
    for b in range(10):
        code |= ((q[:, 0] >> b) & 1).astype(np.uint64) << np.uint64(2 * b)
        code |= ((q[:, 1] >> b) & 1).astype(np.uint64) << np.uint64(2 * b + 1)
    return np.argsort(code, kind="stable").astype(np.int32)


def _ranges_concat(counts: np.ndarray) -> np.ndarray:
    """[0..c0) ++ [0..c1) ++ ... as one vectorized array."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


@dataclasses.dataclass(frozen=True)
class BlockContext:
    """Static host-built block decomposition of a FunctionSpace.

    K:          number of blocks.
    B:          owned dofs per block (padded; pad entries = ndof).
    L:          local set size (owned + overlap, padded; pad = ndof).
    loc2glob:   (K, L) int64 global dof per local slot (ndof = padding).
    elem_ids:   (K, B_E2) int64 elements touching each block (pad 0).
    elem_dof_local: (K, B_E2, n) int64 local slot of each element dof in
                [0, L]; L is the drop slot (dof outside the block's local
                set, or padded element row).
    owner:      (ndof,) int64 owning block of every dof.
    ndof:       global dof count.
    """

    K: int
    B: int
    L: int
    loc2glob: Any
    elem_ids: Any
    elem_dof_local: Any
    owner: Any
    ndof: int


def build_block_context(dofmap: np.ndarray, ndof: int,
                        dof_coords: np.ndarray, block_size: int = 256,
                        device="cpu") -> BlockContext:
    """Host-side setup: Morton-ordered owned blocks + 1-element overlap."""
    dofmap = np.asarray(dofmap)
    E, n = dofmap.shape
    perm = morton_order(np.asarray(dof_coords))
    K = max(1, -(-ndof // block_size))
    owner = np.empty(ndof, np.int32)
    # balanced contiguous split of the Morton order
    bounds = np.linspace(0, ndof, K + 1).astype(np.int64)
    for k in range(K):
        owner[perm[bounds[k]:bounds[k + 1]]] = k

    eowner = owner[dofmap]                              # (E, n)
    E_ids = np.arange(E, dtype=np.int64)
    # pass 1 — local dof sets: owned dofs + every dof sharing an element
    # with them; group (block, element) pairs by block once
    pk = eowner.ravel().astype(np.int64)
    pe = np.repeat(E_ids, n)
    order = np.argsort(pk, kind="stable")
    pk_s, pe_s = pk[order], pe[order]
    k_starts = np.searchsorted(pk_s, np.arange(K))
    k_ends = np.searchsorted(pk_s, np.arange(K) + 1)

    own_lists = [perm[bounds[k]:bounds[k + 1]] for k in range(K)]
    loc_lists, extra_counts = [], []
    for k in range(K):
        touched = np.unique(dofmap[pe_s[k_starts[k]:k_ends[k]]])
        own_set = own_lists[k]
        extra = np.setdiff1d(touched, own_set, assume_unique=False)
        loc_lists.append(np.concatenate([own_set, extra]))
        extra_counts.append(len(extra))

    # pass 2 — assembly element lists: every element touching any local
    # dof, so the assembled A[loc, loc] is the true principal submatrix
    # (partial overlap rows make the local matrices near-singular).
    # A dof -> blocks membership join, grouped per block in ascending
    # element order.
    mem_d = np.concatenate(loc_lists)
    mem_k = np.repeat(np.arange(K, dtype=np.int64),
                      [len(l) for l in loc_lists])
    d_order = np.argsort(mem_d, kind="stable")
    mem_d_s, mem_k_s = mem_d[d_order], mem_k[d_order]
    d_starts = np.searchsorted(mem_d_s, np.arange(ndof))
    d_ends = np.searchsorted(mem_d_s, np.arange(ndof) + 1)
    d_counts = d_ends - d_starts
    flat_d = dofmap.ravel().astype(np.int64)            # (E*n,)
    cnt = d_counts[flat_d]
    gather_ix = (np.repeat(d_starts[flat_d], cnt)
                 + _ranges_concat(cnt))
    pair_k = mem_k_s[gather_ix]
    pair_e = np.repeat(np.repeat(E_ids, n), cnt)
    key = pair_k * np.int64(E) + pair_e
    key = np.unique(key)
    ek, ee = key // E, key % E
    e_starts = np.searchsorted(ek, np.arange(K))
    e_ends = np.searchsorted(ek, np.arange(K) + 1)
    elem_lists = [ee[e_starts[k]:e_ends[k]] for k in range(K)]

    B = max(len(l) for l in own_lists)
    L = max(B + max(extra_counts), 1)
    B_E2 = max(max(len(l) for l in elem_lists), 1)

    loc2glob = np.full((K, L), ndof, np.int64)
    glob2loc = np.full((K, ndof), L, np.int32)
    for k in range(K):
        own, loc = own_lists[k], loc_lists[k]
        # owned dofs occupy slots [0, len(own)); overlap starts at B so the
        # owned region is a fixed [0, B) window for the RAS restriction
        loc2glob[k, :len(own)] = own
        glob2loc[k, own] = np.arange(len(own))
        extra = loc[len(own):]
        loc2glob[k, B:B + len(extra)] = extra
        glob2loc[k, extra] = B + np.arange(len(extra))

    elem_ids = np.zeros((K, B_E2), np.int64)
    elem_dof_local = np.full((K, B_E2, n), L, np.int32)
    for k in range(K):
        l = elem_lists[k]
        elem_ids[k, :len(l)] = l
        elem_dof_local[k, :len(l)] = glob2loc[k, dofmap[l]]

    return BlockContext(
        K=K, B=B, L=L,
        loc2glob=index(loc2glob, device),
        elem_ids=index(elem_ids, device),
        elem_dof_local=index(elem_dof_local, device),
        owner=index(owner, device),
        ndof=ndof)


def build_block_context_for_space(space, block_size: int = 256,
                                  device="cpu") -> BlockContext:
    return build_block_context(np.asarray(space.dofmap), space.ndof,
                               space.dof_coords, block_size, device)


def _gather_padded(ctx: BlockContext, x):
    """x (..., ndof) -> local views (..., K, L); pad slots read 0."""
    x_ext = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
    return x_ext[..., ctx.loc2glob]


def assemble_local_matrices(ctx: BlockContext, A_el, free,
                            rel_shift: float = 0.0):
    """Constrained local (subdomain) matrices, (K, L, L) or (S, K, L, L)
    f32, from element blocks (E, n, n) or (S, E, n, n) and masks (ndof,)
    or (S, ndof): one accumulating scatter into an (S, K, L+1, L+1)
    buffer whose last row and column are the drop slot, sliced off.
    Constrained and pad slots get identity rows; ``rel_shift`` adds that
    fraction of each block's largest diagonal entry to its free
    diagonal."""
    squeeze = A_el.ndim == 3
    if squeeze:
        A_el, free = A_el[None], free[None]
    S = A_el.shape[0]
    K, L = ctx.K, ctx.L
    _, BE, n = ctx.elem_dof_local.shape
    dev = A_el.device
    Ae = A_el.to(F32)[:, ctx.elem_ids]                  # (S, K, BE, n, n)
    shape = (S, K, BE, n, n)
    s_ix = torch.arange(S, device=dev)[:, None, None, None, None]
    k_ix = torch.arange(K, device=dev)[None, :, None, None, None]
    edl = ctx.elem_dof_local[None]
    A = torch.zeros((S, K, L + 1, L + 1), dtype=F32, device=dev)
    A.index_put_((s_ix.expand(shape), k_ix.expand(shape),
                  edl[:, :, :, :, None].expand(shape),
                  edl[:, :, :, None, :].expand(shape)), Ae, accumulate=True)
    A = A[:, :, :L, :L]
    fl = _gather_padded(ctx, free.to(F32))              # (S, K, L)
    A = A * fl[:, :, :, None] * fl[:, :, None, :]
    bump = 1.0 - fl
    if rel_shift:
        diag = torch.diagonal(A, dim1=-2, dim2=-1).abs()
        bump = bump + rel_shift * diag.amax(dim=-1, keepdim=True) * fl
    A = A + torch.diag_embed(bump)
    return A[0] if squeeze else A


def invert_local_matrices(A):
    """Batched f32 inverses of assembled local matrices, (K, L, L) or
    (S, K, L, L) -> same shape: one (S*K, L, L) batch through
    :func:`..solvers.direct.batched_inv_f32` (kernel 1 on CUDA, checked
    by the contraction probe; a failed probe raises naming the (system,
    block) it failed on)."""
    squeeze = A.ndim == 3
    A4 = A[None] if squeeze else A
    S, K, L = A4.shape[0], A4.shape[1], A4.shape[2]
    inv = batched_inv_f32(A4.reshape(S * K, L, L),
                          batch_names=("system", "block"),
                          batch_shape=(S, K)).reshape(S, K, L, L)
    return inv[0] if squeeze else inv


def build_local_inverses(ctx: BlockContext, A_el, free,
                         rel_shift: float = 0.0):
    """Constrained local inverses, (K, L, L) or (S, K, L, L) f32."""
    return invert_local_matrices(
        assemble_local_matrices(ctx, A_el, free, rel_shift))


def make_ras_precond(ctx: BlockContext, inv, free, restricted: bool = True):
    """M(r): gather -> batched f32 matvec -> owner-restricted scatter, in
    a ``ras.local`` span.

    ``inv``: (K, L, L) or (S, K, L, L) f32 local inverses. Accepts flat
    (ndof,) or batched (S, ndof) residuals. Identity on constrained dofs.
    ``restricted=True`` (RAS) takes each dof's correction from its owner
    block only (nonsymmetric: pair with BiCGSTAB); ``False`` adds every
    block's correction (symmetric additive Schwarz, usable with CG)."""
    own = ctx.loc2glob[:, :ctx.B].reshape(-1)           # (K*B,) pad = ndof
    l2g = ctx.loc2glob.reshape(-1)

    def precond(r):
        with span("ras.local"):
            squeeze = r.ndim == 1
            rb = r[None] if squeeze else r              # (S, ndof)
            fb = free[None] if free.ndim == 1 else free
            S = rb.shape[0]
            r_loc = _gather_padded(ctx, torch.where(fb, rb, 0.0))  # (S, K, L)
            iv = inv[None] if inv.ndim == 3 else inv
            iv = iv.expand((S,) + iv.shape[1:])
            z = torch.matmul(iv, r_loc.to(F32)[..., None])[..., 0].to(
                rb.dtype)
            out = rb.new_zeros((S, ctx.ndof + 1))
            if restricted:
                out.index_add_(1, own, z[:, :, :ctx.B].reshape(S, -1))
            else:
                out.index_add_(1, l2g, z.reshape(S, -1))
            out = torch.where(fb, out[:, :ctx.ndof], rb)
            return out[0] if squeeze else out

    return precond


def _block_frame(ctx: BlockContext, dof_coords):
    """Block-centred, span-scaled dof coordinates (ndof, 2) (host)."""
    K = ctx.K
    owner = host_copy(ctx.owner)
    coords = np.asarray(dof_coords)
    cent = np.zeros((K, 2))
    cnt = np.zeros(K)
    np.add.at(cent, owner, coords)
    np.add.at(cnt, owner, 1.0)
    cent /= np.maximum(cnt, 1.0)[:, None]
    span = np.zeros((K, 2))
    np.maximum.at(span, owner, np.abs(coords - cent[owner]))
    span = np.maximum(span, 1e-12)
    return owner, (coords - cent[owner]) / span[owner]


def _regularized_inverse(Ac):
    """Empty or degenerate coarse modes (all-Dirichlet blocks, collinear
    free dofs) get identity-ish rows; then an f32 inverse, off any
    kernel of this repository (the reference uses ``jnp.linalg.inv``),
    whose failure flag is one host read."""
    d = torch.diagonal(Ac, dim1=-2, dim2=-1)
    scale = d.abs().amax(dim=-1, keepdim=True) + 1.0
    Ac = Ac + torch.diag_embed(torch.where(d.abs() > 1e-9 * scale,
                                           1e-6 * d.abs(), 1.0))
    inv, info = torch.linalg.inv_ex(Ac)
    if host_read((info != 0).any()):
        raise torch.linalg.LinAlgError("the p1 coarse matrix is singular")
    return inv


def build_p1_coarse(ctx: BlockContext, A_el, dofmap, free, dof_coords,
                    n_modes: int = 3):
    """Piecewise-polynomial coarse level: span{1, x, y[, P2...]} per block.

    ``n_modes=3``: constant + both linear modes in block-centred,
    span-scaled coordinates; ``6`` adds {P2(x), xy, P2(y)} (Legendre
    P2 = (3t^2-1)/2). Galerkin coarse matrix assembled from the element
    blocks with one accumulating scatter of (E, nM, nM) weighted blocks.

    Returns ``(coarse_inv (MK, MK) f32, w3 (ndof, M) f64, idx3 (ndof, M)
    int64)`` for :func:`make_two_level_precond`. Flat systems only (the
    constant Poisson operator, factored once)."""
    assert A_el.ndim == 3, "linear coarse: flat systems only"
    assert n_modes in (3, 6), n_modes
    M, K, ndof = n_modes, ctx.K, ctx.ndof
    dev = A_el.device
    owner, xs = _block_frame(ctx, dof_coords)
    cols = [np.ones((ndof, 1)), xs]
    if M == 6:
        p2 = 0.5 * (3.0 * xs * xs - 1.0)                # Legendre P2
        cols += [p2[:, :1], (xs[:, :1] * xs[:, 1:]), p2[:, 1:]]
    free_np = host_copy(free)
    w3_np = np.concatenate(cols, axis=1) * free_np[:, None]    # (ndof, M)
    # coarse dof of (dof, mode); constrained dofs -> drop row MK
    idx3_np = np.where(free_np[:, None], owner[:, None] * M + np.arange(M),
                       M * K)
    w3 = torch.as_tensor(w3_np, device=dev)
    idx3 = index(idx3_np, dev)
    E, n = dofmap.shape
    w_el = w3[dofmap].to(F32)                           # (E, n, M)
    rows = idx3[dofmap].reshape(E, n * M)
    Aw = torch.einsum("eij,eia,ejb->eiajb", A_el.to(F32), w_el, w_el)
    shape = (E, n * M, n * M)
    Ac = torch.zeros((M * K + 1, M * K + 1), dtype=F32, device=dev)
    Ac.index_put_((rows[:, :, None].expand(shape),
                   rows[:, None, :].expand(shape)), Aw.reshape(shape),
                  accumulate=True)
    return _regularized_inverse(Ac[:M * K, :M * K]), w3, idx3


def build_p1_coarse_batched(ctx: BlockContext, A_el, dofmap, free,
                            dof_coords):
    """Batched piecewise-linear coarse level for (S, E, n, n) species stage
    systems with per-system masks ``free`` (S, ndof). Returns
    ``(coarse_inv (S, 3K, 3K) f32, w3 (S, ndof, 3), idx3 (S, ndof, 3))``
    for :func:`make_p1_coarse_correction`."""
    assert A_el.ndim == 4, "batched coarse: (S, E, n, n) element blocks"
    S = A_el.shape[0]
    K, ndof = ctx.K, ctx.ndof
    dev = A_el.device
    owner, xs = _block_frame(ctx, dof_coords)
    base3 = np.concatenate([np.ones((ndof, 1)), xs], axis=1)   # (ndof, 3)
    free_np = host_copy(free)                                # (S, ndof)
    w3_np = base3[None] * free_np[:, :, None]                   # (S, ndof, 3)
    idx3_np = np.where(free_np[:, :, None],
                       owner[None, :, None] * 3 + np.arange(3)[None, None],
                       3 * K)
    w3 = torch.as_tensor(w3_np, device=dev)
    idx3 = index(idx3_np, dev)
    E, n = dofmap.shape
    w_el = w3[:, dofmap].to(F32)                        # (S, E, n, 3)
    rows = idx3[:, dofmap].reshape(S, E, n * 3)
    Aw = torch.einsum("seij,seia,sejb->seiajb", A_el.to(F32), w_el, w_el)
    shape = (S, E, n * 3, n * 3)
    s_ix = torch.arange(S, device=dev)[:, None, None, None]
    Ac = torch.zeros((S, 3 * K + 1, 3 * K + 1), dtype=F32, device=dev)
    Ac.index_put_((s_ix.expand(shape), rows[:, :, :, None].expand(shape),
                   rows[:, :, None, :].expand(shape)), Aw.reshape(shape),
                  accumulate=True)
    return _regularized_inverse(Ac[:, :3 * K, :3 * K]), w3, idx3


def make_p1_coarse_correction(ctx: BlockContext, p1_coarse, free):
    """r -> P Ac^-1 R r for the piecewise-polynomial coarse level, in a
``ras.coarse`` span.

    Takes the flat tables of :func:`build_p1_coarse` (shared across a
    batch) or the per-system tables of :func:`build_p1_coarse_batched`.
    The owner blocks are the [0, B) owned slots of ``ctx.loc2glob``, so
    restriction is a fixed-shape gather and prolongation one
    unique-index write (pad slots write the drop slot). Dtype follows the
    residual."""
    cinv, w3, idx3 = p1_coarse
    K3 = cinv.shape[-1]
    K, B = ctx.K, ctx.B
    M = w3.shape[-1]                                    # modes per block
    batched_tables = w3.ndim == 3
    own = ctx.loc2glob[:, :B]                           # (K, B), pad = ndof
    # per-owned-slot mode weights (S?, K, B, M); pad slots read 0
    w_ext = torch.cat([w3, w3.new_zeros(w3.shape[:-2] + (1, M))], dim=-2)
    w_own = w_ext[..., own, :]

    def coarse(r):
        rb = r[None] if r.ndim == 1 else r
        S = rb.shape[0]
        if batched_tables:
            # a flat residual against per-system tables would broadcast
            # and return only system 0's correction
            assert S == w3.shape[0], (
                "batched p1-coarse tables need a matching (S, ndof) "
                f"residual batch: got {S} vs S={w3.shape[0]}")
        with span("ras.coarse"):
            wo = (w_own if batched_tables else w_own[None]).to(rb.dtype)
            wo = wo.expand(S, K, B, M)
            rb_ext = torch.cat([rb, rb.new_zeros((S, 1))], dim=1)
            r_own = rb_ext[:, own]                      # (S, K, B)
            rc = torch.einsum("skb,skbm->skm", r_own, wo).reshape(S, K3)
            ci = (cinv if cinv.ndim == 3 else cinv[None]).to(rb.dtype)
            zc = torch.matmul(ci.expand(S, K3, K3), rc[..., None])[..., 0]
            z_own = torch.einsum("skm,skbm->skb", zc.reshape(S, K, M), wo)
            z = rb.new_zeros((S, ctx.ndof + 1))
            z[:, own.reshape(-1)] = z_own.reshape(S, -1)
            z = torch.where(free, z[:, :ctx.ndof], 0.0)
            return z[0] if r.ndim == 1 else z

    return coarse


def build_coarse_inverse(ctx: BlockContext, A_el, dofmap, free):
    """f32 inverse of the piecewise-constant Galerkin coarse matrix: one
    constant per block over its owned free dofs, assembled from element
    blocks by owner id (constrained dofs go to a drop row). Returns
    (K, K) or (S, K, K)."""
    squeeze = A_el.ndim == 3
    if squeeze:
        A_el, free = A_el[None], free[None]
    S, E, n, _ = A_el.shape
    K = ctx.K
    dev = A_el.device
    o = torch.where(free, ctx.owner[None, :], K)        # (S, ndof)
    eo = o[:, dofmap]                                    # (S, E, n)
    shape = (S, E, n, n)
    s_ix = torch.arange(S, device=dev)[:, None, None, None].expand(shape)
    Ac = torch.zeros((S, K + 1, K + 1), dtype=F32, device=dev)
    Ac.index_put_((s_ix, eo[:, :, :, None].expand(shape),
                   eo[:, :, None, :].expand(shape)), A_el.to(F32),
                  accumulate=True)
    Ac = Ac[:, :K, :K]
    # empty blocks (all-Dirichlet) -> identity
    d = torch.diagonal(Ac, dim1=-2, dim2=-1)
    Ac = Ac + torch.diag_embed(torch.where(d.abs() > 0.0, 0.0, 1.0)
                               + 1e-6 * d.abs())
    inv = torch.linalg.inv(Ac)
    return inv[0] if squeeze else inv


def make_two_level_precond(ctx: BlockContext, inv, coarse_inv, op, free,
                           p1_coarse=None):
    """Multiplicative RAS + coarse correction:
    z1 = RAS(r); z = z1 + P Ac^-1 R (r - A z1). One extra operator apply
    per call; nonsymmetric (pair with BiCGSTAB). ``p1_coarse`` (from
    :func:`build_p1_coarse` or :func:`build_p1_coarse_batched`) switches
    the coarse space from piecewise constant to piecewise polynomial
    (``coarse_inv`` is then ignored)."""
    ras = make_ras_precond(ctx, inv, free)
    if p1_coarse is not None:
        coarse = make_p1_coarse_correction(ctx, p1_coarse, free)
    else:
        K = ctx.K

        def coarse(r):
            rb = r[None] if r.ndim == 1 else r
            S = rb.shape[0]
            o = torch.where(free, ctx.owner, K)
            ob = (o if o.ndim == 2 else o[None]).expand(rb.shape)
            rc = rb.new_zeros((S, K + 1)).scatter_add_(1, ob, rb)[:, :K]
            ci = (coarse_inv if coarse_inv.ndim == 3
                  else coarse_inv[None]).to(rb.dtype)
            zc = torch.matmul(ci.expand(S, K, K), rc[..., None])[..., 0]
            zc_ext = torch.cat([zc, zc.new_zeros((S, 1))], dim=1)
            z = torch.where(free, torch.gather(zc_ext, 1, ob), 0.0)
            return z[0] if r.ndim == 1 else z

    def precond(r):
        z1 = ras(r)
        resid = torch.where(free, r - op(z1), 0.0)
        return z1 + coarse(resid)

    return precond
