"""Owner-partitioned SpMV with a packed halo exchange (port of
``pnp_tpu.parallel.halo``).

The analogue of DUNE-ISTL's nonoverlapping point-to-point halo exchange:

  * dofs are partitioned by OWNER shard (the first shard, in element
    partition order, whose elements touch the dof) and renumbered so each
    shard's owned dofs are a contiguous padded block: vectors are (K, B_N);
  * each shard's elements reference [owned | halo] local indices; halo
    values move as PACKED per-pair buffers (only what a destination needs,
    padded to the widest pair H), K^2 H values an exchange;
  * contributions landing on halo rows are returned to their owners by the
    transposed exchange (same index plan, reversed direction).

In one process the K shards are a leading batch axis of tensors on one
device: the exchange is a gather into (K_src, K_dst, H) buffers, a
transpose of the shard axes and a scatter, written without materializing
any K x K copy of a vector (``expand`` + ``torch.gather``). Under ranks
each holds K_l of the shards and the transpose becomes one
``all_to_all_single`` (:mod:`.distributed`). :func:`forward_halo` and
:func:`backward_return` are the only two places where a shard reads
another shard's values; :class:`..parallel.dist.DistContext` exchanges
through them too.

The plan is host numpy, copied from the reference line for line: it
decides the partition, so its arrays must be identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class HaloPlan:
    """Static distribution plan (host-built numpy; tensors on use).

    K:        number of shards.
    B_E:      padded elements per shard.
    B_N:      padded owned dofs per shard.
    B_H:      padded halo dofs per shard.
    H_pair:   padded per-pair exchange width.
    dofmap_local: (K, B_E, n) int32 — element dofs as local indices into
              the [owned (B_N) | halo (B_H)] local vector (padded elements
              point at a zero-weight scratch row, index 0).
    elem_ids: (K, B_E) global element ids (-1 = padding).
    send_idx: (K, K, H_pair) — send_idx[s, t]: positions in s's owned
              block that shard t needs (pad: 0).
    recv_pos: (K, K, H_pair) — recv_pos[t, s]: positions in t's halo block
              for values arriving from s (pad: B_H, dropped on scatter).
    owned_global: (K, B_N) int64 global dof of each owned slot (-1 pad).
    owner_of: (ndof,) owner shard per global dof.
    ndof:     global dof count.
    """

    K: int
    B_E: int
    B_N: int
    B_H: int
    H_pair: int
    dofmap_local: np.ndarray
    elem_ids: np.ndarray
    send_idx: np.ndarray
    recv_pos: np.ndarray
    owned_global: np.ndarray
    owner_of: np.ndarray
    ndof: int


def build_halo_plan(dofmap: np.ndarray, ndof: int, K: int,
                    element_perm: np.ndarray | None = None) -> HaloPlan:
    dofmap = np.asarray(dofmap)
    E, n = dofmap.shape
    perm = (np.asarray(element_perm) if element_perm is not None
            else np.arange(E))
    B_E = -(-E // K)
    shard_elems = []
    for s in range(K):
        ids = perm[s * B_E:(s + 1) * B_E]
        pad = np.full(B_E - ids.size, -1, dtype=ids.dtype)
        shard_elems.append(np.concatenate([ids, pad]))
    elem_ids = np.stack(shard_elems)                     # (K, B_E)

    owner = np.full(ndof, -1, dtype=np.int32)
    for s in range(K):
        ids = elem_ids[s][elem_ids[s] >= 0]
        dofs = np.unique(dofmap[ids])
        fresh = dofs[owner[dofs] < 0]
        owner[fresh] = s
    owner[owner < 0] = 0                                 # untouched dofs

    owned = [np.where(owner == s)[0] for s in range(K)]
    B_N = max(max(len(o) for o in owned), 1)
    owned_global = np.full((K, B_N), -1, dtype=np.int64)
    pos_of = np.zeros(ndof, dtype=np.int64)              # slot within owner
    for s in range(K):
        owned_global[s, :len(owned[s])] = owned[s]
        pos_of[owned[s]] = np.arange(len(owned[s]))

    halos = []
    for s in range(K):
        ids = elem_ids[s][elem_ids[s] >= 0]
        dofs = np.unique(dofmap[ids])
        h = dofs[owner[dofs] != s]
        # deterministic order: by (owner, slot)
        h = h[np.lexsort((pos_of[h], owner[h]))]
        halos.append(h)
    B_H = max(max(len(h) for h in halos), 1)

    H_pair = 1
    send_lists = [[None] * K for _ in range(K)]
    recv_lists = [[None] * K for _ in range(K)]
    for t in range(K):
        for s in range(K):
            if s == t:
                continue
            sel = np.where(owner[halos[t]] == s)[0]      # halo slots in t
            send_lists[s][t] = pos_of[halos[t][sel]]     # slots in s owned
            recv_lists[t][s] = sel
            H_pair = max(H_pair, sel.size)
    send_idx = np.zeros((K, K, H_pair), dtype=np.int32)
    recv_pos = np.full((K, K, H_pair), B_H, dtype=np.int32)  # pad -> drop
    for s in range(K):
        for t in range(K):
            if s == t or send_lists[s][t] is None:
                continue
            m = send_lists[s][t].size
            send_idx[s, t, :m] = send_lists[s][t]
            recv_pos[t, s, :m] = recv_lists[t][s]

    # local dofmaps
    halo_slot = {}
    for s in range(K):
        for k, d in enumerate(halos[s]):
            halo_slot[(s, d)] = B_N + k
    dofmap_local = np.zeros((K, B_E, n), dtype=np.int32)
    for s in range(K):
        for e_loc, e in enumerate(elem_ids[s]):
            if e < 0:
                continue
            for k, d in enumerate(dofmap[e]):
                if owner[d] == s:
                    dofmap_local[s, e_loc, k] = pos_of[d]
                else:
                    dofmap_local[s, e_loc, k] = halo_slot[(s, d)]

    return HaloPlan(K=K, B_E=B_E, B_N=B_N, B_H=B_H, H_pair=H_pair,
                    dofmap_local=dofmap_local, elem_ids=elem_ids,
                    send_idx=send_idx, recv_pos=recv_pos,
                    owned_global=owned_global, owner_of=owner, ndof=ndof)


def partition_vector(plan: HaloPlan, x: np.ndarray) -> np.ndarray:
    """Global (ndof,) -> owner-partitioned (K, B_N) (padded slots 0)."""
    out = np.zeros((plan.K, plan.B_N), dtype=np.asarray(x).dtype)
    mask = plan.owned_global >= 0
    out[mask] = np.asarray(x)[plan.owned_global[mask]]
    return out


def unpartition_vector(plan: HaloPlan, xs: np.ndarray) -> np.ndarray:
    """Owner-partitioned (K, B_N) -> global (ndof,)."""
    xs = np.asarray(xs)
    out = np.zeros(plan.ndof, dtype=xs.dtype)
    mask = plan.owned_global >= 0
    out[plan.owned_global[mask]] = xs[mask]
    return out


def partition_element_array(plan: HaloPlan, arr: np.ndarray) -> np.ndarray:
    """Element array (E, ...) -> (K, B_E, ...) per the plan (pad rows 0)."""
    arr = np.asarray(arr)
    out = np.zeros((plan.K, plan.B_E) + arr.shape[1:], dtype=arr.dtype)
    for s in range(plan.K):
        ids = plan.elem_ids[s]
        sel = ids >= 0
        out[s, sel] = arr[ids[sel]]
    return out


def plan_tensors(plan: HaloPlan, device, A_el=None):
    """The plan's index tables as int64 tensors on ``device``:
    ``(dofmap_local (K, B_E, n), send_idx (K, K, H), recv_pos (K, K, H))``,
    preceded by the element blocks partitioned to (K, B_E, n, n) f64 when
    ``A_el`` (E, n, n) is given. The port's counterpart of the reference's
    ``device_put_plan``."""
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    tables = (idx(plan.dofmap_local), idx(plan.send_idx),
              idx(plan.recv_pos))
    if A_el is None:
        return tables
    if isinstance(A_el, torch.Tensor):
        A_el = A_el.detach().cpu().numpy()
    A_p = torch.as_tensor(partition_element_array(plan, A_el),
                          dtype=torch.float64, device=device)
    return (A_p,) + tables


def _transpose_shards(buf):
    """The shard-axis swap with every shard in this process."""
    return buf.transpose(1, 2)


def forward_halo(x, send_idx, recv_pos, B_H: int, swap=None):
    """(S, K_l, B_N) owned values -> (S, K_l, B_H) halo values fetched from
    their owners: pack (S, K_l src, K dst, H) from this process's rows of
    ``send_idx`` (K_l, K, H), swap the shard axes, scatter through its rows
    of ``recv_pos`` into each destination's halo block (padded pairs land
    in a dropped slot B_H). ``swap``: the shard-axis swap, a transpose
    where all K shards are here (``K_l = K``, the default), one collective
    over ranks otherwise (:func:`.distributed.swap_shard_axes`)."""
    S, K_l, B_N = x.shape
    K, H = send_idx.shape[1], send_idx.shape[2]
    src = x[:, :, None, :].expand(S, K_l, K, B_N)
    buf = torch.gather(src, 3, send_idx[None].expand(S, K_l, K, H))
    buf_t = (swap or _transpose_shards)(buf).reshape(S, K_l, K * H)
    halo = torch.zeros((S, K_l, B_H + 1), dtype=x.dtype, device=x.device)
    halo.scatter_(2, recv_pos.reshape(K_l, K * H)[None].expand(
        S, K_l, K * H), buf_t)
    return halo[:, :, :B_H]


def backward_return(y_halo, send_idx, recv_pos, B_N: int, swap=None):
    """(S, K_l, B_H) additive halo contributions -> (S, K_l, B_N) updates
    of their owners: the transposed exchange of :func:`forward_halo`, the
    same ``swap``."""
    S, K_l, B_H = y_halo.shape
    K, H = send_idx.shape[1], send_idx.shape[2]
    yh = torch.cat([y_halo, y_halo.new_zeros((S, K_l, 1))], dim=2)
    src = yh[:, :, None, :].expand(S, K_l, K, B_H + 1)
    buf = torch.gather(src, 3, recv_pos[None].expand(S, K_l, K, H))
    buf = torch.where(recv_pos[None] < B_H, buf, 0.0)    # (S,Ksend,Kown,H)
    buf_t = (swap or _transpose_shards)(buf).reshape(S, K_l, K * H)
    acc = torch.zeros((S, K_l, B_N), dtype=y_halo.dtype, device=y_halo.device)
    acc.scatter_add_(2, send_idx.reshape(K_l, K * H)[None].expand(
        S, K_l, K * H), buf_t)
    return acc


def _assemble_local(plan: HaloPlan, x_parts, dofmap_local, send_idx,
                    recv_pos, element_kernel):
    """Gather [owned | halo] element values, apply ``element_kernel`` and
    scatter back with halo contributions returned to their owners."""
    K, B_N, B_H = plan.K, plan.B_N, plan.B_H
    dm = dofmap_local.reshape(K, -1)
    halo = forward_halo(x_parts[None], send_idx, recv_pos, B_H)[0]
    xloc = torch.cat([x_parts, halo], dim=1)             # (K, B_N + B_H)
    xe = torch.gather(xloc, 1, dm).reshape(K, plan.B_E, -1)
    re = element_kernel(xe)                              # (K, B_E, n)
    yloc = torch.zeros((K, B_N + B_H), dtype=re.dtype, device=re.device)
    yloc.scatter_add_(1, dm, re.reshape(K, -1))
    return yloc[:, :B_N] + backward_return(yloc[None, :, B_N:], send_idx,
                                           recv_pos, B_N)[0]


def make_sharded_spmv(plan: HaloPlan, device, A_el_sharded, dofmap_local,
                      send_idx, recv_pos):
    """Return ``spmv(x_parts (K, B_N)) -> y_parts`` and ``dot(a, b)`` on
    ``device``, from the plan's tensors (:func:`plan_tensors`)."""
    A = A_el_sharded.to(device)
    dofmap_local, send_idx, recv_pos = (
        t.to(device) for t in (dofmap_local, send_idx, recv_pos))

    def spmv(x_parts):
        return _assemble_local(
            plan, x_parts, dofmap_local, send_idx, recv_pos,
            lambda xe: torch.einsum("keij,kej->kei", A, xe))

    def dot(a, b):
        return torch.sum(a * b)

    return spmv, dot


def make_sharded_assembler(plan: HaloPlan, device, dofmap_local, send_idx,
                           recv_pos):
    """Owner-partitioned assembly of any element kernel: returns
    ``assemble(x_parts, element_kernel)`` where ``element_kernel`` maps
    gathered element values (K, B_E, n) to element residuals (K, B_E, n)
    and the result is the assembled (K, B_N) residual, halo contributions
    returned to their owners, on ``device``."""
    dofmap_local, send_idx, recv_pos = (
        t.to(device) for t in (dofmap_local, send_idx, recv_pos))

    def assemble(x_parts, element_kernel):
        return _assemble_local(plan, x_parts, dofmap_local, send_idx,
                               recv_pos, element_kernel)

    return assemble
