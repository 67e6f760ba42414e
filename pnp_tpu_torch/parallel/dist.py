"""Owner-partitioned distribution context (port of
``pnp_tpu.parallel.dist``).

Generalizes the packed halo-exchange SpMV of :mod:`.halo` into what the
distributed drivers need: batched vectors (the two species' stage systems
are (S, N) stacks), nonlinear element gathers and scatters (PB and
drift-diffusion reassembly), and host partition/unpartition for IO. It is
the counterpart of DUNE's nonoverlapping decomposition (ghost dofs + NOVLP
halo exchange, src/instationary_pnp_from_pb_md.hh:127-144):

  * dof vectors live owner-partitioned as flat ``(K * B_N,)`` tensors
    (shard s owns slots ``[s*B_N, (s+1)*B_N)``; padded slots are
    permanently zero and marked constrained);
  * element tables live element-partitioned as flat ``(K * B_E, ...)``
    tensors, so every element kernel of :mod:`..operators.volume` (and the
    PB kernel) runs unchanged on them;
  * halo values move as packed per-pair buffers. The exchange
    (:meth:`DistContext._forward_b`, :meth:`DistContext._backward_b`) is
    the only place where shards read each other's data; Krylov dot
    products are plain sums over the flat axis.

The shards are laid out by a :class:`.distributed.RankLayout`. In one
process (no process group) the K shards are a leading batch axis of
tensors on one device. Under P ranks (:mod:`.distributed`), rank p holds
shards ``[p K_l, (p + 1) K_l)``: its rows of the index tables, vectors of
``K_l * B_N`` slots and element tables of ``K_l * B_E`` rows, the same
batch-axis code on them. Every place that reads across shards is then a
collective: the halo exchange and the env-element gather (one
``all_to_all_single`` each), the Krylov and Newton reductions
(:meth:`DistContext.allreduce_sum`) and the gather of a global vector for
IO (:meth:`DistContext.to_host_global`, the reference's
``process_allgather``). The host plan is global on every rank: each rank
builds it itself. Not ported: the reference's sharding placement
(``put_sharded``, ``put_global``, ``_pin``, ``host_tables``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import distributed as D
from .distributed import RankLayout
from .halo import (HaloPlan, backward_return, build_halo_plan, forward_halo,
                   partition_element_array)


def locality_element_order(mesh) -> np.ndarray:
    """Morton (Z-order) permutation of elements by centroid: contiguous
    blocks of the order are spatially compact, which keeps halos thin."""
    c = mesh.nodes[mesh.tris].mean(axis=1)          # (E, 2) centroids
    lo, hi = c.min(axis=0), c.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = np.minimum(((c - lo) / span * 1024).astype(np.uint32), 1023)
    code = np.zeros(len(c), dtype=np.uint64)
    for b in range(10):
        code |= ((q[:, 0] >> b) & 1).astype(np.uint64) << np.uint64(2 * b)
        code |= ((q[:, 1] >> b) & 1).astype(np.uint64) << np.uint64(2 * b + 1)
    return np.argsort(code, kind="stable").astype(np.int32)


def _build_env_maps(plan: HaloPlan, dofmap: np.ndarray):
    """Environment-element maps for true-submatrix subdomain assembly.

    Each shard also gathers the element blocks of its *env elements*
    (owned elsewhere, touching any of its local dofs), so its assembled
    local matrix is the TRUE principal submatrix A[loc, loc] of the global
    operator, not the weaker partial "Neumann" matrix of its own elements.

    Returns (env_ids, env_dofmap):
      env_ids    (K, B_E2) int32 — flat positions (k*B_E + e_loc) into the
                 flat element-block array (pad: 0, neutralized by dofmap);
      env_dofmap (K, B_E2, n) int32 — local slots in [0, L]; L (=B_N+B_H)
                 is the drop slot for dofs outside the shard's local set
                 and for padded env rows.
    """
    K, B_E = plan.K, plan.B_E
    E, n = dofmap.shape
    L = plan.B_N + plan.B_H

    pos_of_elem = np.zeros(E, np.int64)
    owner_elem = np.zeros(E, np.int32)
    for s in range(K):
        ids = plan.elem_ids[s]
        sel = np.where(ids >= 0)[0]
        pos_of_elem[ids[sel]] = s * B_E + sel
        owner_elem[ids[sel]] = s

    glob2loc = np.full((K, plan.ndof), L, np.int32)
    for s in range(K):
        m = plan.owned_global[s] >= 0
        glob2loc[s, plan.owned_global[s][m]] = np.where(m)[0]
        ids = plan.elem_ids[s]
        sel = ids >= 0
        glob2loc[s, dofmap[ids[sel]].reshape(-1)] = (
            plan.dofmap_local[s, sel].reshape(-1))

    env_lists = [
        np.where((glob2loc[s, dofmap] < L).any(axis=1)
                 & (owner_elem != s))[0]
        for s in range(K)
    ]
    B_E2 = max(max(len(l) for l in env_lists), 1)
    env_ids = np.zeros((K, B_E2), np.int32)
    env_dofmap = np.full((K, B_E2, n), L, np.int32)
    for s in range(K):
        l = env_lists[s]
        env_ids[s, :len(l)] = pos_of_elem[l]
        env_dofmap[s, :len(l)] = glob2loc[s, dofmap[l]]
    return env_ids, env_dofmap


def _build_env_exchange(plan: HaloPlan, env_ids: np.ndarray,
                        env_dofmap: np.ndarray, world_size: int):
    """The env-element gather across ranks (:meth:`DistContext.env_blocks`).

    For each (source rank p, destination rank q): the rows of p's local
    element blocks that the env elements of q's shards need, each row
    once, padded to the widest pair H_env. Padded env rows (every dof the
    drop slot L) take nothing.

    Returns (send, take):
      send (P, P, H_env) int64 — send[p, q]: rows of p's (K_l * B_E)
           element blocks for q (pad: 0);
      take (P, K_l * B_E2) int64 — take[q, j]: where q's env element j
           lies in the (P_src * H_env) rows q receives (pad: 0, dropped).
    """
    P = world_size
    K_l = plan.K // P
    rows_of = K_l * plan.B_E                      # element rows a rank
    L = plan.B_N + plan.B_H
    real = (env_dofmap < L).any(axis=2)           # (K, B_E2)
    lists = [[None] * P for _ in range(P)]
    where = [[None] * P for _ in range(P)]
    H_env = 1
    for q in range(P):
        ids = env_ids[q * K_l:(q + 1) * K_l].reshape(-1).astype(np.int64)
        ok = real[q * K_l:(q + 1) * K_l].reshape(-1)
        for p in range(P):
            sel = np.where(ok & (ids // rows_of == p))[0]
            uniq, inv = np.unique(ids[sel] - p * rows_of, return_inverse=True)
            lists[p][q], where[p][q] = uniq, (sel, inv)
            H_env = max(H_env, uniq.size)
    send = np.zeros((P, P, H_env), np.int64)
    take = np.zeros((P, env_ids.shape[1] * K_l), np.int64)
    for q in range(P):
        for p in range(P):
            send[p, q, :lists[p][q].size] = lists[p][q]
            sel, inv = where[p][q]
            take[q, sel] = p * H_env + inv
    return send, take


@dataclasses.dataclass
class DistContext:
    """Owner-partitioned distribution context of this process's shards.

    Every vector op takes flat ``(Kb,)`` vectors or batched ``(S, Kb)``
    stacks, ``Kb = K_l * B_N`` (``K_l = K`` in one process); element
    tables are ``(K_l * B_E, ...)``."""

    plan: HaloPlan              # global, the same on every rank
    layout: RankLayout
    n: int                      # dofs per element
    dofmap_local: Any           # (K_l, B_E * n) int64, this rank's rows
    send_idx: Any               # (K_l, K, H) int64, this rank's rows
    recv_pos: Any               # (K_l, K, H) int64, this rank's rows
    dofmap_global: np.ndarray | None = None   # (E, n) host copy
    _env_maps: tuple | None = None
    _env_tensors: tuple | None = None

    @property
    def device(self):
        return self.layout.device

    @property
    def K(self):
        """The plan's shard count, over all ranks."""
        return self.plan.K

    @property
    def K_local(self):
        return self.layout.K_local

    @property
    def Kb(self):
        return self.K_local * self.plan.B_N

    @property
    def E_flat(self):
        return self.K_local * self.plan.B_E

    # ---- host-side partition helpers --------------------------------------
    def partition(self, x: np.ndarray) -> np.ndarray:
        """Global (ndof,) -> this rank's flat (Kb,) numpy (padded slots
        zero)."""
        plan = self.plan
        og = plan.owned_global[self.layout.shards]
        out = np.zeros(og.shape, dtype=np.asarray(x).dtype)
        m = og >= 0
        out[m] = np.asarray(x)[og[m]]
        return out.reshape(-1)

    def unpartition(self, xp) -> np.ndarray:
        """Flat (K * B_N,) over all shards -> global (ndof,) numpy."""
        plan = self.plan
        xp = np.asarray(xp).reshape(plan.K, plan.B_N)
        out = np.zeros(plan.ndof, dtype=xp.dtype)
        m = plan.owned_global >= 0
        out[plan.owned_global[m]] = xp[m]
        return out

    def to_host_global(self, v) -> np.ndarray:
        """(Kb,) / (S, Kb) tensor -> global numpy (ndof,) / (S, ndof) on
        every rank. Under ranks every rank's owned blocks are gathered first
        (a collective: every rank calls it); the plan's global order is
        rebuilt from the shards' slots, not from the ranks'."""
        if isinstance(v, torch.Tensor):
            if self.layout.ranked:
                v = torch.cat(D.gather_ranks(v), dim=-1)
            v = v.detach().cpu().numpy()
        v = np.asarray(v)
        if v.ndim == 1:
            return self.unpartition(v)
        return np.stack([self.unpartition(row) for row in v])

    def partition_elem(self, arr: np.ndarray) -> np.ndarray:
        """Element array (E, ...) -> this rank's flat (K_l*B_E, ...)."""
        out = partition_element_array(self.plan, np.asarray(arr))
        out = out[self.layout.shards]
        return out.reshape((-1,) + out.shape[2:])

    def pad_mask_flat(self) -> np.ndarray:
        """(Kb,) bool — True on REAL owned slots, False on padding."""
        return (self.plan.owned_global[self.layout.shards] >= 0).reshape(-1)

    def env_maps(self):
        """(env_ids (K, B_E2), env_dofmap (K, B_E2, n)) host numpy arrays
        over all shards (see :func:`_build_env_maps`), built at first use."""
        if self._env_maps is None:
            if self.dofmap_global is None:
                raise ValueError("DistContext built without the global dofmap")
            self._env_maps = _build_env_maps(self.plan, self.dofmap_global)
        return self._env_maps

    def env_tables(self):
        """This rank's env tables as int64 tensors, built at first use:
        ``(env_dofmap (K_l, B_E2, n), gather)``; ``gather`` is the (K_l *
        B_E2,) flat element positions in one process, the ``(send (P,
        H_env), take (K_l * B_E2,))`` rows of :func:`_build_env_exchange`
        under ranks."""
        if self._env_tensors is None:
            env_ids, env_dofmap = self.env_maps()
            idx = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                            device=self.device)
            lay = self.layout
            if lay.ranked:
                send, take = _build_env_exchange(self.plan, env_ids,
                                                 env_dofmap, lay.world_size)
                gather = (idx(send[lay.rank]), idx(take[lay.rank]))
            else:
                gather = idx(env_ids.reshape(-1))
            self._env_tensors = (idx(env_dofmap[lay.shards]), gather)
        return self._env_tensors

    def env_blocks(self, A_el):
        """(S, K_l*B_E, n, n) element blocks -> (S, K_l, B_E2, n, n): the
        blocks of the env elements of each of this rank's shards. Under
        ranks one ``all_to_all_single`` of (P, S, H_env, n, n) carries
        them from their owners."""
        env_dofmap, gather = self.env_tables()
        S, n = A_el.shape[0], self.n
        K_l, B_E2 = env_dofmap.shape[:2]
        if not self.layout.ranked:
            return A_el.index_select(1, gather).reshape(S, K_l, B_E2, n, n)
        send, take = gather
        P, H_env = send.shape
        buf = A_el.index_select(1, send.reshape(-1)).reshape(S, P, H_env, n, n)
        recv = D.all_to_all(buf.transpose(0, 1).contiguous())
        rows = recv.transpose(0, 1).reshape(S, P * H_env, n, n)
        return rows.index_select(1, take).reshape(S, K_l, B_E2, n, n)

    # ---- the exchange (batched: x is (S, K_l, B_N)) -------------------------
    def _swap(self):
        """The shard-axis swap of the exchange: a transpose in one process,
        one ``all_to_all_single`` under ranks."""
        if not self.layout.ranked:
            return None
        return lambda buf: D.swap_shard_axes(buf, self.layout)

    def _forward_b(self, x):
        """(S, K_l, B_N) -> (S, K_l, B_H) halo values fetched from owners."""
        return forward_halo(x, self.send_idx, self.recv_pos, self.plan.B_H,
                            self._swap())

    def _backward_b(self, y_halo):
        """(S, K_l, B_H) additive halo contributions -> (S, K_l, B_N)
        updates."""
        return backward_return(y_halo, self.send_idx, self.recv_pos,
                               self.plan.B_N, self._swap())

    # ---- reductions over ranks ----------------------------------------------
    def allreduce_sum(self, t):
        """The sum over ranks of a partial sum ``t`` (the same bits on every
        rank); ``t`` itself, with no launch, in one process. The solvers'
        ``reduce``."""
        if not self.layout.ranked:
            return t
        return D.sum_ranks(t)

    # ---- vector ops (flat (Kb,) / batched (S, Kb)) -------------------------
    def local_with_halo(self, x):
        """(S, Kb) -> (S, K_l, B_N + B_H) local [owned | halo] views."""
        plan = self.plan
        xk = x.reshape(x.shape[0], self.K_local, plan.B_N)
        return torch.cat([xk, self._forward_b(xk)], dim=2)

    def gather_elem(self, x):
        """(Kb,) -> (K_l*B_E, n) or (S, Kb) -> (S, K_l*B_E, n) element
        values."""
        squeeze = x.ndim == 1
        xb = x[None] if squeeze else x
        S = xb.shape[0]
        plan = self.plan
        xloc = self.local_with_halo(xb)                      # (S, K_l, L)
        idx = self.dofmap_local[None].expand(S, self.K_local,
                                             plan.B_E * self.n)
        xe = torch.gather(xloc, 2, idx).reshape(S, self.E_flat, self.n)
        return xe[0] if squeeze else xe

    def scatter_elem(self, re):
        """Per-element values (K_l*B_E, n) or (S, K_l*B_E, n) -> assembled
        flat vector(s) with halo contributions returned to their owners."""
        rb = re[None] if re.ndim == 2 else re
        S = rb.shape[0]
        plan = self.plan
        K, B_N, B_H = self.K_local, plan.B_N, plan.B_H
        rk = rb.reshape(S, K, plan.B_E * self.n)
        yloc = torch.zeros((S, K, B_N + B_H), dtype=rb.dtype,
                           device=rb.device)
        yloc.scatter_add_(2, self.dofmap_local[None].expand(S, K, -1), rk)
        y = yloc[:, :, :B_N] + self._backward_b(yloc[:, :, B_N:])
        y = y.reshape(S, self.Kb)
        return y[0] if re.ndim == 2 else y

    def spmv(self, A_el, x):
        """Matrix-free SpMV from flat element blocks: A_el (K_l*B_E, n, n)
        with x (Kb,), or (S, K_l*B_E, n, n) with (S, Kb)."""
        xe = self.gather_elem(x)
        if x.ndim == 1:
            return self.scatter_elem(torch.einsum("eij,ej->ei", A_el, xe))
        return self.scatter_elem(torch.einsum("seij,sej->sei", A_el, xe))

    def diagonal(self, A_el):
        """Assembled diagonal(s) from flat element blocks."""
        return self.scatter_elem(torch.diagonal(A_el, dim1=-2, dim2=-1))

    def make_constrained_operator(self, A_el, free):
        """y = A_c x with Dirichlet (and padding) slots acting as identity."""

        def op(x):
            y = self.spmv(A_el, torch.where(free, x, 0.0))
            return torch.where(free, y, x)

        return op


def build_dist_context(space, n_shards, device=None,
                       element_perm: np.ndarray | None = None) -> DistContext:
    """The owner-partitioned context of a FunctionSpace. ``n_shards``: a
    shard count K (all K shards a batch axis of this process, on
    ``device``, default the current CUDA device; raises without one), or a
    :class:`.distributed.RankLayout` from
    :func:`.distributed.global_device_mesh` (this rank's shards, on the
    layout's device). Elements are split in Morton order of their
    centroids unless ``element_perm`` is given. Every rank builds the
    global plan itself and keeps its rows on the device."""
    layout = D.as_layout(n_shards, device)
    K = layout.n_shards
    dofmap = np.asarray(space.dofmap)
    if element_perm is None:
        element_perm = locality_element_order(space.mesh)
    plan = build_halo_plan(dofmap, space.ndof, K, element_perm=element_perm)
    rows = layout.shards
    idx = lambda a: torch.as_tensor(np.asarray(a[rows], np.int64),
                                    device=layout.device)
    return DistContext(
        plan=plan, layout=layout, n=dofmap.shape[1],
        dofmap_local=idx(plan.dofmap_local.reshape(K, -1)),
        send_idx=idx(plan.send_idx), recv_pos=idx(plan.recv_pos),
        dofmap_global=dofmap)
