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

The K shards are a leading batch axis of tensors on one device. Not
ported: the reference's sharding placement (``put_sharded``,
``put_global``, ``_pin``) and its multi-process table mode
(``host_tables``, ``process_allgather``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..utils.device import resolve_device
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


@dataclasses.dataclass
class DistContext:
    """Owner-partitioned distribution context on one device.

    Every vector op takes flat ``(Kb,)`` vectors or batched ``(S, Kb)``
    stacks, ``Kb = K * B_N``."""

    plan: HaloPlan
    device: Any
    n: int                      # dofs per element
    dofmap_local: Any           # (K, B_E * n) int64
    send_idx: Any               # (K, K, H) int64
    recv_pos: Any               # (K, K, H) int64
    dofmap_global: np.ndarray | None = None   # (E, n) host copy
    _env_maps: tuple | None = None

    @property
    def K(self):
        return self.plan.K

    @property
    def Kb(self):
        return self.plan.K * self.plan.B_N

    @property
    def E_flat(self):
        return self.plan.K * self.plan.B_E

    # ---- host-side partition helpers --------------------------------------
    def partition(self, x: np.ndarray) -> np.ndarray:
        """Global (ndof,) -> flat (Kb,) numpy (padded slots zero)."""
        plan = self.plan
        out = np.zeros((plan.K, plan.B_N), dtype=np.asarray(x).dtype)
        m = plan.owned_global >= 0
        out[m] = np.asarray(x)[plan.owned_global[m]]
        return out.reshape(-1)

    def unpartition(self, xp) -> np.ndarray:
        plan = self.plan
        xp = np.asarray(xp).reshape(plan.K, plan.B_N)
        out = np.zeros(plan.ndof, dtype=xp.dtype)
        m = plan.owned_global >= 0
        out[plan.owned_global[m]] = xp[m]
        return out

    def to_host_global(self, v) -> np.ndarray:
        """(Kb,) / (S, Kb) tensor -> global numpy (ndof,) / (S, ndof)."""
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        if v.ndim == 1:
            return self.unpartition(v)
        return np.stack([self.unpartition(row) for row in v])

    def partition_elem(self, arr: np.ndarray) -> np.ndarray:
        """Element array (E, ...) -> flat (K*B_E, ...) per the plan."""
        out = partition_element_array(self.plan, np.asarray(arr))
        return out.reshape((-1,) + out.shape[2:])

    def pad_mask_flat(self) -> np.ndarray:
        """(Kb,) bool — True on REAL owned slots, False on padding."""
        return (self.plan.owned_global >= 0).reshape(-1)

    def env_maps(self):
        """(env_ids (K, B_E2), env_dofmap (K, B_E2, n)) host numpy arrays
        (see :func:`_build_env_maps`), built at first use."""
        if self._env_maps is None:
            if self.dofmap_global is None:
                raise ValueError("DistContext built without the global dofmap")
            self._env_maps = _build_env_maps(self.plan, self.dofmap_global)
        return self._env_maps

    # ---- the exchange (batched: x is (S, K, B_N)) ---------------------------
    def _forward_b(self, x):
        """(S, K, B_N) -> (S, K, B_H) halo values fetched from owners."""
        return forward_halo(x, self.send_idx, self.recv_pos, self.plan.B_H)

    def _backward_b(self, y_halo):
        """(S, K, B_H) additive halo contributions -> (S, K, B_N) updates."""
        return backward_return(y_halo, self.send_idx, self.recv_pos,
                               self.plan.B_N)

    # ---- vector ops (flat (Kb,) / batched (S, Kb)) -------------------------
    def local_with_halo(self, x):
        """(S, Kb) -> (S, K, B_N + B_H) local [owned | halo] views."""
        plan = self.plan
        xk = x.reshape(x.shape[0], plan.K, plan.B_N)
        return torch.cat([xk, self._forward_b(xk)], dim=2)

    def gather_elem(self, x):
        """(Kb,) -> (K*B_E, n) or (S, Kb) -> (S, K*B_E, n) element values."""
        squeeze = x.ndim == 1
        xb = x[None] if squeeze else x
        S = xb.shape[0]
        plan = self.plan
        xloc = self.local_with_halo(xb)                      # (S, K, L)
        idx = self.dofmap_local[None].expand(S, plan.K, plan.B_E * self.n)
        xe = torch.gather(xloc, 2, idx).reshape(S, plan.K * plan.B_E, self.n)
        return xe[0] if squeeze else xe

    def scatter_elem(self, re):
        """Per-element values (K*B_E, n) or (S, K*B_E, n) -> assembled flat
        vector(s) with halo contributions returned to their owners."""
        rb = re[None] if re.ndim == 2 else re
        S = rb.shape[0]
        plan = self.plan
        K, B_N, B_H = plan.K, plan.B_N, plan.B_H
        rk = rb.reshape(S, K, plan.B_E * self.n)
        yloc = torch.zeros((S, K, B_N + B_H), dtype=rb.dtype,
                           device=rb.device)
        yloc.scatter_add_(2, self.dofmap_local[None].expand(S, K, -1), rk)
        y = yloc[:, :, :B_N] + self._backward_b(yloc[:, :, B_N:])
        y = y.reshape(S, self.Kb)
        return y[0] if re.ndim == 2 else y

    def spmv(self, A_el, x):
        """Matrix-free SpMV from flat element blocks: A_el (K*B_E, n, n)
        with x (Kb,), or (S, K*B_E, n, n) with (S, Kb)."""
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


def build_dist_context(space, n_shards: int, device=None,
                       element_perm: np.ndarray | None = None) -> DistContext:
    """The owner-partitioned context of a FunctionSpace over ``n_shards``
    shards (K), on ``device`` (default: the current CUDA device; raises
    without one). Elements are split in Morton order of their centroids
    unless ``element_perm`` is given."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be at least 1, not {n_shards}")
    device = resolve_device(device)
    K = int(n_shards)
    dofmap = np.asarray(space.dofmap)
    if element_perm is None:
        element_perm = locality_element_order(space.mesh)
    plan = build_halo_plan(dofmap, space.ndof, K, element_perm=element_perm)
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return DistContext(
        plan=plan, device=device, n=dofmap.shape[1],
        dofmap_local=idx(plan.dofmap_local.reshape(K, -1)),
        send_idx=idx(plan.send_idx), recv_pos=idx(plan.recv_pos),
        dofmap_global=dofmap)
