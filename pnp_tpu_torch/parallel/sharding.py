"""Element sharding: element tables split over K shards, dof vectors
replicated (port of ``pnp_tpu.parallel.sharding``).

The reference's second multi-device layout, DUNE's NOVLP "additive
vector, consistent matrix": mesh-element tables (dof maps, geometry,
element matrices) are split over the shards while every dof vector stays
whole on each of them.

  * assembly / SpMV: each shard gathers from its whole vector, evaluates
    its element batch and scatter-adds into a full-length partial vector;
    the partials are summed, over the shard axis in one process and then
    by one ``all_reduce(SUM)`` over the ranks of a process group. In the
    reference GSPMD inserted that psum; here the sharded tables carry it:
    their dof map is a :class:`ShardedDofmap`, and the scatters of
    :mod:`..fem.assembly` sum its partials (the one reduction point).
  * Krylov dot products are local on the replicated vectors (already
    summed): they need no collective.

Elements are padded to a multiple of the shard count with zero-weight
(qw = 0, gradphi = 0, qy = 0) dummy elements mapping to dof 0, so every
shard holds the same number of elements and the padded contributions are
exactly zero.

The shards are laid out by a :class:`.distributed.RankLayout`
(:func:`make_device_mesh`): K shards as a leading axis of one device
without a process group, or K / P of them on each of P ranks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..fem.geometry import VolumeTables
from .distributed import RankLayout, global_device_mesh


def make_device_mesh(n_shards: Optional[int] = None, device=None
                     ) -> RankLayout:
    """K element shards over the process group (one shard a rank for
    ``None``; without a group, one): a leading shard axis on ``device``
    in one process, K / P shards a rank under P ranks (a P that does not
    divide K raises)."""
    if n_shards is None:
        n_shards = dist.get_world_size() if dist.is_initialized() else 1
    return global_device_mesh(int(n_shards), device)


def replicate(mesh: RankLayout, x) -> torch.Tensor:
    """``x`` whole on the mesh's device; under ranks, rank 0's bits on
    every rank (a vector built with atomic scatters differs in its last
    bits from rank to rank, and the ranks' Krylov branches would part)."""
    t = torch.as_tensor(x, device=mesh.device)
    if mesh.ranked:
        t = t.clone()
        dist.broadcast(t, 0)
    return t


def _pad_amount(E: int, n: int) -> int:
    return (-E) % n


def pad_elements(arr, E_pad: int, fill=0) -> np.ndarray:
    """Pad axis 0 (elements) to E_pad with ``fill``."""
    arr = np.asarray(arr)
    E = arr.shape[0]
    if E == E_pad:
        return arr
    pad_width = [(0, E_pad - E)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill)


class ShardedDofmap(torch.Tensor):
    """The (K_l * E_s, n) dof map of this rank's K_l element shards, E_s
    elements each, carrying its :class:`RankLayout` (``mesh``). Every op
    on it returns a plain tensor (gathers ``u[dofmap]`` included); only
    the scatters of :mod:`..fem.assembly` read ``mesh`` and call
    :meth:`scatter`, and the AMG coarse matrix built from these shards'
    blocks (:mod:`..solvers.amg`) calls :meth:`all_reduce`."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def __new__(cls, dofmap, mesh: RankLayout):
        t = torch.Tensor._make_subclass(cls, dofmap)
        t.mesh = mesh
        t._index = {}
        return t

    def scatter(self, values, ndof: int):
        """Per-element values (..., K_l * E_s, n) -> the (..., ndof) sum:
        each shard's partial (..., K_l, ndof), summed over the shard axis
        and then over the ranks."""
        lead = values.shape[:-2]
        S = int(np.prod(lead, dtype=np.int64))
        K_l = self.mesh.K_local
        idx = self._index.get(ndof)
        if idx is None:
            shard = torch.arange(K_l, device=self.device).repeat_interleave(
                self.shape[0] // K_l)
            idx = (self.as_subclass(torch.Tensor)
                   + ndof * shard[:, None]).reshape(-1)
            self._index[ndof] = idx
        part = torch.zeros((S, K_l * ndof), dtype=values.dtype,
                           device=values.device)
        part.index_add_(1, idx, values.reshape(S, -1))
        out = self.all_reduce(part.view(S, K_l, ndof).sum(dim=1))
        return out.reshape(*lead, ndof)

    def all_reduce(self, t):
        """``t``, a sum over this rank's shards, summed over the ranks in
        place (in one process the rank holds every shard: ``t`` as it
        is)."""
        if self.mesh.ranked:
            dist.all_reduce(t)
        return t


def shard_volume_tables(vt: VolumeTables, mesh: RankLayout) -> VolumeTables:
    """Pad + place volume tables: this rank's element shards (all K in one
    process), the shape table replicated. Padding uses qw = 0 (and zero
    gradients and radii) so padded elements contribute exactly zero to any
    residual/Jacobian, and dofmap = 0 so their scatters are in bounds."""
    n = mesh.n_shards
    E = vt.dofmap.shape[0]
    E_pad = E + _pad_amount(E, n)
    E_s = E_pad // n
    rows = slice(mesh.shards.start * E_s, mesh.shards.stop * E_s)
    dev = mesh.device

    def part(a):
        host = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        return torch.as_tensor(np.ascontiguousarray(
            pad_elements(host, E_pad)[rows]), device=dev)

    return VolumeTables(
        shape=torch.as_tensor(vt.shape, device=dev),
        gradphi=part(vt.gradphi), qw=part(vt.qw), qy=part(vt.qy),
        dofmap=ShardedDofmap(part(vt.dofmap).to(torch.int64), mesh))
