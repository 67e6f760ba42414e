"""Multi-process runtime bring-up (port of ``pnp_tpu.parallel.distributed``).

The counterpart of the reference's MPI bootstrap (``Dune::MPIHelper`` at
src/dune_pnp.cc:13 and the rank-0 mesh broadcast at
src/pnp_solver_main.cc:86-100) on ``torch.distributed``: each process calls
:func:`initialize_distributed`, builds the mesh and the halo plan itself (a
deterministic build replaces the broadcast), and takes its rows of the
K-shard plan from :func:`global_device_mesh`. Rank p holds shards
``[p K_l, (p + 1) K_l)``, ``K_l = K / P``, as its own batch axis; the halo
exchange is one ``all_to_all_single`` an exchange and every Krylov dot one
collective (:class:`..parallel.dist.DistContext`).

Backends: ``"gloo"`` for the CPU and for several ranks on one card (NCCL
refuses two ranks on one GPU), ``"nccl"`` for one rank per card. The
backend is the caller's choice; it is never switched on the caller's
behalf.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

#: a rank that dies or takes another branch fails the others' collectives
#: after this long (NCCL's own default is 10 minutes)
TIMEOUT_S = 120


def _own_card_each(num_processes: int) -> bool:
    """True where every rank on this host can hold a CUDA device of its own."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return torch.cuda.is_available() and local <= torch.cuda.device_count()


def resolve_backend(backend: Optional[str], num_processes: int) -> str:
    """``backend`` itself, or for ``None`` ``"nccl"`` where each rank has a
    card of its own; otherwise a ``ValueError`` naming ``"gloo"``."""
    if backend is not None:
        if backend not in ("gloo", "nccl"):
            raise ValueError(
                f"backend must be 'gloo' or 'nccl', not {backend!r}")
        return backend
    if _own_card_each(num_processes):
        return "nccl"
    raise ValueError(
        f"{num_processes} ranks on {torch.cuda.device_count()} CUDA "
        "device(s): NCCL needs a card a rank; pass backend='gloo' for the "
        "CPU or for several ranks on one card")


def start_process_group(coordinator_address: str, num_processes: int,
                        process_id: int, backend: str) -> None:
    """Join (or open) the process group at ``host:port``, with no rule
    about its size: :func:`initialize_distributed` starts nothing for one
    process, as the reference does, while a one-rank group still drives
    the rank path through the backend's collectives (each a copy)."""
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Start ``torch.distributed`` from the arguments or torchrun's
    variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    Returns True if a multi-process group was started; False without an
    address or for one process. ``backend``: see :func:`resolve_backend`."""
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    if addr is None:
        return False
    n = (num_processes if num_processes is not None
         else int(os.environ.get("WORLD_SIZE", "1")))
    pid = (process_id if process_id is not None
           else int(os.environ.get("RANK", "0")))
    if n <= 1:
        return False
    start_process_group(addr, n, pid, resolve_backend(backend, n))
    return True


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """This process's part of a K-shard plan: P ranks, each holding
    ``K_local = K / P`` consecutive shards on ``device``. ``backend`` is
    None without a process group: then the K shards are one batch axis
    and no collective runs (the single-process driver)."""

    n_shards: int
    world_size: int
    rank: int
    device: torch.device
    backend: Optional[str]

    @property
    def K_local(self) -> int:
        return self.n_shards // self.world_size

    @property
    def shards(self) -> slice:
        """This rank's rows of the plan's (K, ...) tables."""
        return slice(self.rank * self.K_local, (self.rank + 1) * self.K_local)

    @property
    def ranked(self) -> bool:
        """True where the shards are spread over the ranks of a process
        group (any size, one included)."""
        return self.backend is not None


def single_process_layout(n_shards: int, device) -> RankLayout:
    """All K shards as one batch axis of this process, no collectives."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be at least 1, not {n_shards}")
    return RankLayout(int(n_shards), 1, 0, resolve_device(device), None)


def as_layout(n_shards, device=None) -> RankLayout:
    """``n_shards`` as a layout: a :class:`RankLayout` as it is (it names
    its device; a ``device`` that differs raises), a shard count as one
    process's batch axis on ``device``."""
    if not isinstance(n_shards, RankLayout):
        return single_process_layout(n_shards, device)
    if device is not None and torch.device(device) != n_shards.device:
        raise ValueError(f"device {device} differs from the layout's "
                         f"{n_shards.device}")
    return n_shards


def global_device_mesh(n_shards: int, device=None) -> RankLayout:
    """The layout of ``n_shards`` shards over the process group (the
    counterpart of the reference's 1-D mesh over every device of the job):
    world size P, this rank, ``K_l = K / P``, the device
    (default ``cuda:(LOCAL_RANK % device_count)``; raises without CUDA)
    and the backend. Without a process group: one rank, no backend. A P
    that does not divide K raises."""
    if not dist.is_initialized():
        return single_process_layout(n_shards, device)
    P, rank = dist.get_world_size(), dist.get_rank()
    if n_shards < 1 or n_shards % P:
        raise ValueError(f"{P} ranks do not divide {n_shards} shards")
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)                    # raises, naming the CPU
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return RankLayout(int(n_shards), P, rank, torch.device(device),
                      dist.get_backend())


def is_coordinator() -> bool:
    """Rank 0, or the only process: the one that writes outputs."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---- the collectives of the rank path ---------------------------------------
# Tensors go to the backend where they lie: NCCL takes CUDA tensors, gloo
# stages a CUDA tensor through the host itself.

def swap_shard_axes(buf, layout: RankLayout):
    """The halo exchange's one collective: (S, K_l, K, H) packed buffers,
    row [s, a, t] for this rank's shard a and any shard t, -> (S, K_l, K,
    H) with row [s, b, u] the buffer that shard u sent this rank's shard
    b. The rows go out rank-major as (P, S, K_l, K_l, H) in one
    ``all_to_all_single``; what arrives is (P_src, S, K_l, K_l, H)."""
    S, Kl, K, H = buf.shape
    P = layout.world_size
    send = buf.reshape(S, Kl, P, Kl, H).permute(2, 0, 1, 3, 4)
    recv = all_to_all(send.contiguous())
    return recv.permute(1, 3, 0, 2, 4).reshape(S, Kl, K, H)


def all_to_all(send):
    """(P, ...) -> (P, ...): row p goes to rank p; row p of the result came
    from rank p."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    return recv


def gather_ranks(t) -> list:
    """Every rank's ``t`` (equal shapes), in rank order, on every rank."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return parts


def sum_ranks(t):
    """The sum of every rank's ``t``, added in rank order, so every rank
    holds the same bits (an all-reduce may add in another order on each
    rank, and a branch on its result could then part the ranks)."""
    parts = gather_ranks(t)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def barrier(layout: RankLayout) -> None:
    """Wait for every rank (nothing without a process group)."""
    if not layout.ranked:
        return
    if layout.backend == "nccl":
        dist.barrier(device_ids=[layout.device.index])
    else:
        dist.barrier()
