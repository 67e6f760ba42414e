"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``. ``None`` means the card: the
    current CUDA device, and a ``RuntimeError`` where there is none (an
    entry point never falls back to the CPU on its own; pass
    ``device="cpu"`` to run there)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the entry points of pnp_tpu_torch run on the "
            "GPU by default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
