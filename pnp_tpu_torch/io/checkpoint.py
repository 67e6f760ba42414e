"""Checkpoint / resume for instationary runs.

Numpy copy of ``pnp_tpu.io.checkpoint``: the config hash is the same, so
the two packages read each other's checkpoints.

The reference has no checkpointing at all (SURVEY.md section 5) — a crash
loses the run. Here: periodic npz snapshots of (phi, c+, c-, time, step)
keyed by a config hash so resume refuses to continue a different setup.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np

from ..config import Sysparams


def config_hash(sys: Sysparams) -> str:
    payload = json.dumps(dataclasses.asdict(sys), sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def save_checkpoint(path: str, sys: Sysparams, step: int, time: float,
                    phi, cp, cm) -> None:
    tmp = path + ".tmp"
    np.savez(tmp, config_hash=config_hash(sys), step=step, time=time,
             phi=np.asarray(phi), cp=np.asarray(cp), cm=np.asarray(cm))
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def load_checkpoint(path: str, sys: Sysparams) -> Optional[dict]:
    """Returns dict(step, time, phi, cp, cm) or None if absent/mismatched."""
    if not os.path.exists(path):
        return None
    data = np.load(path, allow_pickle=False)
    if str(data["config_hash"]) != config_hash(sys):
        raise ValueError(
            f"checkpoint {path} was written by a different config "
            f"({data['config_hash']} != {config_hash(sys)})")
    return {
        "step": int(data["step"]), "time": float(data["time"]),
        "phi": data["phi"], "cp": data["cp"], "cm": data["cm"],
    }
