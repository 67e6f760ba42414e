"""Field comparison / golden-regression utilities (port of
``pnp_tpu.validation``).

The accuracy metric is the relative L2 of (phi, c+, c-) between runs (the
port against the reference, or a run against a golden snapshot). The L2
norm here is the true function-space norm through the mass matrix, not a
plain dof-vector norm, so it is meaningful across meshes with nonuniform
element sizes. Host-side: the tables are built on the CPU.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .fem.space import FunctionSpace
from .fem.geometry import build_volume_tables, f64
from .operators.volume import mass_matrix


def _host(u) -> np.ndarray:
    if isinstance(u, torch.Tensor):
        return u.detach().cpu().numpy()
    return np.asarray(u)


def l2_norm(space: FunctionSpace, u, quad_order: int = None) -> float:
    """True L2(Omega) norm of the FE function with dof vector u."""
    q = quad_order if quad_order is not None else 2 * space.degree + 1
    vt = build_volume_tables(space, q, "cpu")
    M = mass_matrix(vt, vt.qw)
    ue = f64(_host(u), "cpu")[vt.dofmap]
    return float(torch.sqrt(torch.einsum("ei,eij,ej->", ue, M, ue)))


def relative_l2(space: FunctionSpace, u, v, quad_order: int = None) -> float:
    """|| u - v ||_L2 / || v ||_L2."""
    diff = _host(u) - _host(v)
    denom = l2_norm(space, v, quad_order)
    return l2_norm(space, diff, quad_order) / max(denom, 1e-300)


def save_golden(path: str, **fields) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: _host(v) for k, v in fields.items()})


def check_golden(path: str, space: FunctionSpace, tol: float,
                 **fields) -> Dict[str, float]:
    """Compare fields against a golden snapshot; returns per-field rel-L2.
    Raises AssertionError listing any field beyond ``tol``."""
    data = np.load(path)
    errs = {}
    for name, val in fields.items():
        errs[name] = relative_l2(space, val, data[name])
    bad = {k: v for k, v in errs.items() if v > tol}
    assert not bad, f"golden mismatch vs {path}: {bad} (tol {tol})"
    return errs
