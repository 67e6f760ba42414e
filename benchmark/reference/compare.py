"""The numbers that decide ``correct``: the widest gap between what the
program produced and what the reference computed, relative to the
reference's largest magnitude.

* ``pb_err``: phase A's PB field.
* ``phi_err``, ``c_err``: the potential, and the worse of the two
  concentrations, after the compared steps of each segment.
* ``current_err``: each compared step's per-surface currents, for each
  species relative to that step's largest surface current.

Each is the worst over every segment the window completed.
"""

from __future__ import annotations

import numpy as np


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


def numbers(program: dict, ref: dict) -> dict:
    """``program``: {"pb", "segments": [{"state": (phi, c+, c-),
    "currents": [(step, I+, I-)]}]}; ``ref``: ``pnp.run``'s result."""
    segs = program["segments"]
    nan = float("nan")
    ref_cur = {i: (ip, im) for i, ip, im in ref["currents"]}
    out = {"pb_err": _rel(program["pb"], ref["pb"]),
           "phi_err": nan, "c_err": nan, "current_err": nan}
    if segs:
        out["phi_err"] = max(_rel(s["state"][0], ref["state"][0])
                             for s in segs)
        out["c_err"] = max(_rel(s["state"][k], ref["state"][k])
                           for s in segs for k in (1, 2))
        gaps = [_rel(c, r) for s in segs for i, ip, im in s["currents"]
                for c, r in zip((ip, im), ref_cur.get(
                    i, (np.full_like(ip, nan), np.full_like(im, nan))))]
        if len(gaps) == sum(2 * len(ref_cur) for _ in segs):
            out["current_err"] = max(gaps)
    return out
