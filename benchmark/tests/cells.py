"""A throwaway cell at a tiny size, written into a temporary directory
beside links to the benchmark's own readers."""

from __future__ import annotations

import json
import os
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY = "tiny_pore.transient"


def write_tiny_cell(tmp: Path, nx: int = 30, ny: int = 17,
                    seg: int = 4) -> Path:
    """A copy of BENCHMARK.json with one cell, ``tiny_pore.transient``:
    the pore configuration on an ``nx`` x ``ny`` mesh under the transient
    traffic with ``seg``-step segments, the reference following all of
    them, held to ``pore_pnp.transient``'s limits. Returns the root to run
    it from."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((BENCH / "configs" / "pore_pnp.json").read_text())
    conf.update(name="tiny_pore", mesh={"generator": "pore_without_dna",
                                        "nx": nx, "ny": ny})
    traffic = json.loads((BENCH / "traffic" / "transient.json").read_text())
    traffic.update(segment_steps=seg, warmup_steps=min(seg, 4))
    data = tmp / "benchmark"
    for sub in ("configs", "traffic", "limits"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    os.symlink(BENCH / "metrics", data / "metrics")
    (data / "configs" / "tiny_pore.json").write_text(json.dumps(conf))
    (data / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    limits = json.loads(
        (BENCH / "limits" / "pore_pnp.transient.json").read_text())
    limits["reference_steps"] = seg
    (data / "limits" / f"{TINY}.json").write_text(json.dumps(limits))
    spec["configs"] = [{"name": "tiny_pore", "source": conf["source"],
                        "file": "benchmark/configs/tiny_pore.json",
                        "reduced": ["mesh"], "why": "a test's size"}]
    spec["workloads"] = [{"name": TINY, "config": "tiny_pore",
                          "traffic": "tiny", "chips": 1,
                          "why": "a test's size"}]
    for m in spec["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
