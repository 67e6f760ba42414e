"""The control of the check that decides ``correct``: the plain reference
put in the program's place and computed in float32, a precision below the
float64 the configuration states. Its numbers have to fail the cell's
limits; the benchmark's own runs never run it.

    python3 benchmark/control.py --workload CELL --seeds 11,12,13

prints one JSON line a seed, with each compared number of the control
beside the cell's limit, at the cell's own size and steps, on the card
(the CPU with ``--device cpu``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import meshgen  # noqa: E402
from benchmark.harness import Cell  # noqa: E402
from benchmark.reference import compare, pnp as reference  # noqa: E402


def control_numbers(mesh, system, surfaces, n_steps, device) -> dict:
    """The compared numbers of the float32 reference against the float64
    one, both over ``n_steps`` steps."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = reference.run(mesh, system, surfaces, n_steps,
                            dtype=torch.float64, device=device)
        low = reference.run(mesh, system, surfaces, n_steps,
                            dtype=torch.float32, device=device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    program = {"pb": low["pb"], "segments": [{"state": low["state"],
                                              "currents": low["currents"]}]}
    return compare.numbers(program, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = Cell.load(ROOT, args.workload)
    mesh = meshgen.build(cell.config["mesh"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        bias = cell.bias(seed)
        nums = control_numbers(mesh, cell.system(), cell.surfaces(bias),
                               int(cell.limits["reference_steps"]),
                               args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "bias": bias, "seconds": time.perf_counter() - t0,
                          "control": {k: {"value": v, "limit":
                                          cell.limits["limits"][k]}
                                      for k, v in nums.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
