"""The numbers that decide ``correct``, read for the limits.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \
        [--units 2] [--control N] [--explore]

For each seed, in one process: the cell's set-up and ``--units`` timed
units, then the numbers the check compares, for the program and, on the
first N seeds with ``--control N``, for each control (the precision below
the one the configuration states, in the program's place); ``--explore``
adds the numbers read while the limits were set.  One JSON line a seed on
standard output.  The limits in ``benchmark/limits/<workload>.json`` are
set from these readings (see PERF.md).  Needs the card.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.core import spec as spec_mod  # noqa: E402


def read_seed(cell, seed: int, units: int, control: bool, device,
              explore: bool = False) -> dict:
    Loop = spec_mod.loop_class(cell.mix["kind"])
    t0 = time.perf_counter()
    loop = Loop(cell.config, cell.mix, seed, device)
    loop.warm()
    loop.sync()
    t1 = time.perf_counter()
    done = [loop.unit() for _ in range(units)]
    loop.sync()
    t2 = time.perf_counter()
    out = {"seed": seed, "setup_s": t1 - t0, "units_s": t2 - t1,
           "units": [{k: v for k, v in u.items() if k != "match_calls"}
                     for u in done]}
    loop.free()
    out["program"] = loop.readings(explore=explore)
    t3 = time.perf_counter()
    out["check_s"] = t3 - t2
    if control:
        out["controls"] = loop.controls(explore=explore)
        out["control_s"] = time.perf_counter() - t3
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--units", type=int, default=2)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--explore", action="store_true")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec_mod.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for n, s in enumerate(args.seeds.split(",")):
        print(json.dumps(read_seed(cell, int(s), args.units,
                                   n < args.control, device, args.explore)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
