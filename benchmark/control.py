"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed, one short run of the cell whose comparison also runs
the control (the plain reference computed in TF32 in the program's place).

    python3 benchmark/control.py --workload usair_pos.fit --seconds 3 --seeds 101 102 103

One process reads every seed. Each seed prints one JSON line with the
program's numbers and the control's (``control_<name>``); with ``--fault``
the program's numbers with that fault of ``benchmark/faults.py`` planted
under the timed path. The benchmark's own runs never run either.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="", help="a fault of benchmark/faults.py to plant")
    args = ap.parse_args(argv)
    from benchmark import faults
    from benchmark.run import fixed_caches, run_cell

    fixed_caches(ROOT)
    if args.fault:
        getattr(faults, args.fault)(types.SimpleNamespace(setattr=setattr))
    for seed in args.seeds:
        result, checks = run_cell(args.workload, seed, args.seconds, False,
                                  control=not args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "correct": result["correct"],
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "readings": {c.name: c.value for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
