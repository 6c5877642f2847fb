"""The highest rate a scoring cell sustains, found by a sweep on the card:
one set-up, then an open-loop window at each rate, in one process.

    python3 benchmark/sweep.py --workload blogcatalog_pos.score --seed 5 --seconds 30 --rates 6 8 10 12

Each rate prints one JSON line: requests, links, p50 and p95 latency, and
the mean latency of the first and last thirds of the requests (a backlog that grows makes the last third's much
larger). A cell's ``rate_per_s`` is set at about four fifths of the highest
rate that holds its backlog.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from benchmark import spec
    from benchmark.kinds import score
    from benchmark.run import fixed_caches

    fixed_caches(ROOT)
    cell = spec.load_cell(args.workload, ROOT)
    run = score.Run(cell.config, dict(cell.traffic), cell.limits, args.seed,
                    torch.device("cuda", 0))
    run.setup()
    for rate in args.rates:
        run.gaps = score.block_gaps(rate, cell.traffic["size_block"])
        run.done, run.i = [], 0
        run.schedule = np.random.default_rng(cell.traffic["schedule_seed"])
        got = run.window(args.seconds)
        lat = np.array([d[2] for d in run.done])
        served = np.array([len(d[0]) for d in run.done])
        third = max(len(lat) // 3, 1)
        print(json.dumps({"rate_per_s": rate, "requests": len(lat), "links": int(served.sum()),
                          "p50_ms": float(np.percentile(lat, 50) * 1e3),
                          "p95_ms": got["score_ms_p95"], "window_s": got["window_s"],
                          "first_third_mean_ms": float(lat[:third].mean() * 1e3),
                          "last_third_mean_ms": float(lat[-third:].mean() * 1e3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
