"""The knee of an open-loop cell: latency at a ladder of fixed rates.

    python3 benchmark/sweep.py --workload serve-ffhq512 --rates 60,80,100 --seconds 15 --seed 5

One process sets the cell up once and offers each rate in turn for
`--seconds`. Per rate it prints the p50 and p95 (missing requests counted
as in the cell), the requests missing, and the backlog's growth: the median
latency of the last quarter of requests (by due time) over the first
quarter's. The highest rate with nothing missing and a growth under 2 is
the knee; a cell's rate is set at about four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    cell = harness.load_cell(args.workload)
    cell.seed, cell.device = args.seed, "cuda"
    cell.traffic = dict(cell.traffic)
    device = harness.card(cell.chips)
    drv = harness.driver(cell.traffic["kind"]).Driver(cell, lambda m: print(m, file=sys.stderr))
    drv.setup()
    for rate in (float(r) for r in args.rates.split(",")):
        drv.t["rate_per_s"] = rate
        p95 = drv.window(args.seconds)["latency_p95_ms"]
        lat = drv.latencies
        q = max(1, len(lat) // 4)
        head = [x for _, x in lat[:q] if x is not None]
        tail = [x for _, x in lat[-q:] if x is not None]
        growth = (statistics.median(tail) / statistics.median(head)) if head and tail else None
        served = [x for _, x in lat if x is not None]
        print(json.dumps({"workload": args.workload, "rate_per_s": rate,
                          "p50_ms": 1e3 * statistics.median(served) if served else None,
                          "p95_ms": p95, "missing": drv.failed, "requests": drv.attempted,
                          "growth": growth, "batch_mean": drv.counters.get("batch_mean"),
                          "card": device["kind"]}), flush=True)
    drv.release()


if __name__ == "__main__":
    main()
