"""Find a cell's knee: the highest offered rate it sustains without a
growing backlog.

    python3 bench/sweep.py --workload <cell> --seconds <s> --rates 1 2 3

runs the cell once a rate (the mix's own lengths and seed 1, the reference
skipped) and prints a line a rate: requests due and answered by the
window's close, the mean wait from due to admission over the first and the
last quarter of the window's requests, TTFT's median and 90th percentile
and tokens a second. A backlog grows where the last quarter waits far
longer than the first and requests are still unanswered at the close.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--faults", default=None,
                    help="a fault schedule of bench/faults/ to run in "
                         "place of the cell's (none: without crashes)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness

    for rate in args.rates:
        out = harness.run_cell(args.workload, args.seed, args.seconds, False,
                               rate_rps=rate, check_outputs=False,
                               fault_schedule=None if args.faults is None
                               else harness.read_json(
                                   harness.BENCH / "faults"
                                   / f"{args.faults}.json"))
        run = out["_run"]
        recs = sorted(run.records, key=lambda r: r.t_due)
        q = len(recs) // 4
        wait = [(r.t_sub - r.t_due) if r.done else float("nan")
                for r in recs]
        ttft = [(r.t_first - r.t_due) * 1e3 for r in recs if r.done]
        print(json.dumps({
            "rate_rps": rate, "due": len(recs),
            "answered_by_close": sum(r.done and r.t_done <= run.t1
                                     for r in recs),
            "answered": sum(r.done for r in recs),
            "wait_first_quarter_ms": 1e3 * float(np.nanmean(wait[:q])),
            "wait_last_quarter_ms": 1e3 * float(np.nanmean(wait[-q:])),
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p90_ms": float(np.percentile(ttft, 90)),
            "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
