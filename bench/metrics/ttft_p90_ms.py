"""Time to first token, 90th percentile over every request due in the
window, from when it was due (not when it was sent) to the first token of
the attempt that completed it; a resent request keeps its first due time.
A request that was never answered counts as answered when the drain ended."""

import numpy as np

from bench.harness import DRAIN_S


def read(run):
    if not run.records:
        return None
    end = run.t1 + DRAIN_S
    ttft = [((r.t_first if r.done else end) - r.t_due) * 1e3
            for r in run.records]
    return float(np.percentile(ttft, 90))
