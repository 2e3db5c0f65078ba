"""Plain greedy failover planner: the paper's Algorithm 1 in numpy.

One round in, one plan out. A round (``bench/plans.py`` records one each
time the program's controller plans) gives the applications to place, each
with its rungs largest first, whether it is critical and its request rate;
every server in cluster order with its site, liveness, capacity and the
rungs it holds; the applications' primaries; whether a backup must avoid
its primary's whole site; and the share of spare capacity (alpha) kept for
progressive failover. The rungs' demands are worked out again from the
configuration's published sizes (``bench/ladder.py``).

The rule, step by step:

1. free capacity of each server: its capacity less the demand of each rung
   it holds that is not cold, subtracted in the order they were placed;
2. order: critical applications first, then by falling request rate (a
   stable sort of the round's order);
3. delta = the least, over the resources, of the live servers' free total
   over the applications' full-size demand total; the budget = (1 - alpha)
   x the free total;
4. each application starts at its first rung whose demand fits delta x its
   full-size demand on every resource (every rung when delta >= 1; else its
   smallest);
5. from there, rung by rung, the first rung that the budget holds and some
   live server not excluded can hold goes to the server of most normalized
   headroom (min over resources of free / capacity), the first such server
   on ties; its demand leaves that server and the budget;
6. then, in the same order, each placed application moves up to its
   largest rung that its server and the budget can still hold.

All comparisons allow 1e-9. Sums run left to right, as a plan's numbers are
exact only if both sides add in the same order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

EPS = 1e-9
RESOURCES = ("mem", "compute")


def _sum(values) -> float:
    total = 0.0
    for v in values:
        total += float(v)
    return total


def plan(rnd: Dict, demand) -> Tuple[Dict[str, Tuple[str, str]], List[str]]:
    """``rnd``: a recorded round (see ``bench/plans.py``); ``demand(name)``:
    a rung's demand vector in ``RESOURCES`` order. Returns the assignment
    (application -> (rung, server)) and the applications left unplaced."""
    apps = rnd["apps"]
    servers = rnd["servers"]
    R = len(RESOURCES)
    ids = [s["id"] for s in servers]
    cap = np.array([[s["capacity"][r] for r in RESOURCES] for s in servers],
                   np.float64).reshape(len(servers), R)
    free = cap.copy()
    for i, s in enumerate(servers):
        used = np.zeros(R, np.float64)
        for name in s["holds"]:
            used += demand(name)
        free[i] -= used
    live = [i for i, s in enumerate(servers) if s["alive"]]
    order = sorted(apps, key=lambda a: (not a["critical"], -a["rate"]))
    if not apps or not live:
        return {}, [a["id"] for a in order]
    ids = [ids[i] for i in live]
    free, cap = free[live], cap[live]
    pos = {sid: k for k, sid in enumerate(ids)}

    dem = {a["id"]: np.array([demand(v) for v in a["variants"]], np.float64)
           for a in apps}
    C = [_sum(free[:, j]) for j in range(R)]
    D = [_sum(dem[a["id"]][0, j] for a in apps) for j in range(R)]
    delta = min((C[j] / D[j]) if D[j] > 0 else 1.0 for j in range(R))
    budget = np.array([(1.0 - rnd["alpha"]) * c for c in C], np.float64)

    site_of = {s["id"]: s["site"] for s in servers}
    excluded: Dict[str, np.ndarray] = {}
    for a in apps:
        mask = np.zeros(len(ids), bool)
        p = rnd["primaries"].get(a["id"])
        if p in pos:
            mask[pos[p]] = True
        if rnd["site_independence"] and p:
            for sid in ids:
                if site_of[sid] == site_of[p]:
                    mask[pos[sid]] = True
        excluded[a["id"]] = mask

    def start_of(a):
        d = dem[a["id"]]
        if delta >= 1.0:
            return 0
        for j in range(len(d)):
            if all(d[j, r] <= delta * d[0, r] + EPS for r in range(R)):
                return j
        return len(d) - 1

    head = (free / cap).min(axis=1)
    chosen: Dict[str, Tuple[int, int]] = {}
    unplaced: List[str] = []
    for a in order:
        d_app = dem[a["id"]]
        for j in range(start_of(a), len(d_app)):
            d = d_app[j]
            if not (budget >= d - EPS).all():
                continue
            ok = (free >= d - EPS).all(axis=1) & ~excluded[a["id"]]
            if not ok.any():
                continue
            k = int(np.argmax(np.where(ok, head, -np.inf)))
            free[k] -= d
            budget -= d
            head[k] = (free[k] / cap[k]).min()
            chosen[a["id"]] = (j, k)
            break
        else:
            unplaced.append(a["id"])

    for a in order:
        if a["id"] not in chosen:
            continue
        j, k = chosen[a["id"]]
        d_app = dem[a["id"]]
        for up in range(j):
            extra = d_app[up] - d_app[j]
            if (free[k] >= extra - EPS).all() and \
                    (budget >= extra - EPS).all():
                free[k] += d_app[j]
                budget += d_app[j]
                free[k] -= d_app[up]
                budget -= d_app[up]
                head[k] = (free[k] / cap[k]).min()
                chosen[a["id"]] = (up, k)
                break

    names = {a["id"]: a["variants"] for a in apps}
    return ({app: (names[app][j], ids[k]) for app, (j, k) in chosen.items()},
            unplaced)
