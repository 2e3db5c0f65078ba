"""The failover plans of a run, recorded and held to the plain planner.

``PlanLog.install`` wraps the ``plan`` method of each planner the
program's controller holds. Each round then records what it was given, as
plain data read off the program's objects at the call (the applications to
place with their rungs, every server with its site, liveness, capacity and
the rungs it holds that are not cold, the primaries, alpha and whether a
backup must avoid its primary's site), and the plan it returned. Once the
run is over, ``mismatches`` plans every round again with
``bench/reference/planner.py``, the rungs' demands worked out from the
configuration's published sizes, and counts the rounds whose plan differs
in any application's rung or server, or in the applications left out.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np

from . import ladder
from .reference import planner as RP


def _round(req) -> Dict:
    cluster = req.cluster
    return {
        "apps": [{"id": a.id, "critical": bool(a.critical),
                  "rate": float(a.request_rate),
                  "variants": [v.name for v in a.variants]}
                 for a in req.apps],
        "servers": [{"id": s.id, "site": s.site, "alive": bool(s.alive),
                     "capacity": {r: float(s.capacity[r])
                                  for r in RP.RESOURCES},
                     "holds": [i.variant.name for i in s.instances.values()
                               if i.role != "cold"]}
                    for s in cluster.servers.values()],
        "primaries": dict(req.primaries),
        "alpha": float(req.alpha),
        "site_independence": bool(req.site_independence),
    }


class PlanLog:
    """Every planning round of the controller, with its plan."""

    def __init__(self):
        self.rounds: List[Dict] = []
        self._lock = threading.Lock()

    def install(self, controller) -> "PlanLog":
        for planner in {id(p): p for p in (controller.planner,
                                           controller.fast_planner)}.values():
            inner = planner.plan

            def plan(req, _inner=inner):
                rnd = _round(req)
                res = _inner(req)
                rnd["plan"] = {a: (v.name, sid)
                               for a, (v, sid) in res.assignment.items()}
                rnd["unplaced"] = sorted(res.unplaced)
                with self._lock:
                    self.rounds.append(rnd)
                return res
            planner.plan = plan
        return self

    def mismatches(self, model: Dict) -> int:
        """Rounds whose plan is not the plain planner's."""
        cache: Dict[str, np.ndarray] = {}

        def demand(name: str) -> np.ndarray:
            if name not in cache:
                cache[name] = np.array(ladder.demand(model,
                                                     ladder.tag_of(name)),
                                       np.float64)
            return cache[name]
        bad = 0
        for rnd in self.rounds:
            plan, unplaced = RP.plan(rnd, demand)
            if plan != rnd["plan"] or sorted(unplaced) != rnd["unplaced"]:
                bad += 1
        return bad
