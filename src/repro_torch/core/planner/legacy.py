"""Algorithm 1, reference implementation — the original pure-Python
triple loop (O(N·V·S) dict arithmetic).

Kept verbatim as the behavioral oracle: `tests/test_planner.py` asserts
the vectorized planner (planner/vectorized.py) produces identical
assignments and Eq. 1 objective on seeded random instances, and
`tools/bench_planner.py` measures the old-vs-new speedup. New code
should use the vectorized `faillite_heuristic` instead.

    δ = available_capacity / max_demand        (per resource, take min)
    X[i] = match(n_i, δ)                       variant sized ≈ δ × full
    for each app: worst-fit place X[i], degrading to smaller variants
    upgrade_model(): grow placed variants where headroom remains
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set

from repro_torch.core.cluster import Cluster, RESOURCES, Server
from repro_torch.core.planner.base import HeuristicResult, eq1_objective
from repro_torch.core.variants import Application, Variant


class _FreeView:
    """Tentative free-capacity accounting over alive servers.

    Deprecated: use `PlannerState.scratch()` (planner/state.py) — kept
    only so the legacy oracle stays byte-for-byte the old algorithm.
    """

    def __init__(self, servers: List[Server], reserve_frac: float = 0.0):
        self.cap = {s.id: dict(s.capacity) for s in servers}
        self.free = {s.id: {r: s.free(r) for r in RESOURCES}
                     for s in servers}
        self.servers = {s.id: s for s in servers}
        # α-reserve: hold back a fraction of the *total* free capacity
        self.budget = {r: (1.0 - reserve_frac) *
                       sum(f[r] for f in self.free.values())
                       for r in RESOURCES}

    def fits(self, sid: str, demand: Dict[str, float]) -> bool:
        return (all(self.free[sid][r] >= demand[r] - 1e-9 for r in RESOURCES)
                and all(self.budget[r] >= demand[r] - 1e-9
                        for r in RESOURCES))

    def take(self, sid: str, demand: Dict[str, float]):
        for r in RESOURCES:
            self.free[sid][r] -= demand[r]
            self.budget[r] -= demand[r]

    def give(self, sid: str, demand: Dict[str, float]):
        for r in RESOURCES:
            self.free[sid][r] += demand[r]
            self.budget[r] += demand[r]

    def headroom(self, sid: str) -> float:
        return min(self.free[sid][r] / self.cap[sid][r] for r in RESOURCES)


def match(variants: List[Variant], delta: float) -> int:
    """Index of the variant whose demand ≈ δ × full demand (Line 6)."""
    if delta >= 1.0:
        return 0
    full = variants[0]
    for j, v in enumerate(variants):
        if all(v.demand[r] <= delta * full.demand[r] + 1e-9
               for r in RESOURCES):
            return j
    return len(variants) - 1


def worst_fit(view: _FreeView, demand: Dict[str, float],
              excluded: Set[str], app=None, variant=None,
              latency_fn=None, slo=float("inf")) -> Optional[str]:
    """Most-headroom alive server that fits demand + SLO (Line 9)."""
    best, best_h = None, -1.0
    for sid, srv in view.servers.items():
        if sid in excluded:
            continue
        if latency_fn is not None and app is not None and \
                latency_fn(app, variant, srv) > slo:
            continue
        if not view.fits(sid, demand):
            continue
        h = view.headroom(sid)
        if h > best_h:
            best, best_h = sid, h
    return best


def faillite_heuristic_legacy(apps: List[Application], cluster: Cluster, *,
                              exclude: Optional[Dict[str, Set[str]]] = None,
                              site_exclude: Optional[Dict[str, Set[str]]]
                              = None,
                              alpha: float = 0.0,
                              latency_fn=None) -> HeuristicResult:
    """Algorithm 1 (loop oracle). `exclude[app]` = servers the app may
    not use (its primary, Eq. 4); `site_exclude[app]` = forbidden sites
    (§3.4)."""
    t0 = time.time()
    exclude = exclude or {}
    site_exclude = site_exclude or {}
    servers = cluster.alive_servers()
    view = _FreeView(servers, reserve_frac=alpha)

    # Lines 2-4: capacity ratio δ
    C = {r: sum(view.free[s.id][r] for s in servers) for r in RESOURCES}
    D = {r: sum(a.full.demand[r] for a in apps) for r in RESOURCES}
    delta = min((C[r] / D[r]) if D[r] > 0 else 1.0 for r in RESOURCES)

    def excluded_for(app: Application) -> Set[str]:
        out = {s for s in exclude.get(app.id, set()) if s}
        for site in site_exclude.get(app.id, set()):
            out |= set(cluster.sites.get(site, ()))
        return out

    assignment = {}
    unplaced: List[str] = []

    # Lines 5-6: variant pre-selection; Lines 7-12: degrade + worst-fit.
    # Apps are visited critical-first, then by request rate (ties in the
    # paper are unspecified; this ordering favors the objective).
    order = sorted(apps, key=lambda a: (not a.critical, -a.request_rate))
    start = {a.id: match(a.variants, delta) for a in apps}
    for app in order:
        placed = False
        for j in range(start[app.id], len(app.variants)):
            v = app.variants[j]
            sid = worst_fit(view, v.demand, excluded_for(app), app, v,
                            latency_fn, app.latency_slo)
            if sid is not None:
                view.take(sid, v.demand)
                assignment[app.id] = (v, sid)
                placed = True
                break
        if not placed:
            unplaced.append(app.id)

    # Lines 13-14: upgrade_model — grow where the chosen server fits more.
    for app in order:
        if app.id not in assignment:
            continue
        v_cur, sid = assignment[app.id]
        j_cur = next(n for n, v in enumerate(app.variants)
                     if v.name == v_cur.name)
        for j in range(j_cur):
            v_up = app.variants[j]
            extra = {r: v_up.demand[r] - v_cur.demand[r] for r in RESOURCES}
            if latency_fn is not None and latency_fn(
                    app, v_up, cluster.servers[sid]) > app.latency_slo:
                continue
            if all(view.free[sid][r] >= extra[r] - 1e-9 and
                   view.budget[r] >= extra[r] - 1e-9 for r in RESOURCES):
                view.give(sid, v_cur.demand)
                view.take(sid, v_up.demand)
                assignment[app.id] = (v_up, sid)
                break

    return HeuristicResult(assignment, unplaced, time.time() - t0,
                           eq1_objective(assignment, apps))
