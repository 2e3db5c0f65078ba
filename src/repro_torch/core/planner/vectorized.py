"""Vectorized Algorithm 1 — array-backed progressive model selection.

Behavior-equivalent to the legacy loop (planner/legacy.py), asserted
bit-exactly by tests/test_planner.py, but the O(V·S) inner work per app
runs as numpy broadcasts instead of Python dict arithmetic:

  * `match` (Line 6) is one broadcast comparison over the flattened
    (A·V) x R variant-demand matrix;
  * worst-fit (Line 9) is a masked argmax over the maintained headroom
    vector (argmax's first-maximum rule reproduces the legacy loop's
    strict-improvement tie-break);
  * the upgrade pass (Lines 13-14) is one vectorized feasibility test
    per app over its larger variants.

Floating-point parity notes: totals that seed δ and the α-budget are
accumulated left-to-right in legacy order (`_ordered_sum`), tentative
takes replay the legacy give-then-take two-step, and all comparisons
use the same 1e-9 epsilon — so identical instances produce identical
assignments AND identical objective bits.

`latency_fn` (Eq. 6) is an arbitrary Python callable, so when present
its (V, S) feasibility mask is materialized once per app up front; the
placement sweep itself stays vectorized.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.core.cluster import Cluster, RESOURCES
from repro_torch.core.planner.base import HeuristicResult, eq1_objective
from repro_torch.core.planner.state import PlannerState, _ordered_sum
from repro_torch.core.variants import Application

_EPS = 1e-9


def _demand_matrix(app: Application) -> np.ndarray:
    # delegates to the per-app cache; kept as the module-level helper
    # other planners import
    return app.demand_matrix()


def plan_greedy(apps: List[Application], cluster: Optional[Cluster] = None,
                *,
                state: Optional[PlannerState] = None,
                exclude: Optional[Dict[str, Set[str]]] = None,
                site_exclude: Optional[Dict[str, Set[str]]] = None,
                alpha: float = 0.0,
                latency_fn=None,
                score_fn=None,
                tiebreak_fn=None,
                site_index=None) -> HeuristicResult:
    """Vectorized Algorithm 1 over a (persistent or throwaway)
    `PlannerState`.

    `score_fn(free, cap, demand, app) -> (S,)` customizes the worst-fit
    ranking (used by the load-aware policy); None means the paper's
    normalized-headroom rule. `tiebreak_fn(app, variant, server_ids) ->
    array` supplies a secondary key (lower = better, first-minimum on
    equal keys) applied among servers whose primary rank ties exactly —
    the locality policy ranks quantized headroom and tie-breaks on
    checkpoint fetch time. None (the default) keeps argmax's
    first-maximum rule, i.e. the legacy bit-exact behavior.

    `site_index` is a factory (e.g. `sharded.SiteIndex`) building a
    site-hierarchical selection structure over the alive rows; when
    given, the worst-fit argmax is answered by `index.select` (scanning
    only the top sites by maintained per-site headroom) instead of the
    full-matrix masked argmax — bit-identical winners, sublinear
    per-attempt work (see planner/sharded.py). Only valid with the
    default rank (no score/tiebreak/latency customization).
    """
    t0 = time.time()
    exclude = exclude or {}
    site_exclude = site_exclude or {}
    if state is None:
        assert cluster is not None, "need a cluster or a PlannerState"
        state = PlannerState(cluster, subscribe=False)
    if cluster is None:
        cluster = state.cluster
    state.sync()

    order = sorted(apps, key=lambda a: (not a.critical, -a.request_rate))
    rows = state.alive_rows()
    S = int(rows.size)
    if not apps or S == 0:
        assignment: Dict[str, tuple] = {}
        return HeuristicResult(assignment, [a.id for a in order],
                               time.time() - t0,
                               eq1_objective(assignment, apps))

    ids = [state.server_ids[int(i)] for i in rows]
    free = state.free[rows].copy()               # (S, R) working copy
    cap = state.capacity[rows]
    R = len(RESOURCES)

    # Lines 2-4: capacity ratio δ (ordered sums = legacy bit-parity);
    # full-size demands come from the cached per-variant vectors, and
    # _ordered_sum replays builtin sum()'s left-to-right accumulation
    full_dem = np.array([a.full.demand_vec for a in apps],
                        dtype=np.float64).reshape(len(apps), R)
    C = [_ordered_sum(free[:, j]) for j in range(R)]
    D = [_ordered_sum(full_dem[:, j]) for j in range(R)]
    delta = min((C[j] / D[j]) if D[j] > 0 else 1.0 for j in range(R))
    budget = np.array([(1.0 - alpha) * C[j] for j in range(R)],
                      dtype=np.float64)

    # per-app arrays: variant demands (cached on the Application),
    # sparse excluded-row lists (a dense (A, S) bool mask is ~1 GB at
    # 100k apps x 10k servers; exclusions are a handful of rows per
    # app), and the optional latency mask
    dm = {a.id: _demand_matrix(a) for a in apps}
    excl_rows: Dict[str, np.ndarray] = {}
    lat: Dict[str, Optional[np.ndarray]] = {}
    pos = {sid: k for k, sid in enumerate(ids)}
    servers = ([cluster.servers[sid] for sid in ids]
               if latency_fn is not None else None)
    for app in apps:
        er: List[int] = []
        for sid in exclude.get(app.id, ()):
            if sid and sid in pos:
                er.append(pos[sid])
        for site in site_exclude.get(app.id, ()):
            for sid in cluster.sites.get(site, ()):
                if sid in pos:
                    er.append(pos[sid])
        if er:
            excl_rows[app.id] = np.array(sorted(set(er)), dtype=np.int64)
        if latency_fn is None:
            lat[app.id] = None
        else:
            lt = np.array([[latency_fn(app, v, srv) for srv in servers]
                           for v in app.variants], dtype=np.float64)
            # mirror the legacy skip condition `lat > slo` exactly
            # (NaN compares False there, i.e. allowed)
            lat[app.id] = np.logical_not(lt > app.latency_slo)

    # Lines 5-6: match as ONE broadcast comparison over all variants
    start: Dict[str, int] = {}
    if delta >= 1.0:
        for app in apps:
            start[app.id] = 0
    else:
        counts = [len(a.variants) for a in apps]
        offs = np.concatenate([[0], np.cumsum(counts)])
        all_dem = np.concatenate([dm[a.id] for a in apps])     # (T, R)
        thr = np.repeat(delta * full_dem + _EPS, counts, axis=0)
        okv = (all_dem <= thr).all(axis=1)
        for k, app in enumerate(apps):
            seg = np.flatnonzero(okv[offs[k]:offs[k + 1]])
            start[app.id] = (int(seg[0]) if seg.size
                             else len(app.variants) - 1)

    assignment = {}
    chosen: Dict[str, tuple] = {}     # app -> (variant idx, server row)
    unplaced: List[str] = []
    headroom = (free / cap).min(axis=1)          # maintained per take
    sindex = None
    if site_index is not None:
        assert score_fn is None and tiebreak_fn is None \
            and latency_fn is None, \
            "site-sharded selection requires the default worst-fit rank"
        sindex = site_index(state.site_of[rows], headroom)

    # Lines 7-12: degrade + worst-fit, vectorized over servers
    for app in order:
        d_app = dm[app.id]
        er = excl_rows.get(app.id)
        lm = lat[app.id]
        placed = False
        for j in range(start[app.id], len(app.variants)):
            d = d_app[j]
            if not (budget >= d - _EPS).all():
                continue              # α-budget binds every server alike
            if sindex is not None:
                k = sindex.select(free, headroom, d, er)
                if k < 0:
                    continue
            else:
                feas = (free >= d - _EPS).all(axis=1)
                if er is not None:
                    feas[er] = False
                if lm is not None:
                    feas &= lm[j]
                if not feas.any():
                    continue
                if score_fn is None:
                    rank = headroom
                else:
                    rank = score_fn(free, cap, d, app)
                masked = np.where(feas, rank, -np.inf)
                k = int(np.argmax(masked))
                if tiebreak_fn is not None:
                    ties = np.flatnonzero(masked == masked[k])
                    if ties.size > 1:
                        tb = np.asarray(
                            tiebreak_fn(app, app.variants[j],
                                        [ids[int(t)] for t in ties]),
                            dtype=np.float64)
                        k = int(ties[int(np.argmin(tb))])
            free[k] -= d
            budget -= d
            headroom[k] = (free[k] / cap[k]).min()
            if sindex is not None:
                sindex.update(k, headroom)
            assignment[app.id] = (app.variants[j], ids[k])
            chosen[app.id] = (j, k)
            placed = True
            break
        if not placed:
            unplaced.append(app.id)

    # Lines 13-14: upgrade_model — one feasibility broadcast per app
    for app in order:
        if app.id not in assignment:
            continue
        j_cur, k = chosen[app.id]
        if j_cur == 0:
            continue
        d_app = dm[app.id]
        extras = d_app[:j_cur] - d_app[j_cur]            # (j_cur, R)
        feas = ((free[k] >= extras - _EPS).all(axis=1)
                & (budget >= extras - _EPS).all(axis=1))
        lm = lat[app.id]
        if lm is not None:
            feas &= lm[:j_cur, k]
        ups = np.flatnonzero(feas)
        if ups.size:
            j_up = int(ups[0])
            # give(current) then take(upgrade), NOT one fused delta —
            # replays the legacy float rounding exactly
            free[k] += d_app[j_cur]
            budget += d_app[j_cur]
            free[k] -= d_app[j_up]
            budget -= d_app[j_up]
            headroom[k] = (free[k] / cap[k]).min()
            if sindex is not None:
                sindex.update(k, headroom)
            assignment[app.id] = (app.variants[j_up], ids[k])
            chosen[app.id] = (j_up, k)

    return HeuristicResult(assignment, unplaced, time.time() - t0,
                           eq1_objective(assignment, apps))


def faillite_heuristic(apps: List[Application], cluster: Cluster, *,
                       exclude: Optional[Dict[str, Set[str]]] = None,
                       site_exclude: Optional[Dict[str, Set[str]]] = None,
                       alpha: float = 0.0,
                       latency_fn=None,
                       state: Optional[PlannerState] = None,
                       ) -> HeuristicResult:
    """Algorithm 1 — drop-in replacement of the legacy entry point,
    now vectorized (optionally reusing a persistent `PlannerState`)."""
    return plan_greedy(apps, cluster, state=state, exclude=exclude,
                       site_exclude=site_exclude, alpha=alpha,
                       latency_fn=latency_fn)
