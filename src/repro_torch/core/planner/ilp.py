"""Warm-backup model selection & placement — the paper's ILP (Eq. 1-7),
with constraint assembly built directly from the planner's array state.

max  Σ_{i∈K} Σ_j Σ_k  a_ij · q_i · x_ijk
s.t. per-server capacity (2), α cold-reserve (3), primary anti-affinity
(4, optionally extended to site anti-affinity, §3.4), one backup per app
(5), latency SLO (6, encoded by filtering variables), binary x (7).

The paper solves this with Gurobi; no solver ships offline, so this is
an exact branch-and-bound over the scipy/HiGHS LP relaxation, with the
paper's own heuristic as the incumbent/warm start and as the fallback at
scale (the paper does the same in its large-scale simulation, §5.1).
Eq. 5 is relaxed from == 1 to <= 1 so low-headroom instances stay
feasible; maximization makes them equal whenever the paper's form is
feasible.

The A_ub matrix is assembled as three `scipy.sparse` COO blocks built
from flat (variable -> app/server/demand) index arrays — no Python
row loops — so constraint construction scales with nnz, not with
rows x variables.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import Cluster, RESOURCES
from repro_torch.core.planner.state import PlannerState
from repro_torch.core.variants import Application, Variant


def _branch_frac(x) -> np.ndarray:
    """Per-variable fractionality |x - round(x)|, pinned to float64.

    Branching-variable selection argmaxes this vector; a relaxation
    vector that arrives in a narrower dtype (e.g. float32 from a
    future solver backend) would round 0.49999999-style values to 0.5
    and flip which variable the argmax picks, changing the search tree.
    Casting here makes the branching order a function of the VALUES,
    not of the dtype they were handed over in (regression-tested by
    tests/test_planner.py)."""
    x = np.asarray(x, dtype=np.float64)
    return np.abs(x - np.round(x))


@dataclass
class PlacementResult:
    assignment: Dict[str, Tuple[Variant, str]]   # app -> (variant, server)
    objective: float
    optimal: bool
    nodes: int
    wall_s: float


def enumerate_vars(apps: List[Application], cluster: Cluster,
                   primaries: Dict[str, str], *,
                   site_independence: bool = False,
                   latency_fn=None):
    """Filtered (app, variant, server) triples honoring Eq. 4 and 6.

    Compatibility helper, materialized from the same flat index arrays
    the solver plans with (`_build_variables`), so the two can never
    diverge."""
    state = PlannerState(cluster, subscribe=False)
    ids, (col_app, col_var, col_srv), _, _, _ = _build_variables(
        apps, cluster, primaries, state,
        site_independence=site_independence, latency_fn=latency_fn)
    return [(apps[int(a)], apps[int(a)].variants[int(v)],
             cluster.servers[ids[int(s)]])
            for a, v, s in zip(col_app, col_var, col_srv)]


def _build_variables(apps, cluster, primaries, state, *,
                     site_independence, latency_fn):
    """Flat variable arrays over filtered (app, variant, server) triples.

    Returns (ids, col_app, col_var_local, col_srv, dem, cost, free_alive)
    where columns follow the legacy app -> variant -> server order and
    `dem` is the per-variable demand matrix (nvar, R)."""
    state.sync()
    rows = state.alive_rows()
    S = int(rows.size)
    ids = [state.server_ids[int(i)] for i in rows]
    servers = [cluster.servers[sid] for sid in ids]
    free_alive = state.free[rows]
    site_row = state.site_of[rows]
    pos = {sid: k for k, sid in enumerate(ids)}

    col_app: List[np.ndarray] = []
    col_var: List[np.ndarray] = []
    col_srv: List[np.ndarray] = []
    dem_blocks: List[np.ndarray] = []
    cost_blocks: List[np.ndarray] = []
    for a_idx, app in enumerate(apps):
        base = np.ones(S, dtype=bool)
        p_srv = primaries.get(app.id)
        if p_srv is not None and p_srv in pos:
            base[pos[p_srv]] = False                           # Eq. 4
        if site_independence and p_srv is not None \
                and p_srv in state.sidx:
            p_site = state.site_of[state.sidx[p_srv]]
            base &= site_row != p_site                         # §3.4
        V = len(app.variants)
        if latency_fn is None:
            mask = np.broadcast_to(base, (V, S))
        else:
            lt = np.array([[latency_fn(app, v, srv) for srv in servers]
                           for v in app.variants], dtype=np.float64)
            mask = base[None, :] & (lt <= app.latency_slo)     # Eq. 6
        vi, si = np.nonzero(mask)          # variant-major: legacy order
        if vi.size == 0:
            continue
        col_app.append(np.full(vi.size, a_idx, dtype=np.int64))
        col_var.append(vi.astype(np.int64))
        col_srv.append(si.astype(np.int64))
        vdem = np.array([[v.demand[r] for r in RESOURCES]
                         for v in app.variants], dtype=np.float64)
        dem_blocks.append(vdem[vi])
        acc = np.array([v.accuracy for v in app.variants])
        cost_blocks.append(-(acc[vi] * app.request_rate))      # Eq. 1
    if not col_app:
        return ids, (np.empty(0, np.int64),) * 3, \
            np.empty((0, len(RESOURCES))), np.empty(0), free_alive
    return (ids,
            (np.concatenate(col_app), np.concatenate(col_var),
             np.concatenate(col_srv)),
            np.concatenate(dem_blocks), np.concatenate(cost_blocks),
            free_alive)


def build_constraints(apps, cluster, primaries, *,
                      alpha: float = 0.1,
                      site_independence: bool = False,
                      latency_fn=None,
                      state: Optional[PlannerState] = None):
    """Assemble (c, A_ub, b_ub, columns) via sparse block construction.

    Row layout: S·R per-server capacity rows (Eq. 2), R α-reserve rows
    (Eq. 3), then one <=1 row per app (Eq. 5)."""
    from scipy.sparse import coo_matrix

    if state is None:
        state = PlannerState(cluster, subscribe=False)
    ids, (col_app, col_var, col_srv), dem, c, free_alive = \
        _build_variables(apps, cluster, primaries, state,
                         site_independence=site_independence,
                         latency_fn=latency_fn)
    S, R = free_alive.shape
    nvar = int(col_app.size)
    n_rows = S * R + R + len(apps)
    if nvar == 0:
        A = coo_matrix((n_rows, 0)).tocsr()
        return c, A, np.zeros(n_rows), (ids, col_app, col_var, col_srv)

    cols_rep = np.repeat(np.arange(nvar), R)
    r_idx = np.arange(R)
    # Eq. 2: row = server_row * R + resource
    rows_cap = (col_srv[:, None] * R + r_idx[None, :]).ravel()
    # Eq. 3: R dense rows after the capacity block
    rows_res = np.tile(r_idx, nvar) + S * R
    # Eq. 5: one row per app after that
    rows_one = S * R + R + col_app

    rows = np.concatenate([rows_cap, rows_res, rows_one])
    cols = np.concatenate([cols_rep, cols_rep, np.arange(nvar)])
    vals = np.concatenate([dem.ravel(), dem.ravel(), np.ones(nvar)])
    A = coo_matrix((vals, (rows, cols)), shape=(n_rows, nvar)).tocsr()

    total_free = cluster.total_free()
    b = np.concatenate([
        free_alive.ravel(),
        np.array([(1.0 - alpha) * total_free[r] for r in RESOURCES]),
        np.ones(len(apps)),
    ])
    return c, A, b, (ids, col_app, col_var, col_srv)


def solve_warm_placement(apps: List[Application], cluster: Cluster,
                         primaries: Dict[str, str], *,
                         alpha: float = 0.1,
                         site_independence: bool = False,
                         latency_fn=None,
                         node_limit: int = 500,
                         time_limit_s: float = 10.0,
                         state: Optional[PlannerState] = None,
                         ) -> PlacementResult:
    """Exact B&B over the LP relaxation (falls back to heuristic bound)."""
    from scipy.optimize import linprog

    t0 = time.time()
    c, A, b, (ids, col_app, col_var, col_srv) = build_constraints(
        apps, cluster, primaries, alpha=alpha,
        site_independence=site_independence, latency_fn=latency_fn,
        state=state)
    nvar = int(col_app.size)
    if nvar == 0:
        return PlacementResult({}, 0.0, True, 0, time.time() - t0)

    def lp(lo, hi):
        res = linprog(c, A_ub=A, b_ub=b, bounds=np.stack([lo, hi], axis=1),
                      method="highs")
        if not res.success:
            return None, None
        return res.fun, res.x

    # incumbent from the paper's heuristic (vectorized greedy)
    from repro_torch.core.planner.vectorized import plan_greedy
    greedy = plan_greedy(
        apps, cluster, state=state,
        exclude={a.id: {primaries.get(a.id)} for a in apps},
        site_exclude={a.id: ({cluster.servers[primaries[a.id]].site}
                             if site_independence and a.id in primaries
                             else set()) for a in apps},
        alpha=alpha, latency_fn=latency_fn)
    inc_obj = -greedy.objective
    incumbent = greedy.assignment

    lo0 = np.zeros(nvar)
    hi0 = np.ones(nvar)
    nodes = 0
    heap = []
    root_obj, root_x = lp(lo0, hi0)
    if root_obj is None:
        return PlacementResult(incumbent, -inc_obj, False, 0,
                               time.time() - t0)
    counter = itertools.count()
    heapq.heappush(heap, (root_obj, next(counter), lo0, hi0, root_x))
    best_obj, best_x = inc_obj, None
    optimal = True

    while heap:
        bound, _, lo, hi, x = heapq.heappop(heap)
        if bound >= best_obj - 1e-9:
            continue
        nodes += 1
        if nodes > node_limit or time.time() - t0 > time_limit_s:
            optimal = False
            break
        frac = _branch_frac(x)
        j = int(np.argmax(frac))
        if frac[j] < 1e-6:
            if bound < best_obj - 1e-9:
                best_obj, best_x = bound, x
            continue
        for fix in (0.0, 1.0):
            lo2, hi2 = lo.copy(), hi.copy()
            lo2[j] = hi2[j] = fix
            obj2, x2 = lp(lo2, hi2)
            if obj2 is None or obj2 >= best_obj - 1e-9:
                continue
            frac2 = _branch_frac(x2)
            if frac2.max() < 1e-6:
                best_obj, best_x = obj2, x2
            else:
                heapq.heappush(heap, (obj2, next(counter), lo2, hi2, x2))

    if best_x is None:
        return PlacementResult(incumbent, -inc_obj, optimal, nodes,
                               time.time() - t0)
    assignment: Dict[str, Tuple[Variant, str]] = {}
    sel = np.flatnonzero(best_x > 0.5)
    for n in sel:
        app = apps[int(col_app[n])]
        assignment[app.id] = (app.variants[int(col_var[n])],
                              ids[int(col_srv[n])])
    return PlacementResult(assignment, -best_obj, optimal, nodes,
                           time.time() - t0)
