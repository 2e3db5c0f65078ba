"""Torch planner backend — Algorithm 1 on device tensors, bit-identical
to numpy.

The port of ``repro/core/planner/jax_backend.py``. `plan_greedy_torch`
is a transliteration of `vectorized.plan_greedy` (default rank, no
latency/score/tiebreak hooks) whose inner loops run as the chunk
functions of planner/kernels.py, with the worst-fit reduction on K5. The
host side is byte for byte the numpy prologue — ordering, ordered-sum δ
and α-budget, per-app exclusion rows — so the device path and the numpy
path consume identical inputs; the device side replays every comparison,
argmax and state update as the same IEEE operations in the same order
(see kernels.py). tests/test_torch_planner.py asserts that assignments
AND objective bits match across random clusters, exclusions, dtypes and
dirty-sync sequences.

Two pieces of persistent state make repeated rounds cheap:

  * `DeviceMirror` — device-resident (S, R) free / (S,) head / alive /
    capacity copies of a `PlannerState`, registered via
    `PlannerState.attach_mirror` so `sync()` forwards its dirty rows; a
    refresh writes O(dirty) rows instead of re-uploading the matrices.
    A round plans on clones of free and head, never on the mirror.
  * `AppMatrixCache` — padded per-app variant-demand tensors, gathered
    per round by row index (apps are immutable, so rows never go
    stale).

A round reads its placements back to the host once and its upgrades
once.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.core.cluster import RESOURCES
from repro_torch.core.planner.base import HeuristicResult, eq1_objective
from repro_torch.core.planner.kernels import (place_chunk, scatter_rows,
                                              upgrade_chunk)
from repro_torch.core.planner.state import PlannerState, _ordered_sum
from repro_torch.core.variants import Application
from repro_torch.device import DeviceLike, resolve_device

_EPS = 1e-9


def _cmp_thresholds(dm: np.ndarray, dtype) -> np.ndarray:
    """Feasibility thresholds in the state dtype, exactly equivalent to
    numpy's f64 comparison.

    numpy decides `free >= d - eps` in f64 (f32 state rows promote
    losslessly). For an f32 x and real t, `x >= t` iff `x >= c` where
    c is the smallest f32 with c >= t — so rounding t = d - eps UP to
    the state dtype lets the device compare in pure f32, halving the
    (S, R) memory traffic of its hottest loop with zero behavior
    change. For f64 state the threshold is t itself."""
    t = dm - _EPS
    if np.dtype(dtype) == np.float64:
        return t
    c = t.astype(np.float32)
    low = c.astype(np.float64) < t
    return np.where(low, np.nextafter(c, np.float32(np.inf)),
                    c).astype(np.float32)


def _to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (never a view of host memory)."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


class DeviceMirror:
    """Device-resident mirror of a `PlannerState` (free/head/alive/cap).

    Attach once per state; `PlannerState.sync()` forwards dirty rows to
    `mark_dirty`, structural rebuilds call `invalidate`. `arrays()`
    returns the current device tensors, writing only the pending rows."""

    def __init__(self, state: PlannerState, device: torch.device):
        self.state = state
        self.device = device
        self._pending: set = set()
        self._bufs = None                  # (free, head, alive) on device
        self._cap = None
        self.full_uploads = 0
        self.rows_scattered = 0
        state.attach_mirror(self)

    def mark_dirty(self, rows) -> None:
        if self._bufs is not None:
            self._pending.update(int(r) for r in rows)

    def invalidate(self) -> None:
        self._bufs = None
        self._cap = None
        self._pending.clear()

    def arrays(self):
        """(free, head, alive, cap) device tensors, synced to the state.
        Caller must have called `state.sync()`."""
        st = self.state
        if self._bufs is None:
            self._bufs = (_to(st.free, self.device),
                          _to(st.head, self.device),
                          _to(st.alive, self.device))
            self._cap = _to(st.capacity, self.device)
            self._pending.clear()
            self.full_uploads += 1
        elif self._pending:
            idx = np.fromiter(sorted(self._pending), np.int64,
                              len(self._pending))
            scatter_rows(*self._bufs, _to(idx, self.device),
                         _to(st.free[idx], self.device),
                         _to(st.head[idx], self.device),
                         _to(st.alive[idx], self.device))
            self._pending.clear()
            self.rows_scattered += int(idx.size)
        return (*self._bufs, self._cap)


class AppMatrixCache:
    """Padded (V, R) demand tensors per app, gathered per round.

    Apps and their variant ladders are immutable, so a cached row never
    goes stale; the cache re-pads only when an app with more variants
    than the current pad width appears, and a round gathers its rows at
    the width of its own longest ladder. A row belongs to
    the Application object it was built from: another object under a
    cached id gets a row of its own (the JAX package's cache keys by id
    alone, and plans such an app with the old app's demands)."""

    def __init__(self):
        self.V = 1
        self._row: Dict[str, int] = {}
        self._app: Dict[str, Application] = {}
        self._dm = np.zeros((0, self.V, len(RESOURCES)), np.float64)
        self._vmask = np.zeros((0, self.V), bool)
        self._full = np.zeros((0, len(RESOURCES)), np.float64)

    def _grow_v(self, V: int) -> None:
        n = self._dm.shape[0]
        dm = np.full((n, V, len(RESOURCES)), np.inf, np.float64)
        dm[:, :self.V] = self._dm
        vm = np.zeros((n, V), bool)
        vm[:, :self.V] = self._vmask
        self._dm, self._vmask, self.V = dm, vm, V

    def rows(self, apps: List[Application]) -> np.ndarray:
        """Row indices for `apps`, adding unseen apps to the cache."""
        new = [a for a in apps if self._app.get(a.id) is not a]
        if new:
            maxv = max(len(a.variants) for a in new)
            if maxv > self.V:
                self._grow_v(maxv)
            n0 = self._dm.shape[0]
            dm = np.full((len(new), self.V, len(RESOURCES)), np.inf,
                         np.float64)
            vm = np.zeros((len(new), self.V), bool)
            fd = np.zeros((len(new), len(RESOURCES)), np.float64)
            for i, a in enumerate(new):
                m = a.demand_matrix()
                dm[i, :m.shape[0]] = m
                vm[i, :m.shape[0]] = True
                fd[i] = a.full.demand_vec
                self._row[a.id] = n0 + i
                self._app[a.id] = a
            self._dm = np.concatenate([self._dm, dm])
            self._vmask = np.concatenate([self._vmask, vm])
            self._full = np.concatenate([self._full, fd])
        return np.array([self._row[a.id] for a in apps], np.int64)

    def gather(self, rows: np.ndarray):
        """(demands (n, V, R), variant mask (n, V), full demand (n, R))
        of the given rows, V the longest ladder among them."""
        vm = self._vmask[rows]
        V = max(int(vm.sum(axis=1).max(initial=1)), 1)
        return self._dm[rows, :V], vm[:, :V], self._full[rows]


class TorchPlanContext:
    """Per-planner-instance persistent caches: the device, one
    `DeviceMirror` per `PlannerState` identity, and the shared
    `AppMatrixCache`. ``device`` is ``cuda`` unless the caller asks for
    ``cpu`` (raises when there is no card)."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.apps = AppMatrixCache()
        self._mirrors: Dict[int, DeviceMirror] = {}

    def mirror(self, state: PlannerState) -> DeviceMirror:
        m = self._mirrors.get(id(state))
        if m is None or m.state is not state:
            m = DeviceMirror(state, self.device)
            self._mirrors[id(state)] = m
        return m


def plan_greedy_torch(apps: List[Application], cluster=None, *,
                      state: Optional[PlannerState] = None,
                      exclude: Optional[Dict[str, Set[str]]] = None,
                      site_exclude: Optional[Dict[str, Set[str]]] = None,
                      alpha: float = 0.0,
                      ctx: Optional[TorchPlanContext] = None,
                      device: DeviceLike = None,
                      ) -> HeuristicResult:
    """Algorithm 1 on device tensors — same contract (and same bits) as
    `vectorized.plan_greedy` with the default worst-fit rank.

    ``device`` (used when no ``ctx`` is given) is ``cuda`` unless the
    caller asks for ``cpu``. Unsupported hooks (latency_fn / score_fn /
    tiebreak_fn / site_index) are the caller's responsibility: the
    planner policies route such requests to the numpy path."""
    t0 = time.time()
    exclude = exclude or {}
    site_exclude = site_exclude or {}
    if state is None:
        assert cluster is not None, "need a cluster or a PlannerState"
        state = PlannerState(cluster, subscribe=False)
    if cluster is None:
        cluster = state.cluster
    if ctx is None:
        ctx = TorchPlanContext(device)
    state.sync()

    order = sorted(apps, key=lambda a: (not a.critical, -a.request_rate))
    rows = state.alive_rows()
    if not apps or rows.size == 0:
        assignment: Dict[str, tuple] = {}
        return HeuristicResult(assignment, [a.id for a in order],
                               time.time() - t0,
                               eq1_objective(assignment, apps))

    S = int(state.alive.size)                    # full rows; dead masked
    R = len(RESOURCES)

    # host prologue — the numpy path's exact code over the gathered
    # alive rows: ordered sums seed δ and the α-budget bit-identically
    arows = ctx.apps.rows(order)
    dm_all, vmask_all, full_order = ctx.apps.gather(arows)
    gfree = state.free[rows]
    C = [_ordered_sum(gfree[:, j]) for j in range(R)]
    # δ's demand total is accumulated in `apps` order (not placement
    # order), matching plan_greedy's full_dem construction
    full_apps = np.array([a.full.demand_vec for a in apps],
                         dtype=np.float64).reshape(len(apps), R)
    D = [_ordered_sum(full_apps[:, j]) for j in range(R)]
    delta = min((C[j] / D[j]) if D[j] > 0 else 1.0 for j in range(R))
    budget0 = np.array([(1.0 - alpha) * C[j] for j in range(R)],
                       dtype=np.float64)

    # match (Line 6) on the host, from host data alone: the first
    # variant under the δ threshold, else the smallest — the numpy
    # segment scan (every variant passes when δ >= 1)
    if delta >= 1.0:
        okv = vmask_all
    else:
        thr_all = delta * full_order + _EPS
        okv = (dm_all <= thr_all[:, None, :]).all(axis=2) & vmask_all
    nvar = np.maximum(vmask_all.sum(axis=1), 1)
    start = np.where(okv.any(axis=1), okv.argmax(axis=1), nvar - 1)

    # sparse per-app exclusion rows as GLOBAL row indices (the device
    # masks the full alive vector, so dead rows are harmless to list);
    # as (app, row) pairs, so no row index is padded
    excl_app: List[int] = []
    excl_row: List[int] = []
    for a_i, app in enumerate(order):
        for sid in exclude.get(app.id, ()):
            if sid:
                i = state.sidx.get(sid)
                if i is not None:
                    excl_app.append(a_i)
                    excl_row.append(i)
        for site in site_exclude.get(app.id, ()):
            for sid in cluster.sites.get(site, ()):
                i = state.sidx.get(sid)
                if i is not None:
                    excl_app.append(a_i)
                    excl_row.append(i)
    excl_app_np = np.asarray(excl_app, np.int64)
    excl_row_np = np.asarray(excl_row, np.int64)

    dmc_all = _cmp_thresholds(dm_all, state.dtype)

    dev = ctx.device
    free0, head0, alive, cap = ctx.mirror(state).arrays()
    free, head = free0.clone(), head0.clone()    # the round's working copy
    budget = _to(budget0, dev)

    A = len(order)
    dm = _to(dm_all, dev)
    allowed = alive.repeat(A, 1)
    allowed[_to(excl_app_np, dev), _to(excl_row_np, dev)] = False
    j, k = place_chunk(free, head, budget, cap, allowed, dm,
                       _to(dmc_all, dev), start, nvar)
    jk = torch.stack([j, k]).cpu().numpy()           # one read: placements
    placed = jk[0] < nvar - start
    jj = np.where(placed, jk[0] + start, -1)
    kk = np.where(placed, jk[1], -1)

    # upgrade pass over the SAME order once every app is placed —
    # matching the numpy path's two sequential sweeps
    ju = upgrade_chunk(free, head, budget, cap, dm, jj,
                       kk).cpu().numpy()             # one read: upgrades

    assignment = {}
    unplaced: List[str] = []
    for i, app in enumerate(order):
        k = int(kk[i])
        if k < 0:
            unplaced.append(app.id)
            continue
        j = int(ju[i]) if int(ju[i]) >= 0 else int(jj[i])
        assignment[app.id] = (app.variants[j], state.server_ids[k])

    return HeuristicResult(assignment, unplaced, time.time() - t0,
                           eq1_objective(assignment, apps))


__all__ = ["AppMatrixCache", "DeviceMirror", "TorchPlanContext",
           "plan_greedy_torch"]
