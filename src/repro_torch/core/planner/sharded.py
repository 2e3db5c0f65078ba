"""Site-sharded worst-fit selection — planet-scale Algorithm 1.

The vectorized planner answers every worst-fit query with a full
(S, R) feasibility broadcast plus a length-S masked argmax. At 10k
servers that is ~20k float compares *per placement attempt*, and a
100k-app planning round does hundreds of thousands of attempts.

This module shards the selection by site: a `SiteIndex` groups the
alive rows per site and maintains each site's maximum headroom
(updated in O(site size) after every tentative take). A query then
scans sites in descending max-headroom order, runs feasibility only on
the rows of sites still able to beat the best feasible row found, and
stops as soon as the next site's ceiling falls below it. On realistic
edge topologies (10-100 servers/site, headroom spread across sites)
a query touches a handful of sites instead of all S rows.

Bit-exactness with the dense path (asserted row-for-row by
tests/test_scale.py): the dense argmax returns the FIRST maximum in
ascending row order, i.e. the minimum row index among rows of maximal
headroom. `select` examines every site whose ceiling is >= the current
best feasible headroom — a skipped site satisfies
``row_head <= site_max < best`` for all its rows, so it can neither
beat nor tie the best — and resolves cross-site ties by minimum global
row index, within-site ties by within-site argmax (rows ascending).
Budget checks, δ-derived start variants, and the upgrade pass are the
shared `plan_greedy` code, so everything except the selection is the
same code path.

Registered as planner "sharded" (realtime): opt in with
``SimConfig(planner="sharded")`` / ``--planner sharded``. Custom
rank/tiebreak/latency hooks need the dense rank vector, so requests
carrying a `latency_fn` fall back to the dense path (on the torch
backend, the latency-masked round); each such fallback is counted in
``stats["fallback_dense"]`` and warned once.

Two scale knobs compose with the sharding: ``backend="torch"`` (the
port's default, ROADMAP P7) routes whole planning rounds through the
device backend (torch_backend.py: one launch of K5's round kernel on
the card — bit-identical to numpy), and ``coordinators=N`` plans
independent site groups on a thread pool (`CoordinatedSiteIndex`) with
a deterministic single-coordinator merge; as in the JAX package, the
backend wins over the coordinators.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core.planner.base import (PlanRequest, PlanResult, Planner,
                                     register_planner)
from repro_torch.core.planner.kernels import resolve_backend
from repro_torch.core.planner.torch_backend import (TorchPlanContext,
                                                    plan_greedy_torch)
from repro_torch.core.planner.vectorized import plan_greedy
from repro_torch.device import DeviceLike

_EPS = 1e-9

logger = logging.getLogger("repro_torch.planner.sharded")


class SiteIndex:
    """Per-site headroom ceilings over the alive rows of one planning
    round (see module docstring). Built by `plan_greedy` when a
    `site_index` factory is passed; row indices here are positions in
    the round's alive-row arrays, not global cluster rows."""

    def __init__(self, site_of_rows: np.ndarray, headroom: np.ndarray):
        order = np.argsort(site_of_rows, kind="stable")
        sids = site_of_rows[order]
        if sids.size:
            starts = np.flatnonzero(
                np.concatenate(([True], sids[1:] != sids[:-1])))
            ends = np.concatenate((starts[1:], [sids.size]))
        else:
            starts = ends = np.empty(0, np.int64)
        # members[g]: the g-th site's row positions, ascending (stable
        # argsort of an ascending range preserves input order)
        self.members = [order[s:e] for s, e in zip(starts, ends)]
        self.group_of = np.empty(site_of_rows.size, np.int64)
        for g, m in enumerate(self.members):
            self.group_of[m] = g
        self.site_max = np.array(
            [headroom[m].max() for m in self.members], np.float64)
        # group-order min rows; when they ascend (contiguous per-site
        # row blocks — the cluster layout), a losing ceiling TIE ends
        # the scan: every later tied group starts at a larger row
        mins = np.array([m[0] for m in self.members], np.int64)
        self._rows_ascend = bool(np.all(mins[1:] > mins[:-1]))

    def update(self, k: int, headroom: np.ndarray):
        """Row k's headroom changed (take/give): refresh its site's
        ceiling — O(site size)."""
        g = int(self.group_of[k])
        self.site_max[g] = float(headroom[self.members[g]].max())

    def _excl_mask(self, excl_rows):
        if excl_rows is None:
            return None
        # membership mask once per query instead of np.isin per
        # examined site — same rows excluded, no sort per site
        excl_mask = np.zeros(self.group_of.size, bool)
        excl_mask[excl_rows] = True
        return excl_mask

    def _scan_groups(self, groups: np.ndarray, free: np.ndarray,
                     headroom: np.ndarray, d: np.ndarray, excl_mask):
        """Descending-ceiling scan restricted to `groups`: the feasible
        row of maximal headroom among those sites, minimal row index on
        ties; (-inf, -1) when nothing fits. Over all groups this is the
        dense argmax; over a slice it is that slice's exact winner, so
        per-slice results merge deterministically (max h, then min
        row)."""
        best_h = -np.inf
        best_k = -1
        for g in groups[np.argsort(-self.site_max[groups],
                                   kind="stable")]:
            sm = float(self.site_max[g])
            if sm < best_h:
                break               # no later site can beat or tie best
            rows = self.members[g]
            # a site whose ceiling only TIES the best cannot win unless
            # it holds a smaller global row: rows are ascending per
            # site, so rows[0] > best_k rules the whole site out
            # without touching feasibility (homogeneous fleets tie
            # almost everywhere — this skips nearly the entire scan)
            if best_k >= 0 and sm == best_h and rows[0] > best_k:
                if self._rows_ascend:
                    break       # ties scan ascending: all later tied
                continue        # groups lose on row index too
            feas = (free[rows] >= d - _EPS).all(axis=1)
            if excl_mask is not None:
                feas &= ~excl_mask[rows]
            if not feas.any():
                continue
            hh = np.where(feas, headroom[rows], -np.inf)
            j = int(np.argmax(hh))          # first max, rows ascending
            h = float(hh[j])
            r = int(rows[j])
            if h > best_h or (h == best_h and r < best_k):
                best_h, best_k = h, r
        return best_h, best_k

    def select(self, free: np.ndarray, headroom: np.ndarray,
               d: np.ndarray, excl_rows) -> int:
        """Dense-argmax-equivalent worst-fit query: the feasible row of
        maximal headroom, minimal row index on ties; -1 when nothing
        fits. Scans sites in descending ceiling order and stops once no
        remaining site can reach the best feasible headroom found."""
        _h, k = self._scan_groups(np.arange(len(self.members)), free,
                                  headroom, d, self._excl_mask(excl_rows))
        return k


class CoordinatedSiteIndex(SiteIndex):
    """Multi-coordinator site-sharded selection.

    The site groups are partitioned into `coordinators` contiguous
    slices ("row groups"); every worst-fit query scans the slices
    concurrently on a thread pool and merges the per-slice winners with
    a deterministic rule — maximal headroom, then minimal global row —
    so the answer is the dense argmax winner regardless of thread
    scheduling (fuzz-asserted by tests/test_planner.py). Per-slice
    scans reuse `SiteIndex._scan_groups`, so each coordinator keeps the
    descending-ceiling early exit within its slice."""

    def __init__(self, site_of_rows: np.ndarray, headroom: np.ndarray,
                 *, coordinators: int = 2, pool=None):
        super().__init__(site_of_rows, headroom)
        G = len(self.members)
        c = max(1, min(int(coordinators), max(G, 1)))
        bounds = np.linspace(0, G, c + 1).astype(np.int64)
        self._slices = [np.arange(bounds[i], bounds[i + 1])
                        for i in range(c) if bounds[i + 1] > bounds[i]]
        self._pool = pool

    def select(self, free: np.ndarray, headroom: np.ndarray,
               d: np.ndarray, excl_rows) -> int:
        excl_mask = self._excl_mask(excl_rows)
        if self._pool is None or len(self._slices) <= 1:
            parts = [self._scan_groups(s, free, headroom, d, excl_mask)
                     for s in self._slices]
        else:
            parts = list(self._pool.map(
                lambda s: self._scan_groups(s, free, headroom, d,
                                            excl_mask), self._slices))
        best_h, best_k = -np.inf, -1
        for h, k in parts:
            if k >= 0 and (h > best_h
                           or (h == best_h and (best_k < 0 or k < best_k))):
                best_h, best_k = h, k
        return best_k


@register_planner("sharded")
class ShardedGreedyPlanner(Planner):
    """Algorithm 1 with site-sharded worst-fit selection (realtime).

    Identical assignments to the "greedy" planner bit-for-bit; chosen
    for planet-scale clusters where the dense per-attempt scan
    dominates failover planning wall time.

    ``backend="torch"`` (the default) routes rounds through the device
    backend instead of the site-sharded Python scan — one launch of
    K5's round kernel per round, same bits; ``device`` is where it runs
    (``cuda`` unless the caller asks for ``cpu``). ``backend="numpy"``
    with ``coordinators=N`` plans with N concurrent site-slice
    coordinators (`CoordinatedSiteIndex`). Requests carrying a
    `latency_fn` take the dense path either way — the latency-masked
    round on torch, `plan_greedy(latency_fn=...)` on numpy — logged once
    per planner instance and counted in ``stats["fallback_dense"]``
    (surfaced via `RunResult.extras`)."""

    realtime = True

    def __init__(self, backend: str = "torch", coordinators: int = 0,
                 device: DeviceLike = None):
        self.backend = resolve_backend(backend)
        self.coordinators = int(coordinators)
        self.stats = {"backend": self.backend,
                      "coordinators": self.coordinators,
                      "torch_rounds": 0, "sharded_rounds": 0,
                      "fallback_dense": 0}
        self._warned_dense = False
        self._ctx = (TorchPlanContext(device) if self.backend == "torch"
                     else None)
        self._pool = None

    def plan(self, req: PlanRequest) -> PlanResult:
        exclude, site_exclude = req.exclusions()
        if req.latency_fn is not None:
            # latency masks need the dense (V, S) layout; correctness
            # over speed for the rare latency-constrained request
            if not self._warned_dense:
                logger.warning(
                    "sharded planner: request carries a latency_fn; "
                    "falling back to the DENSE selection path "
                    "(warning logged once per planner instance; see "
                    "stats['fallback_dense'] for the running count)")
                self._warned_dense = True
            self.stats["fallback_dense"] += 1
            if self.backend == "torch":
                return plan_greedy_torch(
                    req.apps, req.cluster, state=req.state,
                    exclude=exclude, site_exclude=site_exclude,
                    alpha=req.alpha, latency_fn=req.latency_fn,
                    ctx=self._ctx)
            return plan_greedy(req.apps, req.cluster, state=req.state,
                               exclude=exclude, site_exclude=site_exclude,
                               alpha=req.alpha, latency_fn=req.latency_fn)
        if self.backend == "torch":
            self.stats["torch_rounds"] += 1
            return plan_greedy_torch(req.apps, req.cluster, state=req.state,
                                     exclude=exclude,
                                     site_exclude=site_exclude,
                                     alpha=req.alpha, ctx=self._ctx)
        factory = SiteIndex
        if self.coordinators > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.coordinators,
                    thread_name_prefix="planner-coord")
            c, pool = self.coordinators, self._pool

            def factory(site_of_rows, headroom):
                return CoordinatedSiteIndex(site_of_rows, headroom,
                                            coordinators=c, pool=pool)
        self.stats["sharded_rounds"] += 1
        return plan_greedy(req.apps, req.cluster, state=req.state,
                           exclude=exclude, site_exclude=site_exclude,
                           alpha=req.alpha, site_index=factory)


__all__ = ["CoordinatedSiteIndex", "SiteIndex", "ShardedGreedyPlanner"]
