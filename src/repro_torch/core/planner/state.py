"""Array-backed placement core: the persistent, incrementally-updated
free-capacity view every planner plans against.

Layout (S servers x R resources, row order = `Cluster.servers` order):

    capacity  (S, R) float64   static per-server capacity
    free      (S, R) float64   capacity - Σ non-cold instance demand
    alive     (S,)   bool      liveness mask
    site_of   (S,)   int       row -> site index (anti-affinity, §3.4)

Incremental-update contract: the state subscribes to `Cluster` change
notifications (place/remove/fail/revive), marking the touched server
*dirty*; `sync()` re-derives only the dirty rows from the cluster —
exact (each row is recomputed with `Server.free`, so there is no
floating-point drift from accumulated deltas) and O(dirty) instead of
O(S·instances) per planning call. `handle_failures`/`handle_rejoin`/
`reprotect` therefore feed server-granular deltas into one persistent
state rather than rebuilding a view per call.

`ScratchView` is the public successor of the old `_FreeView`: tentative
take/give accounting over a copy of the free matrix, with the α-budget
(Eq. 3) held back, used for multi-placement rounds before committing to
the cluster.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.cluster import Cluster, RESOURCES

_EPS = 1e-9


def _ordered_sum(values) -> float:
    """Left-to-right float sum, matching Python's builtin `sum` over the
    same sequence (bit-parity with the legacy dict-based planner)."""
    total = 0.0
    for v in values:
        total += float(v)
    return total


class PlannerState:
    """Persistent array view of a `Cluster` (see module docstring)."""

    def __init__(self, cluster: Cluster, *, subscribe: bool = True,
                 dtype="float64"):
        self.cluster = cluster
        # array dtype: float64 is the bit-exact default; float32 halves
        # the (S, R) matrices' footprint for planet-scale runs (ulp at
        # 16 GB is ~1 KB — placement-equivalent in practice but NOT
        # fingerprint-preserving, see docs/SCALE.md)
        self.dtype = np.dtype(dtype)
        # model-state plane attachment (checkpoint residency columns):
        # locality-aware policies read per-server residency and fetch
        # costs through this; None = no registry attached
        self.registry = None
        # attached device mirrors (planner/jax_backend.DeviceMirror):
        # sync() forwards dirty rows, structural rebuilds invalidate
        self._mirrors: List = []
        self._rebuild()
        if subscribe:
            cluster.subscribe(self._on_change)

    # -- construction / sync ------------------------------------------------
    def _rebuild(self):
        servers = list(self.cluster.servers.values())
        self.server_ids: List[str] = [s.id for s in servers]
        self.sidx: Dict[str, int] = {sid: i for i, sid
                                     in enumerate(self.server_ids)}
        S, R = len(servers), len(RESOURCES)
        self.capacity = np.array(
            [[s.capacity[r] for r in RESOURCES] for s in servers],
            dtype=self.dtype).reshape(S, R)
        self.free = np.zeros((S, R), dtype=self.dtype)
        self.alive = np.zeros(S, dtype=bool)
        # maintained per-row normalized headroom (min over resources):
        # recomputed for dirty rows in sync() so worst_fit never
        # re-divides the full (S, R) matrices per placement attempt
        self.head = np.zeros(S, dtype=self.dtype)
        self._alive_cache: Optional[np.ndarray] = None
        sites = []
        site_idx: Dict[str, int] = {}
        for s in servers:
            if s.site not in site_idx:
                site_idx[s.site] = len(sites)
                sites.append(s.site)
        self.site_names = sites
        self.site_of = np.array([site_idx[s.site] for s in servers],
                                dtype=np.int64)
        self._dirty = set(range(S))
        self._structure_stale = False
        self._alive_cache = None
        # _rebuild also runs from __init__, before _mirrors exists
        for m in getattr(self, "_mirrors", ()):
            m.invalidate()

    def _on_change(self, server_id: str):
        i = self.sidx.get(server_id)
        if i is None:                 # server set changed out-of-band
            self._structure_stale = True
        else:
            self._dirty.add(i)

    def sync(self) -> int:
        """Re-derive dirty rows from the cluster; returns rows touched."""
        if self._structure_stale:
            self._rebuild()
            self._structure_stale = False
        if not self._dirty:
            return 0
        n = len(self._dirty)
        R = len(RESOURCES)
        idx = np.fromiter(self._dirty, np.int64, n)
        rows = np.empty((n, R), np.float64)
        for t in range(n):
            i = int(idx[t])
            srv = self.cluster.servers[self.server_ids[i]]
            # accumulate cached per-variant demand vectors instead of
            # Server.free's per-resource dict-building genexpr: same
            # instances, same iteration order, same left-to-right
            # float64 adds per component — bit-identical row values
            used = np.zeros(R, np.float64)
            for inst in srv.instances.values():
                if inst.role != "cold":
                    used += inst.variant.demand_vec
            rows[t] = [srv.capacity[r] for r in RESOURCES]
            rows[t] -= used
            if self.alive[i] != srv.alive:
                self.alive[i] = srv.alive
                self._alive_cache = None
        self.free[idx] = rows
        # same per-row math worst_fit used to run over the full matrix:
        # min over resources of free/capacity, divided in the state
        # dtype (batched over dirty rows — elementwise, so each row is
        # bit-identical to the former one-row-at-a-time computation)
        self.head[idx] = (self.free[idx] / self.capacity[idx]).min(axis=1)
        for m in self._mirrors:
            m.mark_dirty(self._dirty)
        self._dirty.clear()
        return n

    # -- queries ------------------------------------------------------------
    @property
    def n_dirty(self) -> int:
        return len(self._dirty)

    def alive_rows(self) -> np.ndarray:
        """Row indices of alive servers, in cluster order (the legacy
        `alive_servers()` iteration order). Cached; invalidated when a
        sync flips any row's liveness."""
        if self._alive_cache is None:
            self._alive_cache = np.flatnonzero(self.alive)
        return self._alive_cache

    def mask_of(self, server_ids: Iterable[str], rows: np.ndarray,
                ) -> np.ndarray:
        """Bool mask (len(rows),) — True where the row's server is in
        `server_ids` (unknown/dead ids are ignored)."""
        pos = {int(i): k for k, i in enumerate(rows)}
        out = np.zeros(len(rows), dtype=bool)
        for sid in server_ids:
            i = self.sidx.get(sid) if sid else None
            if i is not None and i in pos:
                out[pos[i]] = True
        return out

    def worst_fit(self, demand, excluded: Iterable[str] = ()
                  ) -> Optional[str]:
        """Most-headroom alive server fitting `demand` (Alg. 1 line 9);
        first-maximum tie-break, matching the legacy loop.

        `demand` is a resource dict or a prebuilt `RESOURCES`-ordered
        vector (`Variant.demand_vec` — the hot failover path passes the
        cached array). Runs one fused feasibility pass over the full
        matrix against the maintained headroom column: no row gather,
        no per-call division, no per-call demand-vector rebuild. The
        old defensive total-free budget check is gone — free is
        non-negative, so the sum can never bind when any per-server fit
        passes."""
        self.sync()
        d = (demand if isinstance(demand, np.ndarray)
             else np.array([demand[r] for r in RESOURCES],
                           dtype=np.float64))
        feas = self.alive & (self.free >= d - _EPS).all(axis=1)
        for sid in excluded:
            i = self.sidx.get(sid) if sid else None
            if i is not None:
                feas[i] = False
        if not feas.any():
            return None
        # full-row masked argmax: first maximum among feasible rows in
        # ascending row order — the same winner the gathered sub-array
        # argmax picked
        i = int(np.argmax(np.where(feas, self.head, -np.inf)))
        return self.server_ids[i]

    def place_group(self, demand, k: int, excluded: Iterable[str] = ()
                    ) -> Optional[List[str]]:
        """Pick k *distinct* alive servers each fitting `demand` — the
        shard-group placement primitive. Co-placement: prefer the site
        holding the most-headroom feasible server with >= k feasible
        members (TP traffic stays on the site fabric); fall back to
        cluster-wide spread when no single site can host the group.
        Anti-affinity (one shard per server) is inherent: rows are
        distinct servers. Deterministic: headroom-descending with
        row-order tie-break, like `worst_fit`."""
        self.sync()
        d = (demand if isinstance(demand, np.ndarray)
             else np.array([demand[r] for r in RESOURCES],
                           dtype=np.float64))
        feas = self.alive & (self.free >= d - _EPS).all(axis=1)
        for sid in excluded:
            i = self.sidx.get(sid) if sid else None
            if i is not None:
                feas[i] = False
        if int(feas.sum()) < k:
            return None
        head = np.where(feas, self.head, -np.inf)
        best_site, best_key = None, None
        for s in range(len(self.site_names)):
            rows = np.flatnonzero(feas & (self.site_of == s))
            if len(rows) >= k:
                key = float(head[rows].max())
                if best_key is None or key > best_key:
                    best_site, best_key = s, key
        if best_site is not None:
            rows = np.flatnonzero(feas & (self.site_of == best_site))
        else:
            rows = np.flatnonzero(feas)
        order = sorted(rows.tolist(), key=lambda i: (-head[i], i))[:k]
        return [self.server_ids[i] for i in order]

    def scratch(self, reserve_frac: float = 0.0) -> "ScratchView":
        return ScratchView(self, reserve_frac=reserve_frac)

    # -- device mirrors ------------------------------------------------------
    def attach_mirror(self, mirror) -> None:
        """Register a device-side mirror of the free/head/alive arrays
        (the jax backend's `DeviceMirror`). `sync()` forwards the dirty
        row set to `mirror.mark_dirty` before clearing it, and a
        structural `_rebuild` calls `mirror.invalidate` — so the mirror
        can stay incremental (O(dirty) scatter) without re-deriving
        anything from the cluster itself."""
        self._mirrors.append(mirror)

    # -- model-state columns -------------------------------------------------
    def attach_registry(self, registry) -> None:
        """Attach a `core.modelstate.ModelRegistry` so locality-aware
        policies can read checkpoint residency per server (the
        `locality` planner's tie-break reads `registry.fetch_seconds`
        through this attachment)."""
        self.registry = registry

    def residency_mask(self, variant_name: str) -> np.ndarray:
        """(S,) bool column — True where the server holds the variant's
        checkpoint on local disk."""
        assert self.registry is not None, "no ModelRegistry attached"
        mask = np.zeros(len(self.server_ids), dtype=bool)
        for sid in self.registry.resident_servers(variant_name):
            i = self.sidx.get(sid)
            if i is not None:
                mask[i] = True
        return mask


class ScratchView:
    """Tentative free-capacity accounting over the alive rows of a
    `PlannerState` — array-backed replacement for the old `_FreeView`."""

    def __init__(self, state: PlannerState, reserve_frac: float = 0.0):
        state.sync()
        self.state = state
        self.rows = state.alive_rows()
        self.ids = [state.server_ids[int(i)] for i in self.rows]
        self.pos = {sid: k for k, sid in enumerate(self.ids)}
        self.free = state.free[self.rows].copy()
        self.cap = state.capacity[self.rows].copy()
        # α-reserve (Eq. 3): hold back a fraction of TOTAL free capacity;
        # ordered sums keep bit-parity with the legacy implementation
        self.budget = np.array(
            [(1.0 - reserve_frac) * _ordered_sum(self.free[:, j])
             for j in range(len(RESOURCES))], dtype=np.float64)

    def _vec(self, demand) -> np.ndarray:
        """Demand dict -> vector; prebuilt vectors (`Variant.demand_vec`)
        pass straight through."""
        if isinstance(demand, np.ndarray):
            return demand
        return np.array([demand[r] for r in RESOURCES], dtype=np.float64)

    def fits(self, sid: str, demand: Dict[str, float]) -> bool:
        d = self._vec(demand)
        k = self.pos[sid]
        return (bool((self.free[k] >= d - _EPS).all())
                and bool((self.budget >= d - _EPS).all()))

    def take(self, sid: str, demand: Dict[str, float]):
        d = self._vec(demand)
        self.free[self.pos[sid]] -= d
        self.budget -= d

    def give(self, sid: str, demand: Dict[str, float]):
        d = self._vec(demand)
        self.free[self.pos[sid]] += d
        self.budget += d

    def headroom(self, sid: str) -> float:
        k = self.pos[sid]
        return float((self.free[k] / self.cap[k]).min())

    def worst_fit(self, demand: Dict[str, float],
                  excluded: Iterable[str] = ()) -> Optional[str]:
        d = self._vec(demand)
        if not (self.budget >= d - _EPS).all():
            return None
        feas = (self.free >= d - _EPS).all(axis=1)
        for sid in excluded:
            k = self.pos.get(sid)
            if k is not None:
                feas[k] = False
        if not feas.any():
            return None
        head = (self.free / self.cap).min(axis=1)
        k = int(np.argmax(np.where(feas, head, -np.inf)))
        return self.ids[k]
