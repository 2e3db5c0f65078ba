"""FailLite controller: two-step proactive + progressive failover (§3).

Workflow (paper Fig. 4):
  (1) app arrival -> place primary, proactive warm-backup planning (ILP)
  (2) agents load models per policy
  (3) heartbeat failure detection -> progressive failover (Algorithm 1)
  (4) progressive loading: smallest variant first, hot-swap to selected
      — dispatched through the RecoveryScheduler drain queue ("fifo" =
      historical order; "criticality" = restore-before-upgrade,
      critical apps first, preemptive)
  (5) clients re-routed via routing-epoch push

The model-state plane (core/modelstate.py) threads through: the
controller seeds checkpoint replicas at deploy, records each
recovery's MTTR phase breakdown from the executor's LoadTickets, and
proactively re-replicates under-protected checkpoints in idle
re-protection rounds.

The same controller frame runs the paper's three baselines
(Full-Size-Warm / -Cold / -Warm(K)) via `policy=`, and runs against
either the discrete-event simulator or the thread-based mini-testbed via
the LoadExecutor interface.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.cluster import Cluster, Instance
from repro_torch.core.datastore import DataStore
from repro_torch.core.heartbeat import Clock, FailureDetector
from repro_torch.core.modelstate import ModelRegistry
from repro_torch.core.planner import PlanRequest, PlannerState, get_planner
from repro_torch.core.variants import Application, Variant
from repro_torch.device import DeviceLike

POLICIES = ("faillite", "full-warm", "full-cold", "full-warm-k")
SCHEDULERS = ("fifo", "criticality")

NOTIFY_OVERHEAD_S = 0.010      # client push notification (paper §5.7)


class LoadExecutor:
    """Backend that actually loads/activates model instances."""

    def load(self, app: Application, variant: Variant, server_id: str,
             on_ready: Callable[[float], None]):
        """Asynchronously load; call on_ready(completion_time)."""
        raise NotImplementedError

    def unload(self, key: str, server_id: str):
        pass

    def activate(self, app: Application, variant: Variant, server_id: str):
        """Warm instance starts serving (instant)."""
        pass

    def prepare_warm(self, app: Application, variant: Variant,
                     server_id: str):
        """A warm backup was planned onto `server_id`: materialize it on
        the backend (no-op for the simulator, where warm means already
        resident; a real background model load on the testbed)."""
        pass

    def replicate(self, app: Application, variant: Variant,
                  server_id: str, on_done: Optional[Callable] = None):
        """Background checkpoint copy onto `server_id`'s disk (no HBM
        residency) — the re-protection loop's proactive re-replication.
        Backends with a ModelRegistry stage the bytes when the transfer
        completes; the base class is a no-op."""
        if on_done is not None:
            on_done(0.0)

    def reset_server(self, server_id: str):
        """Server crashed or rejoined empty: drop its pending load queue."""
        pass


@dataclass
class RecoveryRecord:
    app_id: str
    recovered: bool
    mttr: float = math.inf
    variant: Optional[str] = None
    accuracy: float = 0.0
    mode: str = "none"            # warm | cold | cold-progressive
    upgraded_to: Optional[str] = None
    epoch: int = 0                # failure epoch this record belongs to
    t_fail: float = 0.0
    # MTTR phase decomposition (seconds): detect / plan / queue / fetch /
    # warmup / route, plus the fetch source ("local"|"peer"|"cloud").
    # Filled on recovery when the backend reports a LoadTicket;
    # benchmarks/fig_mttr_breakdown.py aggregates it. NOT part of the
    # scenario fingerprint.
    phases: Dict[str, float] = field(default_factory=dict)
    source: Optional[str] = None


@dataclass
class RoutingTable:
    """Epoch-versioned client routes (the paper's websocket push, §4).

    Every `set`/`drop` bumps `epoch` and fires the corresponding
    observer, so the bump sequence defines exactly which in-flight
    request window a failure blacks out: the traffic plane
    (core/traffic.py) subscribes via `observer`/`drop_observer` to
    timestamp those transitions into per-app serving timelines.
    """
    epoch: int = 0
    routes: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    observer: Optional[Callable[[str, str, str], None]] = None
    drop_observer: Optional[Callable[[str], None]] = None

    def set(self, app_id: str, server_id: str, variant_name: str):
        self.routes[app_id] = (server_id, variant_name)
        self.epoch += 1
        if self.observer is not None:
            self.observer(app_id, server_id, variant_name)

    def drop(self, app_id: str):
        if self.routes.pop(app_id, None) is not None:
            self.epoch += 1
            if self.drop_observer is not None:
                self.drop_observer(app_id)


@dataclass
class _PendingLoad:
    """One queued recovery load awaiting dispatch."""
    prio: tuple                # (stage, not critical, -rate, seq)
    app: Application
    variant: Variant
    server_id: str
    on_ready: Callable[[float], None]
    ticket: object = None          # LoadTicket once dispatched
    t_submit: Optional[float] = None


class RecoveryScheduler:
    """Explicit recovery-drain scheduler in front of the LoadExecutor.

    Progressive failover used to be an ordering convention: loads were
    handed to the executor in whatever order the affected apps were
    discovered, and the executor's per-server FIFO implicitly decided
    who recovered first. This class makes the policy explicit:

      * ``fifo`` — dispatch immediately in submission order; the
        executor's per-link FIFO queues serialize. This is bit-exactly
        the historical behavior (and the default).
      * ``criticality`` — hold a per-target-server drain queue with at
        most ONE in-flight load per server; the queue drains in
        (restore-before-upgrade, critical first, then request-rate)
        order, so a higher-criticality app failing MID-DRAIN preempts
        (jumps ahead of) every queued lower-criticality load, and no
        progressive UPGRADE transfer delays another app's first
        RESTORE transfer. Loads across different servers overlap
        freely; per-link I/O is still serialized by the executor's
        queues.

    Queued loads targeting a server that dies are dropped
    (`reset_server`); the superseding failure epoch re-plans them.
    """

    def __init__(self, executor: LoadExecutor, mode: str = "fifo",
                 alive_fn: Optional[Callable[[str], bool]] = None,
                 clock: Optional[Clock] = None):
        assert mode in SCHEDULERS, mode
        self.executor = executor
        self.mode = mode
        self.alive_fn = alive_fn or (lambda sid: True)
        self.clock = clock         # for drain-wait phase accounting
        self._seq = itertools.count()
        self._queued: Dict[str, List[_PendingLoad]] = {}
        self._inflight: Dict[str, _PendingLoad] = {}
        # resilience-layer hook: ("start"|"end", t) fired when the
        # number of outstanding recovery loads crosses 0<->1, so the
        # traffic plane can admission-control during the drain. None
        # (the default) leaves every submission path bit-identical
        self.drain_observer: Optional[Callable[[str, float], None]] = None
        self._drain_active = 0

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else 0.0

    def _drain_begin(self):
        self._drain_active += 1
        if self._drain_active == 1:
            self.drain_observer("start", self._now())

    def _drain_end(self):
        self._drain_active = max(0, self._drain_active - 1)
        if self._drain_active == 0:
            self.drain_observer("end", self._now())

    def _tracked(self, on_ready: Callable[[float], None]
                 ) -> Callable[[float], None]:
        """Wrap a completion callback with drain accounting — only when
        an observer is installed (zero off-path change)."""
        if self.drain_observer is None:
            return on_ready
        self._drain_begin()

        def wrapped(t_ready: float):
            try:
                on_ready(t_ready)
            finally:
                self._drain_end()

        return wrapped

    def priority(self, app: Application, stage: int = 0) -> tuple:
        return (stage, not app.critical, -app.request_rate,
                next(self._seq))

    def submit(self, app: Application, variant: Variant, server_id: str,
               on_ready: Callable[[float], None], *,
               stage: int = 0) -> _PendingLoad:
        """Enqueue one recovery load; returns its pending handle (the
        handle's `.ticket` holds the executor's LoadTicket once the
        load is dispatched). `stage` 0 = restore (an app comes back
        serving), 1 = progressive upgrade (quality, not availability) —
        upgrades never delay restores in criticality mode."""
        item = _PendingLoad(self.priority(app, stage), app, variant,
                            server_id, self._tracked(on_ready))
        if self.mode == "fifo":
            item.ticket = self.executor.load(app, variant, server_id,
                                             item.on_ready)
            return item
        if self.clock is not None:
            item.t_submit = self.clock.now()
        self._queued.setdefault(server_id, []).append(item)
        if server_id not in self._inflight:
            self._dispatch(server_id)
        return item

    def _dispatch(self, sid: str):
        q = self._queued.get(sid)
        if not q:
            self._queued.pop(sid, None)
            return
        if not self.alive_fn(sid):
            del self._queued[sid]          # superseded by a newer epoch
            return
        q.sort(key=lambda it: it.prio)     # stable: seq breaks ties
        item = q.pop(0)
        if not q:
            del self._queued[sid]
        self._inflight[sid] = item

        def _done(t_ready: float):
            mine = self._inflight.get(sid) is item
            if mine:
                del self._inflight[sid]
            try:
                item.on_ready(t_ready)
            finally:
                if mine:
                    self._dispatch(sid)

        item.ticket = self.executor.load(item.app, item.variant, sid,
                                         _done)
        if (item.ticket is not None and self.clock is not None
                and item.t_submit is not None):
            # time spent held in THIS drain queue is queueing too —
            # fold it into the ticket so phases still sum to MTTR
            item.ticket.queue_s += self.clock.now() - item.t_submit

    def reset_server(self, server_id: str):
        """Server crashed/rejoined: drop its queue and in-flight marker
        (stale completions are ignored via identity checks)."""
        dropped = self._queued.pop(server_id, None)
        self._inflight.pop(server_id, None)
        # queued-but-never-dispatched loads will never fire their
        # (tracked) on_ready — close their drain accounting here. The
        # in-flight load's completion event still fires and closes its
        # own (the executor always invokes on_ready).
        if dropped and self.drain_observer is not None:
            for _ in dropped:
                self._drain_end()

    def idle(self) -> bool:
        """No queued or in-flight recovery loads (fifo mode keeps no
        state here, so it is always 'idle' — the executor's own queues
        carry the work)."""
        return not self._queued and not self._inflight

    @property
    def n_pending(self) -> int:
        return (sum(len(q) for q in self._queued.values())
                + len(self._inflight))


class FailLiteController:
    def __init__(self, cluster: Cluster, clock: Clock,
                 executor: LoadExecutor, *,
                 policy: str = "faillite",
                 alpha: float = 0.1,
                 site_independence: bool = False,
                 use_ilp: bool = False,
                 planner: Optional[str] = None,
                 detector: Optional[FailureDetector] = None,
                 datastore: Optional[DataStore] = None,
                 registry: Optional[ModelRegistry] = None,
                 scheduler: str = "fifo",
                 planner_dtype: str = "float64",
                 planner_backend: str = "torch",
                 planner_device: DeviceLike = None):
        assert policy in POLICIES, policy
        self.cluster = cluster
        self.clock = clock
        self.executor = executor
        # model-state plane: checkpoint residency + fetch-path selection
        # (None = no registry, i.e. the historical local-everything
        # assumption; the execution backends normally provide one)
        self.registry = registry
        # recovery-drain scheduler: "fifo" (historical dispatch order)
        # or "criticality" (priority drain queue with preemption)
        self.scheduler = RecoveryScheduler(
            executor, mode=scheduler,
            alive_fn=lambda sid: (sid in cluster.servers
                                  and cluster.servers[sid].alive),
            clock=clock)
        self.policy = policy
        self.alpha = alpha if policy == "faillite" else 0.0
        self.site_independence = site_independence
        self.use_ilp = use_ilp
        # planner selection by registry name (docs/PLANNER.md); the
        # legacy `use_ilp` flag maps onto the "ilp" planner.
        # the greedy planner's backend: "torch" (the default) or "numpy";
        # the torch backend runs on the card unless the caller asks for
        # "cpu" (the port's device rule)
        self.planner_backend = planner_backend
        self.planner_device = planner_device
        self.planner = self._resolve_planner(
            planner or ("ilp" if use_ilp else "greedy"))
        # the failover hot path (§3.3, MTTR-critical) always runs a
        # realtime planner; non-realtime ones (ilp) plan proactively only
        self.fast_planner = (self.planner if self.planner.realtime
                             else self._resolve_planner("greedy"))
        # persistent array-backed capacity view; Cluster notifies it of
        # per-server deltas, so planning never rebuilds a view per call
        self.state = PlannerState(cluster, dtype=planner_dtype)
        if registry is not None:
            self.state.attach_registry(registry)
        self.plan_wall_s = 0.0       # cumulative planner time (all calls)
        self._last_plan_wall = 0.0   # wall of the latest planning round
        self._replicating: Set[tuple] = set()   # (variant, target) in flight
        self.detector = detector or FailureDetector(clock)
        self.ds = datastore or DataStore()
        self.apps: Dict[str, Application] = {}
        self.primaries: Dict[str, str] = {}
        self.warm: Dict[str, Tuple[Variant, str, str]] = {}  # app->(v,srv,key)
        # incremental warm-gap tracking (docs/SCALE.md): candidate apps
        # currently lacking a warm backup, maintained at every warm
        # mutation so `replan_lost_backups` never scans all 100k apps.
        # `_reg_seq` records deploy order, because the historical full
        # scan iterated the apps dict in insertion order and baseline
        # placement (`_fullsize_assign`) is order-dependent.
        self._warm_missing: Set[str] = set()
        self._reg_seq: Dict[str, int] = {}
        self._reg_counter = itertools.count()
        # bumped on every warm-set mutation; observers (the simulator's
        # warm-bytes trend sample) cache their fold against it instead
        # of re-summing 100k warm entries per sweep
        self.warm_gen = 0
        # cluster mutation counter backing the futile-replan memo: a
        # reprotect plan over an unchanged cluster and unchanged app
        # list is deterministic, so a sweep that placed nothing is
        # skipped verbatim until something actually moves
        self.cluster_gen = 0
        cluster.subscribe(self._bump_cluster_gen)
        self._futile_replan = None
        self._futile_retry = None
        self.routing = RoutingTable()
        # `records` keeps the LATEST record per app (legacy view);
        # `epoch_records[k]` holds the records of failure epoch k, so
        # repeated `handle_failures` calls in one run stay distinguishable.
        self.records: Dict[str, RecoveryRecord] = {}
        self.epoch_records: List[Dict[str, RecoveryRecord]] = []
        self.cold_protected: Set[str] = set()   # warm evicted -> cold only
        # apps currently down: app_id -> (t_fail, epoch idx) awaiting the
        # re-protection loop to find capacity (e.g. after a rejoin)
        self._unrecovered: Dict[str, Tuple[float, int]] = {}
        # per-app recovery generation; bumping it invalidates callbacks of
        # loads scheduled before a newer failure/departure superseded them
        self._gen: Dict[str, int] = {}

    @property
    def epoch(self) -> int:
        """Number of failure epochs handled so far."""
        return len(self.epoch_records)

    def _bump(self, app_id: str) -> int:
        self._gen[app_id] = self._gen.get(app_id, 0) + 1
        return self._gen[app_id]

    # -- warm-gap bookkeeping ----------------------------------------------
    def _is_warm_candidate(self, app: Application) -> bool:
        """Static warm-candidate rule per policy."""
        if self.policy == "full-warm":
            return True
        if self.policy == "full-cold":
            return False
        return app.critical

    def _warm_set(self, app_id: str, variant: Variant, sid: str, key: str):
        """All warm-backup grants flow through here so `_warm_missing`
        stays exact."""
        self.warm[app_id] = (variant, sid, key)
        self.warm_gen += 1
        self._warm_missing.discard(app_id)

    def _warm_del(self, app_id: str):
        """All warm-backup losses flow through here: a still-present
        candidate app immediately becomes a replan target."""
        if self.warm.pop(app_id, None) is not None:
            self.warm_gen += 1
        app = self.apps.get(app_id)
        if app is not None and self._is_warm_candidate(app):
            self._warm_missing.add(app_id)

    # ------------------------------------------------------------------
    # Step 1: arrival + proactive failover
    # ------------------------------------------------------------------
    def deploy_primary(self, app: Application,
                       server_id: Optional[str] = None) -> str:
        """Worst-fit primary placement of the full model (paper §5.1)."""
        if server_id is None:
            server_id = self.state.worst_fit(app.full.demand_vec)
            if server_id is None:
                raise ValueError(f"no capacity for primary of {app.id}")
        self.cluster.place(app.id, app.full, server_id, "primary")
        # register only after placement succeeded: a rejected arrival
        # must not leak into controller state
        self.apps[app.id] = app
        self._reg_seq[app.id] = next(self._reg_counter)
        if self._is_warm_candidate(app):
            self._warm_missing.add(app.id)
        if self.registry is not None:
            # seed the app's checkpoint replicas (primary disk + spread)
            self.registry.ensure_app(app, server_id)
        self.primaries[app.id] = server_id
        self.routing.set(app.id, server_id, app.full.name)
        self.ds.put(f"primary/{app.id}", {"server": server_id,
                                          "variant": app.full.name})
        return server_id

    def _warm_candidates(self) -> List[Application]:
        if self.policy in ("faillite", "full-warm-k"):
            return [a for a in self.apps.values() if a.critical]
        if self.policy == "full-warm":
            crit = [a for a in self.apps.values() if a.critical]
            rest = [a for a in self.apps.values() if not a.critical]
            return crit + rest
        return []                  # full-cold

    def plan_warm_backups(self) -> Dict[str, Tuple[Variant, str]]:
        """Proactive step: the configured planner (ILP or a greedy
        policy) for FailLite; full-size placement for the baselines."""
        cands = self._warm_candidates()
        if not cands:
            return {}
        if self.policy == "faillite":
            assignment = self._plan(cands, alpha=self.alpha,
                                    proactive=True)
        else:
            assignment = self._fullsize_assign(cands)

        for app_id, (variant, sid) in assignment.items():
            key = self.cluster.place(app_id, variant, sid, "warm")
            self._warm_set(app_id, variant, sid, key)
            self.executor.prepare_warm(self.apps[app_id], variant, sid)
            self.ds.put(f"warm/{app_id}", {"server": sid,
                                           "variant": variant.name})
        # Re-derive the rows this proactive round just dirtied while we
        # are still in proactive time: sync() is idempotent and runs at
        # the start of every plan anyway, so paying it here keeps a big
        # warm-placement round's dirt out of the first failover round's
        # MTTR-critical plan wall.
        if assignment:
            self.state.sync()
        return assignment

    def _resolve_planner(self, name: str):
        """Instantiate a registered planner, forwarding the backend and
        device to the greedy planner."""
        kwargs = {}
        if name == "greedy":
            kwargs = {"backend": self.planner_backend,
                      "device": self.planner_device}
        return get_planner(name, **kwargs)

    def planner_stats(self) -> dict:
        """Observability snapshot of the planner configuration and the
        per-instance counters the greedy-family policies maintain
        (backend routing, dense fallbacks) — surfaced in
        `RunResult.extras["planner"]`."""
        out = {"name": self.planner.name,
               "backend": self.planner_backend}
        skip = ("name", "backend")
        for planner in {id(self.planner): self.planner,
                        id(self.fast_planner): self.fast_planner}.values():
            for k, v in getattr(planner, "stats", {}).items():
                if k not in skip and isinstance(v, int):
                    out[k] = out.get(k, 0) + v
        return out

    def _plan(self, cands, *, alpha=0.0, proactive=False):
        """One planner round over `cands` against the persistent state.

        Proactive rounds (warm-backup planning) may use a non-realtime
        planner; the failover hot path always gets a realtime one."""
        planner = self.planner if proactive else self.fast_planner
        res = planner.plan(PlanRequest(
            apps=cands, cluster=self.cluster, state=self.state,
            primaries=self.primaries, alpha=alpha,
            site_independence=self.site_independence,
            now=self.clock.now()))
        self._last_plan_wall = getattr(res, "wall_s", 0.0)
        self.plan_wall_s += self._last_plan_wall
        return res.assignment

    def _fullsize_assign(self, cands):
        """Baselines: only the full-size variant, greedy worst-fit."""
        view = self.state.scratch()
        out = {}
        for app in cands:
            excl = {self.primaries.get(app.id)} - {None}
            if self.site_independence and self.primaries.get(app.id):
                p_site = self.cluster.servers[self.primaries[app.id]].site
                excl |= set(self.cluster.sites.get(p_site, ()))
            sid = view.worst_fit(app.full.demand_vec, excl)
            if sid is not None:
                view.take(sid, app.full.demand_vec)
                out[app.id] = (app.full, sid)
        return out

    # ------------------------------------------------------------------
    # Step 2: failure handling (progressive failover)
    # ------------------------------------------------------------------
    def handle_failures(self, failed_servers: List[str],
                        t_fail: float,
                        lost: Optional[List[Instance]] = None,
                        ) -> Dict[str, RecoveryRecord]:
        """Called when the detector declares servers failed.

        Re-entrant: may run any number of times per controller lifetime
        (cascades, rolling failures, flaky nodes). Each call opens a new
        failure *epoch*; its records land in `epoch_records[-1]`.
        Servers already dead are ignored, in-flight recovery loads onto a
        newly-failed server are invalidated and re-planned, and warm
        bookkeeping is reconciled against the surviving cluster state.

        `lost` lets the caller pass the instances that died when the
        crash actually happened (the simulator applies the physical
        failure at t_fail and detection fires ~65ms later — the server
        may even have rejoined inside that window); when omitted, the
        physical failure is applied now.
        """
        t_detect = self.clock.now()
        epoch = len(self.epoch_records)
        if lost is None:
            failed_set = {sid for sid in failed_servers
                          if self.cluster.servers[sid].alive}
            lost = []
            for sid in failed_set:
                lost.extend(self.cluster.fail_server(sid))
                self.detector.mark_failed(sid)
                self.executor.reset_server(sid)
        else:
            # crash already applied; only servers still down count for
            # the warm-backup reconciliation below
            failed_set = {sid for sid in failed_servers
                          if not self.cluster.servers[sid].alive}
        for sid in failed_set:
            # queued recovery loads onto a dead server are void; their
            # apps are re-planned by this epoch or the reprotect loop
            self.scheduler.reset_server(sid)

        records: Dict[str, RecoveryRecord] = {}

        # Apps hit by this epoch: lost their serving primary OR an
        # in-flight recovery load (role "loading" from a prior epoch).
        affected_ids: List[str] = []
        for inst in lost:
            if (inst.role in ("primary", "loading")
                    and inst.app_id in self.apps
                    and inst.app_id not in affected_ids):
                affected_ids.append(inst.app_id)
        affected = [self.apps[a] for a in affected_ids]
        for app in affected:
            self._bump(app.id)           # invalidate stale load callbacks
            self.primaries.pop(app.id, None)
            self._unrecovered.pop(app.id, None)   # superseded by new epoch
        # warm backups that died with their server are gone; also drop any
        # entry whose instance vanished from the cluster out-of-band
        for app_id, (v, sid, key) in list(self.warm.items()):
            if (sid in failed_set
                    or key not in self.cluster.servers[sid].instances):
                self._warm_del(app_id)
                self.ds.delete(f"warm/{app_id}")

        # (a) warm switch for apps that still have a live warm backup
        cold_apps: List[Application] = []
        for app in affected:
            warm = self.warm.get(app.id)
            if warm is not None:
                v, sid, key = warm
                self.executor.activate(app, v, sid)
                self.cluster.servers[sid].instances[key].role = "primary"
                self.primaries[app.id] = sid
                self._warm_del(app.id)
                self.routing.set(app.id, sid, v.name)
                mttr = (t_detect - t_fail) + NOTIFY_OVERHEAD_S
                rec = RecoveryRecord(
                    app.id, True, mttr, v.name, v.accuracy, "warm")
                rec.phases = {"detect": t_detect - t_fail,
                              "route": NOTIFY_OVERHEAD_S}
                records[app.id] = rec
            else:
                cold_apps.append(app)

        # (b) progressive failover for the rest
        if cold_apps:
            records.update(self._progressive(cold_apps, t_fail, t_detect))
        for app_id, rec in records.items():
            rec.epoch = epoch
            rec.t_fail = t_fail
        self.epoch_records.append(records)
        self.records.update(records)
        return records

    def _commit(self, assignment) -> Dict[str, str]:
        """Reserve capacity for the selected variants NOW so later
        planning rounds see a consistent cluster state."""
        keys = {}
        for app_id, (v_sel, sid) in assignment.items():
            try:
                keys[app_id] = self.cluster.place(app_id, v_sel, sid,
                                                  "loading", ready=False)
            except ValueError:
                pass            # stays un-reserved -> reported unrecovered
        return keys

    def _progressive(self, apps: List[Application], t_fail: float,
                     t_detect: float) -> Dict[str, RecoveryRecord]:
        if self.policy == "faillite":
            assignment = self._plan(apps)
            keys = self._commit(assignment)
            missing = [a for a in apps if a.id not in keys]
            if missing:
                # Beyond-paper: warm-backup reclamation. Under widespread
                # (site-scale) failures the surviving warm replicas of
                # *unaffected* apps strand the capacity the affected apps
                # need; evict the lowest-value warm backups and retry.
                extra = self._reclaim_and_assign(missing)
                keys.update(self._commit(extra))
                assignment.update(extra)
        else:
            # baselines: K-critical first, then the rest, full-size only
            order = sorted(apps, key=lambda a: not a.critical)
            assignment = self._fullsize_assign(order)
            keys = self._commit(assignment)

        records = {}
        for app in apps:
            if app.id not in keys:
                records[app.id] = RecoveryRecord(app.id, False)
                # nothing committed: app stays down until the continuous
                # re-protection loop finds capacity (e.g. after a rejoin)
                self._unrecovered[app.id] = (t_fail,
                                             len(self.epoch_records))
                continue
            v_sel, sid = assignment[app.id]
            records[app.id] = self._progressive_load(
                app, v_sel, sid, t_fail, t_detect, key_sel=keys[app.id])
        return records

    def _reclaim_and_assign(self, missing: List[Application]):
        """Evict warm backups (lowest request-rate first) until the
        missing apps place; evicted apps keep cold protection."""
        evictable = sorted(
            self.warm.items(),
            key=lambda kv: self.apps[kv[0]].request_rate
            if kv[0] in self.apps else 0.0)
        i, batch = 0, 1
        while i < len(evictable):
            for app_id, (v, sid, key) in evictable[i:i + batch]:
                self.cluster.remove(key, sid)
                self._warm_del(app_id)
                self.ds.delete(f"warm/{app_id}")
                # demoted, not abandoned: the model artifact stays on
                # disk, so the app keeps cold (progressive) protection
                self.cold_protected.add(app_id)
                self.ds.put(f"cold/{app_id}", {"variant": v.name,
                                               "reason": "reclaimed"})
            i += batch
            batch *= 2          # exponential batching keeps this O(log n)
            assignment = self._plan(missing)
            if len(assignment) == len(missing):
                return assignment
        # one final, internally-consistent assignment (placements from
        # intermediate probes are never committed, so no double-booking)
        return self._plan(missing)

    def _progressive_load(self, app: Application, v_sel: Variant,
                          sid: str, t_fail: float, t_detect: float,
                          key_sel: Optional[str] = None) -> RecoveryRecord:
        rec = RecoveryRecord(app.id, False)
        progressive = (self.policy == "faillite"
                       and app.smallest.name != v_sel.name
                       and app.smallest.mem_bytes < v_sel.mem_bytes)
        first = app.smallest if progressive else v_sel

        if key_sel is None:
            # reserve the selected variant's demand (placement decision)
            try:
                key_sel = self.cluster.place(app.id, v_sel, sid, "loading",
                                             ready=False)
            except ValueError:
                # capacity raced away; report honestly
                self._unrecovered[app.id] = (t_fail,
                                             len(self.epoch_records))
                return rec

        # Loads scheduled now are void if a later epoch kills the target
        # server (gen bumped) or the app departs; callbacks check both.
        gen = self._gen.get(app.id, 0)
        plan_s = self._last_plan_wall

        def _stale() -> bool:
            return (self._gen.get(app.id, 0) != gen
                    or app.id not in self.apps
                    or not self.cluster.servers[sid].alive)

        def on_first_ready(t_ready: float):
            if _stale():
                return
            self.primaries[app.id] = sid
            self.routing.set(app.id, sid, first.name)
            rec.recovered = True
            rec.mttr = (t_detect - t_fail) + (t_ready - t_detect) \
                + NOTIFY_OVERHEAD_S
            rec.variant = first.name
            rec.accuracy = first.accuracy
            rec.mode = "cold-progressive" if progressive else "cold"
            rec.phases = {"detect": t_detect - t_fail, "plan": plan_s,
                          "route": NOTIFY_OVERHEAD_S}
            ticket = handle.ticket
            if ticket is not None:
                rec.source = ticket.source
                rec.phases.update(queue=ticket.queue_s,
                                  fetch=ticket.fetch_s,
                                  warmup=ticket.warmup_s)
            if not progressive:
                inst = self.cluster.servers[sid].instances.get(key_sel)
                if inst is not None:
                    inst.role = "primary"
                    inst.ready = True
            self.ds.put(f"primary/{app.id}", {"server": sid,
                                              "variant": first.name})

        def on_selected_ready(t_ready: float):
            if _stale():
                return
            inst = self.cluster.servers[sid].instances.get(key_sel)
            if inst is not None:
                inst.role = "primary"
                inst.ready = True
            self.routing.set(app.id, sid, v_sel.name)
            rec.variant = v_sel.name
            rec.accuracy = v_sel.accuracy
            rec.upgraded_to = v_sel.name

        handle = self.scheduler.submit(app, first, sid, on_first_ready)
        if progressive:
            self.scheduler.submit(app, v_sel, sid, on_selected_ready,
                                  stage=1)
        return rec

    # ------------------------------------------------------------------
    # Membership events (scenario engine)
    # ------------------------------------------------------------------
    def handle_rejoin(self, server_id: str):
        """A failed server rejoins EMPTY: reconcile detector/executor
        state and scrub stale references; the re-protection loop refills
        the returned capacity with warm backups / retried recoveries."""
        srv = self.cluster.servers[server_id]
        if srv.alive:
            return
        self.cluster.revive_server(server_id)
        self.detector.revive(server_id)
        self.executor.reset_server(server_id)
        self.scheduler.reset_server(server_id)
        # defensive scrub: nothing should still point at a node that was
        # down, but repeated epochs make invariants worth re-asserting
        for app_id in [a for a, s in self.primaries.items()
                       if s == server_id]:
            self._bump(app_id)
            del self.primaries[app_id]
        for app_id in [a for a, (_, s, _) in self.warm.items()
                       if s == server_id]:
            self._warm_del(app_id)
            self.ds.delete(f"warm/{app_id}")

    def handle_departure(self, app_id: str):
        """App leaves: release every replica and forget its bookkeeping."""
        self._bump(app_id)
        app = self.apps.pop(app_id, None)
        if self.registry is not None and app is not None:
            # arch-mix siblings share variant names: keep checkpoints
            # any surviving app still depends on
            in_use = {v.name for a in self.apps.values()
                      for v in a.variants}
            self.registry.forget_app(app, in_use=in_use)
        self.cluster.remove_app(app_id)
        self.primaries.pop(app_id, None)
        if self.warm.pop(app_id, None) is not None:
            self.warm_gen += 1
        self._warm_missing.discard(app_id)
        self._reg_seq.pop(app_id, None)
        self._unrecovered.pop(app_id, None)
        self.cold_protected.discard(app_id)
        self.routing.drop(app_id)
        self.ds.delete(f"primary/{app_id}")
        self.ds.delete(f"warm/{app_id}")
        self.ds.delete(f"cold/{app_id}")

    # ------------------------------------------------------------------
    # Continuous re-protection (beyond-paper): a periodic loop, driven by
    # the simulator's event queue, that (1) retries progressive recovery
    # for apps still down from earlier epochs and (2) re-plans warm
    # backups lost to failures/evictions — so protection converges back
    # after every churn/failure/rejoin event.
    # ------------------------------------------------------------------
    def reprotect(self) -> Dict[str, int]:
        retried = self._retry_unrecovered()
        replanned = self.replan_lost_backups()
        replicated = self._replicate_underprotected()
        return {"retried": retried, "replanned": len(replanned),
                "replicated": replicated}

    def _replicate_underprotected(self, max_per_round: int = 2) -> int:
        """Idle-round proactive checkpoint re-replication: when the
        recovery drain queue is empty, copy the progressive-entry
        (smallest) variant of under-replicated apps onto fresh disks,
        critical/high-rate apps first — so the NEXT failure finds a
        nearby copy instead of paying the cloud uplink. A no-op under
        the default local-everything storage. "Idle" means no app is
        still awaiting recovery, the drain queue is empty, AND the
        executor reports no in-flight work (fifo mode keeps no
        scheduler state, so the executor's own view catches loads
        still streaming) — replication bytes must never delay recovery
        bytes on a shared link."""
        if (self.registry is None or self.registry.storage.replicate_all
                or self._unrecovered or not self.scheduler.idle()
                or not getattr(self.executor, "idle", lambda: True)()):
            return 0
        cands = sorted(self.apps.values(),
                       key=lambda a: (not a.critical, -a.request_rate,
                                      a.id))
        n = 0
        for app, v, _copies in self.registry.under_replicated(cands):
            if any(k[0] == v.name for k in self._replicating):
                continue                     # a copy is already in flight
            target = self.registry.replication_target(v.name)
            if target is None:
                continue
            key = (v.name, target)
            self._replicating.add(key)

            def _done(_t, key=key):
                self._replicating.discard(key)

            self.executor.replicate(app, v, target, _done)
            n += 1
            if n >= max_per_round:
                break
        return n

    def _bump_cluster_gen(self, _server_id: str) -> None:
        self.cluster_gen += 1

    def _retry_unrecovered(self) -> int:
        down = [(aid, tf, ep) for aid, (tf, ep) in self._unrecovered.items()
                if aid in self.apps]
        if not down:
            return 0
        # same apps against an unmoved cluster replays the exact plan
        # that already failed to place anything — skip it (bit-exact:
        # planning is deterministic in (apps, cluster) and a futile
        # plan mutates nothing)
        memo = (tuple(aid for aid, _, _ in down), self.cluster_gen)
        if memo == self._futile_retry:
            return 0
        apps = [self.apps[aid] for aid, _, _ in down]
        if self.policy == "faillite":
            assignment = self._plan(apps)
        else:
            assignment = self._fullsize_assign(apps)
        keys = self._commit(assignment)
        now = self.clock.now()
        n = 0
        for aid, t_fail, ep in down:
            if aid not in keys:
                continue
            del self._unrecovered[aid]
            self._bump(aid)
            v_sel, sid = assignment[aid]
            # MTTR keeps the ORIGINAL failure time: the outage lasted
            # from the first loss until this late recovery completes.
            rec = self._progressive_load(self.apps[aid], v_sel, sid,
                                         t_fail, now, key_sel=keys[aid])
            rec.epoch = ep
            rec.t_fail = t_fail
            if ep < len(self.epoch_records):
                self.epoch_records[ep][aid] = rec
            self.records[aid] = rec
            n += 1
        self._futile_retry = memo if not keys else None
        return n

    def _warm_gap_candidates(self) -> List[Application]:
        """Candidate apps lacking a warm backup, in the exact order the
        historical full scan over `_warm_candidates()` produced them.

        The incremental `_warm_missing` set makes this O(gap) instead of
        O(apps) per sweep — the difference between a sub-second and a
        minutes-long reprotect tick at 100k apps."""
        if self.policy == "full-cold":
            return []
        apps = []
        for aid in list(self._warm_missing):
            app = self.apps.get(aid)
            if app is None:
                self._warm_missing.discard(aid)     # departed; lazily GC
            elif aid not in self.warm:
                apps.append(app)
        # historical order: the apps dict iterates in deploy order, and
        # full-warm scanned criticals first then the rest
        if self.policy == "full-warm":
            apps.sort(key=lambda a: (not a.critical, self._reg_seq[a.id]))
        else:
            apps.sort(key=lambda a: self._reg_seq[a.id])
        return apps

    def replan_lost_backups(self):
        """Apps whose warm backup died get a new one planned from the
        remaining capacity. Idempotent; safe to call every sweep."""
        missing = [a for a in self._warm_gap_candidates()
                   if self.primaries.get(a.id) in self.cluster.servers
                   and self.cluster.servers[self.primaries[a.id]].alive]
        if not missing:
            return {}
        # futile-replan memo: identical gap list + unmoved cluster =
        # the same deterministic plan that placed nothing last sweep
        memo = (tuple(a.id for a in missing), self.cluster_gen)
        if memo == self._futile_replan:
            return {}
        assignment = (self._plan(missing, alpha=self.alpha)
                      if self.policy == "faillite"
                      else self._fullsize_assign(missing))
        placed = {}
        for app_id, (variant, sid) in assignment.items():
            try:
                key = self.cluster.place(app_id, variant, sid, "warm")
            except ValueError:
                continue           # capacity raced away; retry next sweep
            self._warm_set(app_id, variant, sid, key)
            self.cold_protected.discard(app_id)
            self.executor.prepare_warm(self.apps[app_id], variant, sid)
            self.ds.put(f"warm/{app_id}", {"server": sid,
                                           "variant": variant.name})
            placed[app_id] = (variant, sid)
        self._futile_replan = memo if not placed else None
        # same rationale as plan_warm_backups: eager resync keeps the
        # repair round's dirt off the next failover plan wall
        if placed:
            self.state.sync()
        return placed

    @property
    def has_unrecovered(self) -> bool:
        """Apps still down, awaiting the re-protection loop."""
        return bool(self._unrecovered)

    # -- metrics -----------------------------------------------------------
    def flat_records(self) -> List[RecoveryRecord]:
        """Every epoch's records, flattened in epoch order."""
        return [r for ep in self.epoch_records for r in ep.values()]

    def overall_summary(self) -> Dict[str, float]:
        """Summary over ALL epoch records (not just the latest per app)."""
        flat = self.flat_records()
        return self.summarize({i: r for i, r in enumerate(flat)})

    def warm_coverage(self) -> float:
        """Fraction of critical apps (with a live primary) that hold a
        warm backup right now — the end-of-run protection view shared by
        both execution backends."""
        crit = [a for a in self.apps.values() if a.critical
                and self.primaries.get(a.id) in self.cluster.servers
                and self.cluster.servers[self.primaries[a.id]].alive]
        return (sum(1 for a in crit if a.id in self.warm) / len(crit)
                if crit else 1.0)

    def summarize(self, records=None) -> Dict[str, float]:
        recs = list((records or self.records).values())
        if not recs:
            return {"recovery_rate": 1.0, "mttr_avg": 0.0,
                    "accuracy_reduction": 0.0, "n": 0}
        recovered = [r for r in recs if r.recovered]
        rate = len(recovered) / len(recs)
        mttr = (sum(r.mttr for r in recovered) / len(recovered)
                if recovered else math.inf)
        acc_red = (sum(1.0 - r.accuracy for r in recovered)
                   / len(recovered) if recovered else 0.0)
        return {"recovery_rate": rate, "mttr_avg": mttr,
                "accuracy_reduction": acc_red, "n": len(recs)}

    def summarize_epochs(self) -> List[Dict[str, float]]:
        """One summary dict per failure epoch, in injection order."""
        return [self.summarize(recs) for recs in self.epoch_records]
