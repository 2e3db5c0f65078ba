"""Thread-based mini-testbed (port of ``repro/serving/testbed.py``): the
paper's edge testbed, its worker cells sharing one CUDA card (or the CPU,
when asked for).

Real components everywhere the paper's testbed had them:
  * WorkerServer threads host PyTorch engines, whose attention runs the
    port's CUDA kernels on the card, and send real heartbeats
  * failure injection kills the worker (heartbeats stop mid-flight)
  * the FailureDetector declares failure after 2 missed beats
  * the controller runs the two-step failover, planning on the card with
    the greedy planner's torch backend by default; cold loads really
    draw params and warm the engine (their wall-clock duration is the
    measured load time, Fig. 2b analogue)
  * clients measure end-to-end downtime around the failure

This is the live execution engine behind the `testbed` backend of
`repro_torch.experiment`: `run_scenario()` replays the SAME `ScenarioEvent`
stream the simulator replays — `ServerFail`/`SiteFail`/`ServerRejoin`/
`AppArrival`/`AppDeparture`/`LoadSpike` — against worker threads on a
wall clock. Controller route changes reach the serving `Router` and the
request-level telemetry through the first-class `RoutingTable`
observer/drop_observer hooks (no monkey-patching), and the real request
outcomes measured by the client threads are folded through the same
`core.metrics.aggregate` code the simulator's traffic plane uses, so
client-observed MTTR/availability/goodput mean the same thing on both
backends.

Model ladders use the reduced smoke configs (`apps=` takes any ladder
with real configs, such as full-width ones); capacities come from the
shared arch-mix sizing rule (`repro_torch.experiment.workload`), which is
what lets the simulator run the exact same workload on the exact same
cluster shape for cross-backend parity experiments.

Departures from the JAX testbed:
  * a load fails as "server died" only on `WorkerDown`; every other
    exception of a load, a warm preparation, a decode step on a worker
    thread or a client's submit is printed and kept in `errors`, and
    `run_scenario` returns them as `load_errors` (the JAX testbed treats
    any RuntimeError as a dead server, and in PyTorch a failed kernel
    build or launch and an out-of-memory error are RuntimeErrors);
  * the shard plane (`tp_degree > 1`, `serving/shard.py`) catches
    nothing: its background work (a group's build on arrival, a degraded
    rebuild, a repartition) runs through `TestbedExecutor._spawn`, which
    drops `WorkerDown` and reports every other exception in `errors`
    (the JAX shard plane drops every RuntimeError);
  * `planner_coordinators` reaches the controller (the sharded numpy
    planner's site-slice coordinators; the same bits either way).
"""

from __future__ import annotations

import math
import random
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import trace
from repro_torch.core.cluster import Cluster, Server
from repro_torch.core.controller import (FailLiteController, LoadExecutor,
                                         RecoveryRecord)
from repro_torch.core.heartbeat import FailureDetector, WallClock
from repro_torch.core.metrics import (AppLog, DowntimeWindow,
                                      TrafficSummary, aggregate)
from repro_torch.core.modelstate import (LOCAL, LinkScale, LoadTicket,
                                         ModelRegistry, storage_preset)
from repro_torch.core.resilience import (Bulkhead, CircuitBreaker,
                                         RetryBudget, hedged_call)
from repro_torch.core.resilience import active as resilience_active
from repro_torch.core.scenario import (AppArrival, AppDeparture,
                                       LinkDegrade, LoadSpike, Scenario,
                                       ServerFail, ServerRejoin, ShardFail,
                                       SiteFail)
from repro_torch.core.variants import Application
from repro_torch.experiment.workload import (ARCH_COMPUTE_CAP,
                                             TESTBED_ARCHS, arch_mem_cap,
                                             build_arch_apps, testbed_ladder)
from repro_torch.serving.router import Router
from repro_torch.serving.server import WorkerDown, WorkerServer
from repro_torch.serving.shard import TestbedShardManager
from repro_torch.serving.workload import make_request

DETECT_POLL_S = 0.02          # sweeper poll (controller sweep, §5.1)
REPROTECT_EVERY_S = 1.0       # continuous re-protection loop period


class TestbedExecutor(LoadExecutor):
    """Executes controller load orders on real worker threads.

    Loads are serialized per server (one PCIe/disk channel per cell, as
    on the paper's testbed) and ordered: the progressive small-first load
    completes before the selected-variant load starts. Controller
    callbacks run under the testbed's controller lock, AFTER the server
    channel is released (lock-ordering: never hold a server channel
    while waiting for the controller).
    """

    def __init__(self, workers: Dict[str, WorkerServer], router: Router,
                 ctl_lock: threading.RLock,
                 registry: Optional[ModelRegistry] = None,
                 errors: Optional[List[str]] = None):
        self.workers = workers
        self.router = router
        self.ctl_lock = ctl_lock
        # model-state plane: fetch-path selection + load-cost
        # calibration. Every REAL load's wall time is observed into the
        # registry's LoadCostModel (the Fig. 2b feedback loop), and
        # non-local fetch paths pay an emulated transfer sleep priced by
        # the same model the simulator uses.
        self.registry = registry
        # what failed other than a dead server: one line per exception
        self.errors: List[str] = errors if errors is not None else []
        # testbed shard plane (serving/shard.py): slice loads are
        # re-materialized partitions, not whole-model loads
        self.shard_plane = None
        self._scales = LinkScale()                 # LinkDegrade windows
        self._locks: Dict[str, threading.Lock] = {
            sid: threading.Lock() for sid in workers}
        self._threads: List[threading.Thread] = []
        self._outstanding = 0
        self._n_lock = threading.Lock()

    def _spawn(self, fn, what: str) -> None:
        """Run `fn` on a new thread. A `WorkerDown` from it means a server
        died under the work; any other exception is reported as `what`."""
        with self._n_lock:
            self._outstanding += 1

        def run():
            try:
                fn()
            except WorkerDown:
                pass
            except Exception:             # noqa: BLE001
                self.record_error(what)
            finally:
                with self._n_lock:
                    self._outstanding -= 1

        t = threading.Thread(target=run, daemon=True)
        self._threads.append(t)
        t.start()

    def idle(self) -> bool:
        with self._n_lock:
            return self._outstanding == 0

    def record_error(self, what: str) -> None:
        """Print the exception being handled and keep one line of it."""
        traceback.print_exc()
        self.errors.append(f"{what}: {traceback.format_exc(limit=0).strip()}")

    def degrade_link(self, link: str, factor: float, duration: float):
        """LinkDegrade analogue: scale the emulated fetch sleeps that
        touch `link` for `duration` wall seconds."""
        t = threading.Timer(duration, self._scales.degrade(link, factor))
        t.daemon = True
        t.start()

    def _fetch_sleep(self, variant, server_id) -> tuple:
        """(sleep_s, source): the emulated byte-transfer cost of a
        non-local fetch path — zero for a local disk hit (the real
        compile IS the local load cost on this testbed)."""
        if self.registry is None:
            return 0.0, LOCAL
        plan = self.registry.fetch_plan(variant.name, server_id)
        if plan.source == LOCAL or not math.isfinite(plan.bw):
            return 0.0, plan.source
        scale = self._scales.min_over(plan.links)
        return variant.mem_bytes / (plan.bw * scale), plan.source

    def load(self, app, variant, server_id, on_ready) -> LoadTicket:
        ticket = LoadTicket()

        def work():
            with trace.span("load", kind="cold", variant=variant.name,
                            server=server_id) if trace.ON else trace.OFF:
                t0 = time.monotonic()       # before the lock: queue_s
                self._take_channel(server_id)  # includes the channel wait
                try:
                    sleep_s, source = self._fetch_sleep(variant, server_id)
                    if sleep_s > 0:
                        with trace.span("load.fetch") if trace.ON \
                                else trace.OFF:
                            time.sleep(sleep_s)
                    if (self.shard_plane is not None
                            and self.shard_plane.is_slice(variant.name)):
                        wall = self.shard_plane.materialize_slice(
                            app, variant, server_id)
                    else:
                        wall = self.workers[server_id].load(app, variant)
                    ticket.source = source
                    ticket.fetch_s = sleep_s
                    ticket.warmup_s = wall
                    ticket.queue_s = time.monotonic() - t0 - sleep_s - wall
                    ticket.done = True
                    if self.registry is not None:
                        # Fig. 2b feedback: the measured wall time
                        # calibrates the shared load-cost model
                        self.registry.calibration.observe(
                            variant, source, sleep_s + wall)
                        self.registry.stage(variant.name, server_id)
                finally:
                    self._locks[server_id].release()
            with self.ctl_lock:
                on_ready(time.monotonic())
        self._spawn(work, f"load {variant.name} on {server_id}")
        return ticket

    def _take_channel(self, server_id: str) -> None:
        """Acquire the server's load channel; with the tracer on, the wait
        is a ``load.queue`` span."""
        if not trace.ON:
            self._locks[server_id].acquire()
            return
        with trace.span("load.queue"):
            self._locks[server_id].acquire()

    def activate(self, app, variant, server_id):
        w = self.workers[server_id]
        if not w.has(variant.name):        # warm = pre-loaded at plan time
            w.load(app, variant)

    def prepare_warm(self, app, variant, server_id):
        """Warm backup planned: load it in the background so a later
        `activate` finds the engine resident."""
        def work():
            with trace.span("load", kind="warm", variant=variant.name,
                            server=server_id) if trace.ON else trace.OFF:
                self._take_channel(server_id)
                try:
                    if not self.workers[server_id].has(variant.name):
                        self.workers[server_id].load(app, variant)
                finally:
                    self._locks[server_id].release()
            if self.registry is not None:
                self.registry.stage(variant.name, server_id)
        self._spawn(work, f"warm {variant.name} on {server_id}")

    def replicate(self, app, variant, server_id, on_done=None):
        """Background checkpoint copy: pay the emulated transfer, then
        stage the bytes on the worker's cold store + the registry."""
        def work():
            sleep_s, _source = self._fetch_sleep(variant, server_id)
            if sleep_s > 0:
                time.sleep(sleep_s)
            w = self.workers.get(server_id)
            if w is not None:
                w.stage_cold(app, variant)
            if self.registry is not None:
                self.registry.stage(variant.name, server_id)
            if on_done is not None:
                with self.ctl_lock:
                    on_done(time.monotonic())
        self._spawn(work, f"replicate {variant.name} to {server_id}")

    def join(self, timeout: float = 15.0):
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))


@dataclass
class ClientStats:
    """Per-app client-side counters (compat view; the authoritative
    request-level metrics are the shared `TrafficSummary`)."""
    app_id: str
    ok: int = 0
    failed: int = 0
    last_ok: Optional[float] = None
    downtime: Optional[float] = None


class TestbedTelemetry:
    """Real request outcomes + route-transition windows, folded through
    the SAME `core.metrics.aggregate` code as the simulator's traffic
    plane — the testbed's half of the shared request-level metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        # app_id -> list of (t, ok, accuracy, request-or-None)
        self._attempts: Dict[str, list] = {}
        self._full_acc: Dict[str, float] = {}
        self._slo: Dict[str, float] = {}
        self.windows: List[DowntimeWindow] = []
        self._open: Dict[str, DowntimeWindow] = {}

    # -- control-plane hooks (RoutingTable observers) -----------------------
    def app_seen(self, app: Application):
        with self._lock:
            if app.id not in self._attempts:
                self._attempts[app.id] = []
                self._full_acc[app.id] = app.full.accuracy
                self._slo[app.id] = app.latency_slo

    def route_up(self, app_id: str, t: float):
        """A route push reached the clients: close any open blackout."""
        with self._lock:
            w = self._open.pop(app_id, None)
            if w is not None:
                w.t_end = t
                self.windows.append(w)

    def mark_down(self, app_id: str, t: float, epoch: int):
        """The app's serving replica just died (crash instant)."""
        with self._lock:
            if app_id in self._open or app_id not in self._attempts:
                return
            self._open[app_id] = DowntimeWindow(app_id=app_id, epoch=epoch,
                                                t_start=t)

    def mark_gone(self, app_id: str):
        """App departed: an open blackout is censored (never recovered)."""
        with self._lock:
            w = self._open.pop(app_id, None)
            if w is not None:
                self.windows.append(w)

    # -- data plane (client threads) ----------------------------------------
    def record(self, app_id: str, t: float, ok: bool, accuracy: float,
               req=None, outcome: Optional[str] = None):
        """`outcome` tags the resilience layer's classes: "hedged"
        (served via the warm backup), "fast_failed" (open breaker
        answered instantly), "shed" (admission/bulkhead reject);
        None = the plain served/failed path."""
        with self._lock:
            self._attempts[app_id].append((t, ok, accuracy, req, outcome))

    # -- aggregation --------------------------------------------------------
    def summarize(self, t_end: float) -> TrafficSummary:
        with self._lock:
            attempts = {a: list(v) for a, v in self._attempts.items()}
            windows = ([DowntimeWindow(w.app_id, w.epoch, w.t_start,
                                       w.t_end)
                        for w in self.windows]
                       + [DowntimeWindow(w.app_id, w.epoch, w.t_start)
                          for w in self._open.values()])
        logs: List[AppLog] = []
        for app_id in sorted(attempts):
            rows = attempts[app_id]
            n = len(rows)
            arrivals = np.array([r[0] for r in rows], np.float64)
            served = np.array([r[1] for r in rows], bool)
            accuracy = np.array([r[2] if r[1] else math.nan
                                 for r in rows], np.float64)
            latency = np.array(
                [(r[3].done_at - r[3].submitted_at)
                 if (r[1] and r[3] is not None
                     and r[3].done_at is not None) else math.nan
                 for r in rows], np.float64)
            # resilience outcome tags (all-False without the toolkit)
            hedged = np.array([r[4] == "hedged" for r in rows], bool)
            fast_failed = np.array([r[4] == "fast_failed"
                                    for r in rows], bool)
            shed = np.array([r[4] == "shed" for r in rows], bool)
            # dropped = failed while inside a client-visible blackout;
            # fast-failed and shed requests are their own terminal
            # classes, not drops
            dropped = np.zeros(n, bool)
            for w in windows:
                if w.app_id != app_id:
                    continue
                hi = w.t_end if w.recovered else math.inf
                dropped |= (~served & (arrivals >= w.t_start)
                            & (arrivals < hi))
            dropped &= ~(fast_failed | shed)
            full_acc = self._full_acc[app_id]
            slo = self._slo[app_id]
            with np.errstate(invalid="ignore"):
                degraded = served & (accuracy < full_acc - 1e-12)
                slo_violated = served & (latency > slo)
            logs.append(AppLog(
                app_id, arrivals, served, dropped,
                offered=np.ones(n, bool), degraded=degraded,
                slo_violated=slo_violated, accuracy=accuracy,
                latency=latency, hedged=hedged,
                fast_failed=fast_failed, shed=shed,
                retried=np.zeros(n, bool)))
        return aggregate(logs, windows, t_end)

    def client_stats(self, windows: Optional[List[DowntimeWindow]] = None,
                     ) -> Dict[str, ClientStats]:
        """Per-app counters. Pass `TrafficSummary.windows` (back-filled
        by `aggregate` with each window's first served request) so
        `downtime` is the client-observed gap; the raw internal windows
        only know the route-outage interval."""
        if windows is None:
            windows = self.windows
        with self._lock:
            out = {}
            for app_id, rows in self._attempts.items():
                st = ClientStats(app_id)
                for t, ok, _acc, _req, _outcome in rows:
                    if ok:
                        st.ok += 1
                        st.last_ok = t
                    else:
                        st.failed += 1
                downs = [w.client_downtime
                         for w in windows if w.app_id == app_id
                         and w.recovered
                         and math.isfinite(w.client_downtime)]
                st.downtime = max(downs) if downs else None
                out[app_id] = st
            return out


class MiniTestbed:
    def __init__(self, *, n_sites: int = 3, servers_per_site: int = 2,
                 apps_per_arch: int = 1, critical_frac: float = 0.5,
                 headroom: float = 0.35, policy: str = "faillite",
                 planner: Optional[str] = None, alpha: float = 0.1,
                 site_independence: bool = False, seed: int = 0,
                 archs: Optional[List[str]] = None,
                 storage: str = "local", scheduler: str = "fifo",
                 load_bw: Optional[float] = None,
                 warmup_s: Optional[float] = None,
                 nic_bw: Optional[float] = None,
                 cloud_bw: Optional[float] = None,
                 replication: Optional[int] = None,
                 resilience=None,
                 tp_degree: int = 1, shard_policy: str = "auto",
                 apps: Optional[Sequence[Application]] = None,
                 device: Optional[str] = None,
                 planner_backend: str = "torch",
                 planner_coordinators: int = 0):
        self.rng = random.Random(seed)
        # request-plane resilience toolkit (None = historical client
        # path): per-app breakers/budgets, per-server bulkheads, live
        # hedging to the router's backup table
        self.resilience = resilience_active(resilience)
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._budgets: Dict[str, RetryBudget] = {}
        self._bulkheads: Dict[str, Bulkhead] = {}
        self._lat_samples: Dict[str, List[float]] = {}
        self._admit_credit: Dict[str, float] = {}
        self._res_lock = threading.Lock()
        self.clock = WallClock()
        self.detector = FailureDetector(self.clock, interval=0.020)
        self.router = Router()
        self.telemetry = TestbedTelemetry()
        self._ctl_lock = threading.RLock()
        self._archs = list(archs or TESTBED_ARCHS)

        # --- applications: the shared arch-mix workload ------------------
        if apps is not None:
            self.apps: List[Application] = list(apps)
            for app in self.apps:
                if app.full.config is None:
                    raise ValueError(
                        f"testbed apps need real ModelConfigs; "
                        f"{app.id} has a profile-only ladder")
        else:
            self.apps = build_arch_apps(
                self._archs, apps_per_arch=apps_per_arch,
                critical_frac=critical_frac, seed=seed)

        # --- capacity: the shared sizing rule ----------------------------
        n_servers = n_sites * servers_per_site
        mem_cap = arch_mem_cap(self.apps, n_servers, headroom)
        servers = [Server(id=f"s{si}-{sj}", site=f"site{si}",
                          capacity={"mem": mem_cap,
                                    "compute": ARCH_COMPUTE_CAP})
                   for si in range(n_sites)
                   for sj in range(servers_per_site)]
        # model-state plane: same storage presets + ModelRegistry as
        # the simulator; real measured loads calibrate its cost model
        self.cluster = Cluster(servers, storage=storage_preset(
            storage, disk_bw=load_bw, warmup_s=warmup_s, nic_bw=nic_bw,
            cloud_bw=cloud_bw, replication=replication))
        self.registry = ModelRegistry(self.cluster, self.cluster.storage)

        # --- worker threads ----------------------------------------------
        # every failure other than a dead server, from loads, warm
        # preparations, decode steps and client submits
        self.errors: List[str] = []
        self.workers: Dict[str, WorkerServer] = {
            s.id: WorkerServer(s.id, self.detector, device=device,
                               errors=self.errors).start()
            for s in servers}
        self.executor = TestbedExecutor(self.workers, self.router,
                                        self._ctl_lock,
                                        registry=self.registry,
                                        errors=self.errors)
        self.controller = FailLiteController(
            self.cluster, self.clock, self.executor, policy=policy,
            alpha=alpha, site_independence=site_independence,
            planner=planner, detector=self.detector,
            registry=self.registry, scheduler=scheduler,
            planner_backend=planner_backend, planner_device=device,
            planner_coordinators=planner_coordinators)
        # controller routing -> serving router + telemetry, through the
        # first-class RoutingTable observer hooks
        self.controller.routing.observer = self._on_route_set
        self.controller.routing.drop_observer = self._on_route_drop

        # --- run-time state ----------------------------------------------
        self._stop = threading.Event()
        self._departed: set = set()
        self._spike_factor: Dict[str, float] = {}
        self._kill_times: Dict[str, float] = {}
        self._injection_seq = 0
        # (server, kill time, verdict time) of each declared failure, a
        # sweep's in kill order: the first is the first failure's
        # detection latency, and each is a failover.detect span
        self._detections: List[tuple] = []
        self._client_threads: List[threading.Thread] = []
        self._aux_threads: List[threading.Thread] = []
        self._timers: List[threading.Timer] = []
        self._arrival_i = 0

        # --- shard plane (tp_degree >= 2): REAL tensor-parallel groups
        # across the worker threads (serving/shard.py). tp_degree=1
        # keeps every historical path untouched.
        self.shards: Optional[TestbedShardManager] = None
        if tp_degree > 1:
            self.shards = TestbedShardManager(
                self, tp_degree=tp_degree, policy=shard_policy)
            self.executor.shard_plane = self.shards

    # -- routing observers (replace the old monkey-patch) -------------------
    def _on_route_set(self, app_id: str, server_id: str,
                      variant_name: str):
        if (self.shards is not None
                and self.shards.on_route(app_id, server_id,
                                         variant_name)):
            return      # pushed by the shard plane once the engine is up
        self._push_route(app_id, server_id, variant_name)

    def _push_route(self, app_id: str, server_id: str,
                    variant_name: str):
        self.router.set_route(app_id, server_id, variant_name)
        self.telemetry.route_up(app_id, time.monotonic())

    def _accuracy_of(self, app: Application, variant_name: str) -> float:
        """Served accuracy for a routed variant name; falls back to the
        shard plane's synthesized (degraded-TP) variants."""
        try:
            return app.variant_by_name(variant_name).accuracy
        except KeyError:
            if self.shards is not None:
                v = self.shards.lookup_variant(variant_name)
                if v is not None:
                    return v.accuracy
            raise

    def _on_route_drop(self, app_id: str):
        self.router.drop_route(app_id)
        self.telemetry.mark_gone(app_id)

    # -- resilience layer ----------------------------------------------------
    def _sync_backups(self):
        """Mirror the controller's warm set into the router's backup
        table (the hedge / fail-fast target). No-op without the
        toolkit."""
        if self.resilience is None:
            return
        with self._ctl_lock:
            table = {aid: (sid, v.name)
                     for aid, (v, sid, _key)
                     in self.controller.warm.items()}
        self.router.sync_backups(table)

    def _res_state(self, app_id: str):
        r = self.resilience
        with self._res_lock:
            breaker = self._breakers.get(app_id)
            if breaker is None:
                breaker = self._breakers[app_id] = CircuitBreaker(r)
                self._budgets[app_id] = RetryBudget(r)
                self._lat_samples[app_id] = []
                self._admit_credit[app_id] = 0.0
            return breaker, self._budgets[app_id]

    def _bulkhead(self, server_id: str) -> Bulkhead:
        with self._res_lock:
            bh = self._bulkheads.get(server_id)
            if bh is None:
                bh = self._bulkheads[server_id] = Bulkhead(
                    self.resilience.bulkhead_slots)
            return bh

    def _hedge_delay(self, app_id: str) -> float:
        """p99-based hedge delay from this app's recent live latencies."""
        r = self.resilience
        with self._res_lock:
            lats = sorted(self._lat_samples.get(app_id, ()))
        if not lats:
            return r.hedge_min_delay_s
        p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
        return max(r.hedge_min_delay_s, r.hedge_delay_factor * p99)

    def _submit_arm(self, app: Application, route, req, *,
                    bulkhead: bool, flags: dict, key: str):
        """Build one hedged_call arm: submit `req` on `route`. Returns
        (accuracy, req) on success, None on any failure; outcome flags
        are reported through `flags` (thread-safe enough: one writer
        per key)."""
        def arm(cancel: threading.Event):
            if cancel.is_set() or route is None:
                return None
            sid, vname = route
            w = self.workers.get(sid)
            if not (w and w.alive and w.has(vname)):
                flags[key] = False
                return None
            bh = self._bulkhead(sid) if bulkhead else None
            if bh is not None and not bh.try_acquire():
                flags[key + "_shed"] = True
                flags[key] = False
                return None
            try:
                t0 = time.monotonic()
                ok = w.submit(vname, req)
                flags[key] = bool(ok)
                if not ok:
                    return None
                with self._res_lock:
                    samples = self._lat_samples.setdefault(app.id, [])
                    samples.append(time.monotonic() - t0)
                    del samples[:-64]          # keep a rolling window
                return (self._accuracy_of(app, vname), req)
            finally:
                if bh is not None:
                    bh.release()
        return arm

    def _attempt_resilient(self, app: Application, rng: random.Random,
                           seq: int):
        """One client request through the toolkit. Returns
        (ok, accuracy, req, outcome)."""
        r = self.resilience
        breaker, budget = self._res_state(app.id)
        # admission control: while recovery loads are draining, thin
        # offered load to the admit_util fraction (deterministic
        # credit counter, same rule as the simulator's shaping)
        if not self.executor.idle():
            with self._res_lock:
                credit = self._admit_credit[app.id] + r.admit_util
                if credit < 1.0:
                    self._admit_credit[app.id] = credit
                    return False, math.nan, None, "shed"
                self._admit_credit[app.id] = credit - 1.0
        budget.on_request()
        primary = self.router.lookup(app.id)
        backup = self.router.lookup_backup(app.id)
        vocab = app.variants[0].config.vocab_size
        flags: dict = {}

        if not breaker.allow():
            # open breaker: fail fast to the degraded (backup) variant
            # instead of queueing on the dead primary — a redirect, so
            # no retry-budget spend
            if backup is not None:
                req_b = make_request(rng, f"{app.id}-b{seq}", vocab)
                out = self._submit_arm(app, backup, req_b, bulkhead=True,
                                       flags=flags, key="backup")(
                                           threading.Event())
                if out is not None:
                    return True, out[0], out[1], "hedged"
            return False, math.nan, None, "fast_failed"

        req_p = make_request(rng, f"{app.id}-r{seq}", vocab)
        primary_arm = self._submit_arm(app, primary, req_p,
                                       bulkhead=True, flags=flags,
                                       key="primary")
        backup_arm = None
        if backup is not None:
            req_b = make_request(rng, f"{app.id}-h{seq}", vocab)
            inner = self._submit_arm(app, backup, req_b, bulkhead=True,
                                     flags=flags, key="backup")

            def _gated_backup(cancel):
                # a hedge is a re-issue: it spends retry budget
                if not budget.try_spend():
                    return None
                return inner(cancel)
            backup_arm = _gated_backup

        value, winner = hedged_call(primary_arm, backup_arm,
                                    self._hedge_delay(app.id))
        if "primary" in flags:             # primary arm actually ran
            breaker.record(flags["primary"])
        if winner == "primary":
            return True, value[0], value[1], None
        if winner == "backup":
            return True, value[0], value[1], "hedged"
        if flags.get("primary_shed") or flags.get("backup_shed"):
            return False, math.nan, None, "shed"
        return False, math.nan, None, None

    # -- deployment ---------------------------------------------------------
    def deploy(self):
        for app in self.apps:
            self.telemetry.app_seen(app)
            if self.shards is not None:
                # TP-k group: slice the real param tree across k
                # workers, gather + warm the serving engine on the lead
                # (serving/shard.py)
                with self._ctl_lock:
                    self.shards.deploy_group(app)
                self.shards.deploy_real(app)
            else:
                with self._ctl_lock:
                    sid = self.controller.deploy_primary(app)
                self.workers[sid].load(app, app.full)
            for w in self.workers.values():      # cold replicas everywhere
                for v in app.variants:
                    w.stage_cold(app, v)
        with self._ctl_lock:
            warm = self.controller.plan_warm_backups()
        # prepare_warm loads run in the background; wait for residency so
        # the experiment starts from the paper's protected steady state
        deadline = time.monotonic() + 120.0
        for app_id, (variant, sid) in warm.items():
            while (not self.workers[sid].has(variant.name)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        self._sync_backups()
        return self

    # -- clients ------------------------------------------------------------
    def _client_loop(self, app: Application, hz: float):
        st_ok = 0
        seq = 0
        rng = random.Random(hash(app.id) & 0xffff)
        while not self._stop.is_set() and app.id not in self._departed:
            ok = False
            acc = math.nan
            req = None
            outcome = None
            seq += 1
            try:
                if self.resilience is not None:
                    ok, acc, req, outcome = self._attempt_resilient(
                        app, rng, seq)
                    if ok:
                        st_ok += 1
                else:
                    route = self.router.lookup(app.id)
                    if route:
                        sid, vname = route
                        w = self.workers.get(sid)
                        if w and w.alive and w.has(vname):
                            req = make_request(
                                rng, f"{app.id}-r{st_ok}",
                                app.variants[0].config.vocab_size)
                            ok = w.submit(vname, req)
                            if ok:
                                acc = self._accuracy_of(app, vname)
                                st_ok += 1
            except Exception:                      # noqa: BLE001
                ok = False
                self.executor.record_error(f"client of {app.id}")
            self.telemetry.record(app.id, time.monotonic(), ok, acc,
                                  req if ok else None, outcome=outcome)
            time.sleep(1.0 / (hz * self._spike_factor.get(app.id, 1.0)))

    def _start_client(self, app: Application, hz: float):
        t = threading.Thread(target=self._client_loop, args=(app, hz),
                             daemon=True)
        self._client_threads.append(t)
        t.start()

    # -- background control loops -------------------------------------------
    def _sweeper_loop(self):
        while not self._stop.is_set():
            time.sleep(DETECT_POLL_S)
            newly = self.detector.sweep()
            # scheduling-noise suppression: long loads and bursts of
            # kernel launches hold the GIL and can starve a HEALTHY
            # worker's heartbeat
            # thread past the miss threshold. A real deployment has no
            # such cross-server coupling, so spurious detections (the
            # worker was never killed) are re-armed instead of declared.
            for sid in [s for s in newly if self.workers[s].alive]:
                self.detector.revive(sid)
                newly.remove(sid)
            if not newly:
                continue
            now = time.monotonic()
            found = sorted((self._kill_times.get(sid, now), sid)
                           for sid in newly)
            self._detections += [(sid, t, now) for t, sid in found]
            t_fail = found[0][0]
            with self._ctl_lock:
                epoch = self.controller.epoch
                self.controller.handle_failures(newly, t_fail)
            if trace.ON:
                for sid, t, verdict in self._detections[-len(found):]:
                    trace.record("failover.detect", trace.ns(t),
                                 trace.ns(verdict), server=sid, epoch=epoch)
            self._sync_backups()

    def _reprotect_loop(self, every: float):
        while not self._stop.wait(every):
            with self._ctl_lock:
                self.controller.reprotect()
            self._sync_backups()

    # -- scenario event handlers ---------------------------------------------
    def _fail_servers(self, sids: List[str]):
        t_kill = time.monotonic()
        epoch = self._injection_seq
        self._injection_seq += 1
        with self._ctl_lock:
            routes = dict(self.controller.routing.routes)
        for sid in sids:
            self._kill_times[sid] = t_kill
            self.workers[sid].kill()
        # clients see the blackout from the crash instant, well before
        # detection — same window semantics as the simulator
        marked = set()
        for app_id, (sid, _v) in routes.items():
            if sid in sids:
                self.telemetry.mark_down(app_id, t_kill, epoch)
                marked.add(app_id)
        if self.shards is not None:
            # shard groups darken when ANY member dies unless the loss
            # degrades seamlessly on a surviving lead — same rule the
            # simulator applies at the crash instant
            with self._ctl_lock:
                dark = self.shards.darkened_by(set(sids))
            for app_id in sorted(dark - marked):
                self.telemetry.mark_down(app_id, t_kill, epoch)

    def _rejoin(self, sid: str):
        with self._ctl_lock:
            if self.cluster.servers[sid].alive:
                # rejoin raced ahead of detection: apply the failure
                # first so bookkeeping stays consistent
                self.controller.handle_failures(
                    [sid], self._kill_times.get(sid, time.monotonic()))
            self.workers[sid].revive()
            self.controller.handle_rejoin(sid)
        for app in self.apps:                    # disk content survived
            for v in app.variants:
                self.workers[sid].stage_cold(app, v)

    def _adapt_arrival(self, app: Application) -> Application:
        """Scenario arrivals carry synthetic (profile-only) ladders; the
        testbed serves real models, so map the arrival onto a reduced
        arch ladder, preserving id / rate / criticality / SLO."""
        if app.full.config is not None:
            return app
        arch = self._archs[self._arrival_i % len(self._archs)]
        self._arrival_i += 1
        return Application(id=app.id, family=arch,
                           variants=testbed_ladder(arch),
                           request_rate=app.request_rate,
                           latency_slo=app.latency_slo,
                           critical=app.critical)

    def _on_arrival(self, app: Application, stats: dict, hz: float):
        app = self._adapt_arrival(app)
        self.telemetry.app_seen(app)
        if self.shards is not None:
            with self._ctl_lock:
                try:
                    self.shards.deploy_group(app)
                except ValueError:
                    stats["unplaced_arrivals"] += 1
                    return
            self.apps.append(app)
            for w in self.workers.values():
                for v in app.variants:
                    w.stage_cold(app, v)
            # slices + gathered engine build in the background; clients
            # fail until the group's lead engine comes up (a member that
            # dies mid-deploy raises WorkerDown, which _spawn drops)
            self.executor._spawn(lambda: self.shards.deploy_real(app),
                                 f"deploy group of {app.id}")
            self._start_client(app, hz)
            return
        with self._ctl_lock:
            try:
                sid = self.controller.deploy_primary(app)
            except ValueError:
                stats["unplaced_arrivals"] += 1
                return
        self.apps.append(app)
        for w in self.workers.values():
            for v in app.variants:
                w.stage_cold(app, v)
        # the primary engine loads in the background: clients fail until
        # the (real) cold deploy completes — that is what arriving
        # mid-outage costs
        self.executor.load(app, app.full, sid, lambda t: None)
        self._start_client(app, hz)

    def _on_departure(self, app_id: str):
        self._departed.add(app_id)
        with self._ctl_lock:
            self.controller.handle_departure(app_id)
        self.apps = [a for a in self.apps if a.id != app_id]

    def _on_spike(self, ev: LoadSpike, time_scale: float):
        # multiplicative with save/restore, mirroring the simulator's
        # handling so overlapping spikes compose identically
        ids = (set(ev.app_ids) if ev.app_ids is not None
               else {a.id for a in self.apps})
        saved = {aid: self._spike_factor.get(aid, 1.0) for aid in ids}
        for aid in ids:
            self._spike_factor[aid] = saved[aid] * ev.factor

        def restore():
            for aid, f in saved.items():
                self._spike_factor[aid] = f
        timer = threading.Timer(ev.duration * time_scale, restore)
        timer.daemon = True
        self._timers.append(timer)
        timer.start()

    # -- scenario replay ------------------------------------------------------
    def run_scenario(self, scenario: Scenario, *,
                     time_scale: float = 1.0,
                     settle_s: Optional[float] = None,
                     client_hz: float = 10.0,
                     reprotect_every: float = REPROTECT_EVERY_S) -> dict:
        """Replay `scenario` on the wall clock (event times scaled by
        `time_scale`); run until horizon + settle, exiting early once
        every recovery and in-flight load has completed."""
        scenario.validate(self.cluster)
        settle = settle_s if settle_s is not None else 15.0
        stats = {"unplaced_arrivals": 0}

        for app in self.apps:
            self._start_client(app, client_hz)
        for target, args in ((self._sweeper_loop, ()),
                             (self._reprotect_loop, (reprotect_every,))):
            t = threading.Thread(target=target, args=args, daemon=True)
            self._aux_threads.append(t)
            t.start()

        t0 = time.monotonic()
        for ev in scenario.sorted_events():
            delay = t0 + ev.t * time_scale - time.monotonic()
            if delay > 0:
                if self._stop.wait(delay):
                    break
            if isinstance(ev, ServerFail):
                self._fail_servers([ev.server])
            elif isinstance(ev, ShardFail):
                self._fail_servers([ev.server])
            elif isinstance(ev, SiteFail):
                self._fail_servers(list(self.cluster.sites[ev.site]))
            elif isinstance(ev, ServerRejoin):
                self._rejoin(ev.server)
            elif isinstance(ev, AppArrival):
                self._on_arrival(ev.app, stats, client_hz)
            elif isinstance(ev, AppDeparture):
                self._on_departure(ev.app_id)
            elif isinstance(ev, LoadSpike):
                self._on_spike(ev, time_scale)
            elif isinstance(ev, LinkDegrade):
                self.executor.degrade_link(ev.link, ev.factor,
                                           ev.duration * time_scale)
            else:
                raise TypeError(f"unhandled scenario event: {ev}")

        # observe until recovery converges (or the deadline passes)
        deadline = t0 + scenario.horizon * time_scale + settle
        grace = max(1.0, 3.0 / client_hz)
        while time.monotonic() < deadline:
            with self._ctl_lock:
                recs = list(self.controller.records.values())
                down = self.controller.has_unrecovered
            if recs and not down and self.executor.idle() \
                    and all(r.recovered for r in recs):
                time.sleep(grace)       # let clients observe the routes
                break
            time.sleep(0.1)
        t_end = time.monotonic()

        self._stop.set()
        for t in self._client_threads:
            t.join(timeout=2.0)

        ctl = self.controller
        with self._ctl_lock:
            flat = ctl.flat_records()
            overall = ctl.overall_summary()
            per_epoch = ctl.summarize_epochs()
            cov = ctl.warm_coverage()
        traffic = self.telemetry.summarize(t_end)
        out_shard = ({"shard": self.shards.summary()}
                     if self.shards is not None else {})
        return {
            **out_shard,
            "n_epochs": len(ctl.epoch_records),
            "per_epoch": per_epoch,
            "overall": overall,
            "warm_coverage": cov,
            "unplaced_arrivals": stats["unplaced_arrivals"],
            "records": flat,
            "traffic": traffic,
            # Fig. 2b feedback: effective load bandwidth per fetch
            # source, calibrated from the REAL loads this run executed
            # (feed into a sim spec to price loads identically there)
            "load_calibration": self.registry.calibration.to_dict(),
            "detect_latency_s": (self._detections[0][2]
                                 - self._detections[0][1]
                                 if self._detections else math.nan),
            # the summary's windows carry the back-filled
            # t_first_served, so per-app downtime is the true
            # client-observed gap, not just the route outage
            "client_stats": self.telemetry.client_stats(traffic.windows),
            # every failure other than a dead server (loads, warm
            # preparations, decode steps, client submits); a healthy
            # run has none
            "load_errors": list(self.errors),
            # client submits a worker refused because all of its engine's
            # batch slots were busy (a request-plane failure that is not
            # an outage)
            "refused_no_slot": sum(w.refused for w in self.workers.values()),
        }

    # -- compat: the paper's base experiment ----------------------------------
    def run_failure_experiment(self, victim: Optional[str] = None, *,
                               settle_s: float = 0.3,
                               observe_s: float = 6.0,
                               client_hz: float = 20.0) -> dict:
        """Kill one (primary-hosting) server; measure recovery via the
        detector + live clients. Thin wrapper over `run_scenario`."""
        victim = victim or next(
            sid for sid, srv in self.cluster.servers.items()
            if any(i.role == "primary"
                   for i in srv.instances.values()))
        scenario = Scenario(
            name="primary-kill",
            events=[ServerFail(t=settle_s, server=victim)],
            horizon=settle_s,
            description=f"kill {victim}, observe recovery")
        out = self.run_scenario(scenario, settle_s=observe_s,
                                client_hz=client_hz)
        records: Dict[str, RecoveryRecord] = (
            dict(self.controller.epoch_records[0])
            if self.controller.epoch_records else {})
        return {
            "victim": victim,
            "detect_latency_s": out["detect_latency_s"],
            "records": records,
            "summary": self.controller.summarize(records),
            "client_stats": out["client_stats"],
            "traffic": out["traffic"],
        }

    def shutdown(self):
        """Stop every thread this testbed started and JOIN it, then wait
        for the device, so no kernel launched by them is still in flight
        at interpreter teardown."""
        self._stop.set()
        for timer in self._timers:
            timer.cancel()
        for t in self._client_threads + self._aux_threads:
            t.join(timeout=2.0)
        self.executor.join(timeout=20.0)
        for w in self.workers.values():
            w.kill()
        for w in self.workers.values():
            w.join(timeout=2.0)
