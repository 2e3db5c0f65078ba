"""Discrete-event simulation platform (paper §4/§5: 100 servers, 640+
apps, model profiles + MTTR constants taken from the testbed).

Events: failure injections, detector sweeps, model-load completions, and
*traffic chunks*. The simulator provides the SimClock + SimLoadExecutor
the controller runs against; per-LINK FIFO queues (disk/PCIe channel,
NIC, shared cloud uplink — the model-state plane, core/modelstate.py)
serialize transfers along each cold load's fetch path, which with the
default local-everything storage reduces to the historical per-server
serialization.

Request-event model: client requests are not individual heap events.
Every `traffic_chunk_s` of sim time a chunk event (interleaved with
failure/detector/load events in the same queue) bulk-generates each live
app's arrivals for the next window with one vectorized Poisson draw,
reading the rates in effect at that instant — so `LoadSpike` windows and
app churn are honored at chunk granularity while millions of requests
per run stay cheap. Routing-table epoch bumps and crash instants are
timestamped into per-app serving timelines (`core/traffic.py`); after
the run, every request is classified against those timelines into
served / dropped / degraded / SLO-violated and folded into availability,
latency percentiles, accuracy-weighted goodput, and client-observed MTTR
(`core/metrics.py`).

Determinism guarantee: all randomness (workload synthesis, scenario
materialization, arrival generation, latency jitter) derives from
`SimConfig.seed` through independent named streams, and the event queue
breaks time ties by insertion order — the same seed yields the same
per-request trace and byte-identical summaries (`ScenarioResult
.fingerprint()` covers both the control plane and the traffic plane).
"""

from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cluster import make_cluster
from repro_torch.core.controller import FailLiteController, LoadExecutor
from repro_torch.core.heartbeat import FailureDetector, SimClock
from repro_torch.core.metrics import TrafficSummary
from repro_torch.core.modelstate import (CLOUD_LINK, LOCAL, LinkScale,
                                   LoadTicket, ModelRegistry, disk_link,
                                   nic_link, storage_preset)
from repro_torch.core.resilience import active as resilience_active
from repro_torch.core.scenario import (AppArrival, AppDeparture, LinkDegrade,
                                 LoadSpike, Scenario, ServerFail,
                                 ServerRejoin, ShardFail, SiteFail,
                                 build_scenario)
from repro_torch.core.shardgroup import ShardGroupManager
from repro_torch.core.traffic import TrafficConfig, TrafficPlane
from repro_torch.core.variants import (
    Application, Variant, synthetic_family, LOAD_BW, WARMUP_S)

DETECT_SWEEP_S = 0.100        # controller sweep period (paper §5.1)
HEARTBEAT_S = 0.020
REPROTECT_SWEEP_S = 1.0       # continuous re-protection loop period


class EventQueue:
    def __init__(self, clock: SimClock):
        self.clock = clock
        self._q: List[Tuple[float, int, Callable[[], None]]] = []
        self._c = itertools.count()
        # events drained so far (bench_scale's events/sec numerator)
        self.n_processed = 0

    def at(self, t: float, fn: Callable[[], None]):
        heapq.heappush(self._q, (t, next(self._c), fn))

    def after(self, dt: float, fn: Callable[[], None]):
        self.at(self.clock.now() + dt, fn)

    def next_time(self) -> Optional[float]:
        """Earliest pending event time, or None when the heap is empty
        (the epoch folder peeks at this to size event-free spans)."""
        return self._q[0][0] if self._q else None

    def run_until(self, t_end: float):
        while self._q and self._q[0][0] <= t_end:
            t, _, fn = heapq.heappop(self._q)
            self.clock.t = max(self.clock.t, t)
            self.n_processed += 1
            fn()
        self.clock.t = max(self.clock.t, t_end)


class SimLoadExecutor(LoadExecutor):
    """Contention-aware load engine: per-link FIFO queues + fetch-path
    selection through the `ModelRegistry` (local ≫ peer ≫ cloud).

    A transfer serializes on EVERY link of its fetch path: it starts
    when the latest of its links frees up and occupies each of them
    until it completes — so N simultaneous cold loads through the one
    shared cloud uplink drain back-to-back (the Nth pays N-1 transfer
    times of queueing), while loads on disjoint links overlap freely.
    `LinkDegrade` scenario events scale a link's bandwidth for a
    window; costs are priced through the registry's `LoadCostModel`,
    so a testbed-measured calibration applies here too.

    With the default local-everything storage every load is a single
    local disk hit, which reduces bit-exactly to the historical model:
    serialized per server at `bw`, each load costing
    ``bytes / bw + warmup``.
    """

    def __init__(self, events: EventQueue, bw: float = LOAD_BW,
                 registry: Optional[ModelRegistry] = None):
        self.events = events
        self.bw = bw                       # registry-less fallback
        self.registry = registry
        self.busy_until: Dict[str, float] = {}    # link -> free time
        self._scales = LinkScale()                # LinkDegrade windows
        # bumped by reset_server: transfers severed by a crash must not
        # stage phantom checkpoint residency when their event fires
        self._reset_gen: Dict[str, int] = {}

    # -- link model ----------------------------------------------------------
    def _base_bw(self, link: str) -> float:
        if self.registry is None:
            return self.bw
        st = self.registry.storage
        if link == CLOUD_LINK:
            return st.cloud_bw
        if link.startswith("disk:"):
            return st.disk_bw
        return st.nic_bw

    def degrade_link(self, link: str, factor: float, duration: float):
        """Scale `link`'s bandwidth by `factor` for `duration` sim
        seconds (multiplicative, so overlapping windows compose)."""
        self.events.after(duration, self._scales.degrade(link, factor))

    def _path(self, variant, server_id):
        """(links, bottleneck_bw, warmup_s, source) for one load."""
        if self.registry is not None:
            plan = self.registry.fetch_plan(variant.name, server_id)
            links = plan.links
            bw = min(self._base_bw(l) for l in links)
            bw = self.registry.calibration.effective_bw(plan.source, bw)
            warm = self.registry.storage.warmup_s
            source = plan.source
        else:
            links = (disk_link(server_id),)
            bw, warm, source = self.bw, WARMUP_S, LOCAL
        return links, bw * self._scales.min_over(links), warm, source

    def _occupy(self, links, now: float, duration: float):
        """FIFO-claim every link of a fetch path: the transfer starts
        when the latest link frees up and occupies all of them until it
        completes. Returns (start, done)."""
        start = max(now, max(self.busy_until.get(l, now) for l in links))
        done = start + duration
        for l in links:
            self.busy_until[l] = done
        return start, done

    def idle(self) -> bool:
        """No transfer in flight on any link at the current sim time."""
        now = self.events.clock.now()
        return all(t <= now for t in self.busy_until.values())

    # -- LoadExecutor --------------------------------------------------------
    def load(self, app, variant, server_id, on_ready) -> LoadTicket:
        now = self.events.clock.now()
        links, bw, warm, source = self._path(variant, server_id)
        fetch = variant.mem_bytes / bw
        start, done = self._occupy(links, now, fetch + warm)
        ticket = LoadTicket(source=source, queue_s=start - now,
                            fetch_s=fetch, warmup_s=warm)
        gen = self._reset_gen.get(server_id, 0)

        def fire():
            ticket.done = True
            if (self.registry is not None
                    and self._reset_gen.get(server_id, 0) == gen):
                # the fetched bytes are now on this server's disk;
                # severed transfers (server crashed mid-stream) must
                # not claim residency
                self.registry.stage(variant.name, server_id)
            on_ready(done)

        self.events.at(done, fire)
        return ticket

    def activate(self, app, variant, server_id):
        pass  # warm: already resident

    def prepare_warm(self, app, variant, server_id):
        """Proactive warm placement ships the checkpoint bytes along
        (background, not MTTR-critical — modeled as instant)."""
        if self.registry is not None:
            self.registry.stage(variant.name, server_id)

    def replicate(self, app, variant, server_id, on_done=None):
        """Background checkpoint copy onto `server_id`'s disk: occupies
        the fetch-path links (no warmup — nothing is compiled), then
        stages residency."""
        now = self.events.clock.now()
        if self.registry is None:
            if on_done is not None:
                on_done(now)
            return
        plan = self.registry.fetch_plan(variant.name, server_id)
        if plan.source == LOCAL:
            if on_done is not None:
                on_done(now)
            return
        links = plan.links
        bw = min(self._base_bw(l) for l in links) \
            * self._scales.min_over(links)
        _start, done = self._occupy(links, now, variant.mem_bytes / bw)
        gen = self._reset_gen.get(server_id, 0)

        def fire():
            if self._reset_gen.get(server_id, 0) == gen:
                self.registry.stage(variant.name, server_id)
            if on_done is not None:
                on_done(done)

        self.events.at(done, fire)

    def reset_server(self, server_id):
        """Crash/rejoin wipes the server's own link queues (disk + NIC)
        and severs its in-flight transfers (they will not stage
        residency); shared links keep their backlog."""
        self._reset_gen[server_id] = \
            self._reset_gen.get(server_id, 0) + 1
        self.busy_until.pop(disk_link(server_id), None)
        self.busy_until.pop(nic_link(server_id), None)
        # registry-less fallback keyed the queue by bare server id
        self.busy_until.pop(server_id, None)


@dataclass
class SimConfig:
    """Paper §5.1 semantics: primaries fill ~`primary_util` of the
    cluster; `headroom` is the fraction of each server usable for
    failover backups (controlled 10%-50%); the remainder is blocked
    (other tenants)."""
    n_sites: int = 10
    servers_per_site: int = 10
    server_mem: float = 16e9
    server_compute: float = 1.0
    primary_util: float = 0.5
    headroom: float = 0.2          # usable free fraction per server
    critical_frac: float = 0.5     # |K| / N
    alpha: float = 0.1
    policy: str = "faillite"
    site_independence: bool = False
    use_ilp: bool = False
    # placement policy by registry name (docs/PLANNER.md): "greedy",
    # "ilp", "load-aware", "legacy-greedy", "locality"; None =
    # use_ilp-derived default
    planner: Optional[str] = None
    seed: int = 0
    # request-level traffic plane: requests/s generated per unit app
    # rate q_i (0 disables the plane) and the bulk-generation window
    traffic_rate_scale: float = 20.0
    traffic_chunk_s: float = 0.5
    # diurnal rate modulation (0 amplitude = plain Poisson, the
    # historical default); shared with the autopilot's trough/peak model
    traffic_diurnal_amplitude: float = 0.0
    traffic_diurnal_period: float = 240.0
    # model-state plane (core/modelstate.py): storage preset by name
    # ("local" = every checkpoint on every disk, the exact historical
    # behavior; "edge" = paper-faithful constrained topology), the
    # Fig. 2b load-cost constants (previously the module-level
    # LOAD_BW/WARMUP_S), optional per-preset bandwidth overrides, and
    # the recovery-drain scheduler ("fifo" | "criticality")
    storage: str = "local"
    load_bw: float = LOAD_BW       # bytes/s disk->HBM (Fig. 2b slope)
    warmup_s: float = WARMUP_S     # per-instance compile/alloc warmup
    nic_bw: Optional[float] = None
    cloud_bw: Optional[float] = None
    replication: Optional[int] = None
    scheduler: str = "fifo"
    # adaptive protection (core/autopilot.py): False = the static
    # criticality rule, bit-exact historical behavior
    autopilot: bool = False
    # request-plane resilience toolkit (core/resilience.py): a
    # ResilienceConfig as a plain dict (JSON round-trip through
    # ExperimentSpec). None/enabled=False = bit-exact historical
    # request plane (golden fingerprints pinned)
    resilience: Optional[dict] = None
    # event-loop drain strategy (docs/SCALE.md): "epoch" folds
    # event-free spans of traffic chunks into vectorized bulk
    # generation (bit-exact with per-event, proven by
    # tests/test_scale.py); "per-event" is the historical
    # one-callback-per-chunk compat path and the bench baseline
    event_mode: str = "epoch"
    # planner array dtype: "float64" (bit-exact default) or "float32"
    # (halves PlannerState memory at 10k servers; NOT fingerprint-
    # preserving — scale runs only)
    planner_dtype: str = "float64"
    # planner compute backend: "torch" (the default; device tensors with
    # K5's round kernel, planner/torch_backend.py) or "numpy" (the parity
    # oracle on the host) — bit-identical assignments and objective. Only
    # the greedy family ("greedy"/"sharded") honors it.
    # `planner_coordinators` >= 2 plans sharded rounds with that many
    # concurrent site-slice coordinators (numpy sharded path only)
    planner_backend: str = "torch"
    planner_coordinators: int = 0
    # where planner_backend="torch" runs: None = the card (raises when
    # there is none), "cpu" only when asked for
    planner_device: Optional[str] = None
    # shard plane (core/shardgroup.py): tp_degree >= 2 deploys every
    # app as a tensor-parallel group spanning tp_degree servers and
    # attaches the shard recovery ladder; 1 (the default) keeps the
    # historical monolith path bit-exact. `shard_policy` picks the
    # ladder rung: "auto" (critical -> degrade, rest -> reshard),
    # "degrade", "reshard", or "monolith" (immediate fallback)
    tp_degree: int = 1
    shard_policy: str = "auto"


def synthetic_apps(cfg: SimConfig, rng: random.Random,
                   family_class: Optional[str] = None) -> List[Application]:
    """App mix reproducing the paper's family spread classes.

    Small/Medium/Large = max demand diff between largest/smallest variant
    (paper §5.5: Mobilenet 12MB diff vs Convnext 648MB diff); scaled here
    to LLM serving-cell sizes.
    """
    # spreads calibrated to the paper's TorchVision families: Mobilenet
    # (small, ~1.5x), EfficientNet/RegNet (medium), ConvNeXt/ResNet
    # (large, order-of-magnitude member spread).
    classes = {
        "small": (0.4e9, 1.5),
        "medium": (1.5e9, 5.0),
        "large": (5.0e9, 24.0),
    }
    if family_class:
        fams = [(f"{family_class}{i}", *classes[family_class])
                for i in range(5)]
    else:
        fams = [(f"{cls}{i}", *classes[cls])
                for cls in classes for i in range(3)]
    total_mem = cfg.n_sites * cfg.servers_per_site * cfg.server_mem
    budget = total_mem * cfg.primary_util
    apps: List[Application] = []
    used = 0.0
    i = 0
    while True:
        name, mem, spread = fams[i % len(fams)]
        ladder = synthetic_family(f"{name}-a{i}", mem, n_variants=6,
                                  spread=spread)
        need = ladder[0].mem_bytes
        if used + need > budget:
            break
        apps.append(Application(
            id=f"app{i}", family=ladder[0].family, variants=ladder,
            request_rate=rng.uniform(0.5, 2.0),
            # finite SLO so the traffic plane can flag late requests:
            # ~4x the full model's service-time proxy leaves room for
            # jitter but not for a queueing blow-up under a LoadSpike
            latency_slo=ladder[0].compute * 4.0,
            critical=(rng.random() < cfg.critical_frac)))
        used += need
        i += 1
    return apps


@dataclass
class SimResult:
    recovery_rate: float
    mttr_avg: float
    accuracy_reduction: float
    n_affected: int
    records: dict
    traffic: Optional[TrafficSummary] = None   # request-level view


@dataclass
class ScenarioResult:
    """Outcome of one deterministic scenario replay."""
    name: str
    n_epochs: int                       # handle_failures invocations
    per_epoch: List[dict]               # summary per failure epoch
    overall: dict                       # summary over ALL epoch records
    warm_coverage: float                # critical apps warm-protected at end
    unplaced_arrivals: int
    n_apps_final: int
    records: List[object]               # flat per-epoch RecoveryRecords
    traffic: Optional[TrafficSummary] = None   # request-level view

    def fingerprint(self) -> tuple:
        """Deterministic digest used by the determinism tests; covers
        both the control plane and the per-request traffic plane."""
        base = tuple(sorted(
            (r.epoch, r.app_id, r.recovered, round(r.mttr, 9)
             if r.mttr != float("inf") else -1.0, r.variant, r.mode)
            for r in self.records))
        if self.traffic is not None:
            return (base, self.traffic.fingerprint())
        return base


class Simulation:
    def __init__(self, cfg: SimConfig,
                 apps: Optional[List[Application]] = None):
        self.cfg = cfg
        self.rng = random.Random(cfg.seed)
        self.clock = SimClock()
        self.events = EventQueue(self.clock)
        self.cluster = make_cluster(cfg.n_sites, cfg.servers_per_site,
                                    mem=cfg.server_mem,
                                    compute=cfg.server_compute)
        # model-state plane: storage topology + checkpoint registry
        self.cluster.storage = storage_preset(
            cfg.storage, disk_bw=cfg.load_bw, warmup_s=cfg.warmup_s,
            nic_bw=cfg.nic_bw, cloud_bw=cfg.cloud_bw,
            replication=cfg.replication)
        self.registry = ModelRegistry(self.cluster, self.cluster.storage)
        self.executor = SimLoadExecutor(self.events, bw=cfg.load_bw,
                                        registry=self.registry)
        self.detector = FailureDetector(self.clock, interval=HEARTBEAT_S)
        pilot = None
        if cfg.autopilot:
            from repro_torch.core.autopilot import (AutopilotConfig,
                                              AutopilotPolicy)
            pilot = AutopilotPolicy(AutopilotConfig(
                diurnal_amplitude=cfg.traffic_diurnal_amplitude,
                diurnal_period=cfg.traffic_diurnal_period))
        if cfg.event_mode not in ("epoch", "per-event"):
            raise ValueError(f"unknown event_mode: {cfg.event_mode!r}")
        self.controller = FailLiteController(
            self.cluster, self.clock, self.executor,
            policy=cfg.policy, alpha=cfg.alpha,
            site_independence=cfg.site_independence, use_ilp=cfg.use_ilp,
            planner=cfg.planner, detector=self.detector,
            registry=self.registry, scheduler=cfg.scheduler,
            autopilot=pilot, planner_dtype=cfg.planner_dtype,
            planner_backend=cfg.planner_backend,
            planner_coordinators=cfg.planner_coordinators,
            planner_device=cfg.planner_device)
        # shard plane: only constructed at tp_degree >= 2 (off-path
        # bit-exactness — no manager, no shard branch anywhere)
        self.shards: Optional[ShardGroupManager] = None
        if cfg.tp_degree > 1:
            self.shards = ShardGroupManager(
                self.controller, tp_degree=cfg.tp_degree,
                policy=cfg.shard_policy, defer=self.events.after)
        self.apps = apps if apps is not None else synthetic_apps(
            cfg, self.rng)
        # per-server "other tenants" reservation, recorded at setup so a
        # rejoining (empty) server gets the same share re-blocked
        self._blockers: Dict[str, float] = {}
        # request-level traffic plane: observes routing-table pushes and
        # crash instants; injections are numbered so downtime windows
        # carry the same epoch index as the controller's records
        self._injection_seq = 0
        self.resilience = resilience_active(cfg.resilience)
        self.traffic: Optional[TrafficPlane] = None
        if cfg.traffic_rate_scale > 0:
            self.traffic = TrafficPlane(
                seed=cfg.seed,
                cfg=TrafficConfig(
                    rate_scale=cfg.traffic_rate_scale,
                    chunk_s=cfg.traffic_chunk_s,
                    diurnal_amplitude=cfg.traffic_diurnal_amplitude,
                    diurnal_period=cfg.traffic_diurnal_period),
                resilience=self.resilience,
                batch=(cfg.event_mode == "epoch"))
            self.controller.routing.observer = self._on_route_set
            self.controller.routing.drop_observer = self._on_route_drop
            if self.resilience is not None:
                # admission control needs the recovery-drain intervals;
                # the observer hook is a no-op when unset (off-path)
                self.controller.scheduler.drain_observer = \
                    self.traffic.record_drain
        if cfg.autopilot:
            self.controller.metrics_feed = self._autopilot_feed
        # warm-headroom observation: (bytes, count) sampled once per
        # re-protection sweep (pure measurement — no events, no RNG)
        self._warm_samples: List[Tuple[float, int]] = []

    # ------------------------------------------------------------------
    # traffic plane hooks
    # ------------------------------------------------------------------
    def _on_route_set(self, app_id: str, server_id: str,
                      variant_name: str):
        app = self.controller.apps.get(app_id)
        if app is None:
            return
        try:
            v = app.variant_by_name(variant_name)
        except KeyError:
            # synthesized shard variants (degraded-TP continuation) live
            # in the shard manager's side table, never in app.variants
            v = (self.shards.lookup_variant(variant_name)
                 if self.shards is not None else None)
            if v is None:
                raise
        self.traffic.mark_up(app_id, self.clock.now(),
                             accuracy=v.accuracy, service_time=v.compute,
                             full_accuracy=app.full.accuracy,
                             slo=app.latency_slo)

    def _on_route_drop(self, app_id: str):
        self.traffic.mark_gone(app_id, self.clock.now())

    def _autopilot_feed(self):
        """Live metrics-plane view for the autopilot: observed arrival
        rates and recent client downtime from the traffic plane, plus a
        modeled SLO margin for the variant each route currently serves.
        Pure observation — reading it perturbs no event or RNG state."""
        from repro_torch.core.autopilot import AppSignal

        now = self.clock.now()
        ctl = self.controller
        rates = (self.traffic.current_rates()
                 if self.traffic is not None else {})
        downs = (self.traffic.downtime_since(now - 30.0, now)
                 if self.traffic is not None else {})
        tcfg = self.traffic.cfg if self.traffic is not None \
            else TrafficConfig()
        out = {}
        for app_id, app in ctl.apps.items():
            q = rates.get(app_id, app.request_rate)
            route = ctl.routing.routes.get(app_id)
            try:
                v = app.variant_by_name(route[1]) if route else app.full
            except KeyError:
                v = app.full
            util = min(q * v.compute * tcfg.util_k, tcfg.util_cap)
            latency = v.compute / (1.0 - util)
            out[app_id] = AppSignal(
                rate=q,
                slo_margin=app.latency_slo - latency,
                down=app_id in ctl._unrecovered,
                recent_downtime_s=downs.get(app_id, 0.0))
        return out

    def shard_summary(self) -> Optional[Dict]:
        """Shard-plane report (None when tp_degree == 1): group states,
        ladder actions taken, and per-action MTTR averages."""
        return self.shards.summary() if self.shards is not None else None

    def protection_summary(self) -> Dict[str, float]:
        """Warm-replica headroom actually spent over the run: mean and
        final warm bytes / instance counts from the per-sweep samples —
        the soak harness's equal-or-lower-headroom check."""
        warm = self.controller.warm.values()
        final_bytes = float(sum(v.mem_bytes for v, _, _ in warm))
        if not self._warm_samples:
            return {"warm_bytes_mean": final_bytes,
                    "warm_bytes_final": final_bytes,
                    "n_warm_mean": float(len(self.controller.warm)),
                    "n_warm_final": len(self.controller.warm)}
        return {
            "warm_bytes_mean": (sum(b for b, _ in self._warm_samples)
                                / len(self._warm_samples)),
            "warm_bytes_final": final_bytes,
            "n_warm_mean": (sum(n for _, n in self._warm_samples)
                            / len(self._warm_samples)),
            "n_warm_final": len(self.controller.warm),
        }

    def _start_traffic(self, t_end: float):
        """Schedule the chunked bulk-generation loop up to t_end.

        Per-event mode fires one heap callback per chunk window (the
        historical path, kept verbatim as the bench baseline). Epoch
        mode folds runs of event-free chunk windows into one
        `generate_chunks` call: a fold extends while the next pending
        heap event lies STRICTLY past the window end — any event at
        exactly t1 (or any state change at all inside the span) stops
        the fold, so rates/eligibility are constant across folded
        windows and the drain is bit-exact with per-event mode (no seq
        numbers are consumed inside an event-free span, so the
        stop-tick rescheduled at t1 orders identically to the
        per-event reschedule; proven by tests/test_scale.py)."""
        if self.traffic is None:
            return
        chunk = self.traffic.cfg.chunk_s

        if self.cfg.event_mode == "per-event":
            def tick():
                t0 = self.clock.now()
                t1 = min(t0 + chunk, t_end)
                self.traffic.generate_chunk(self.apps, t0, t1)
                if t1 < t_end - 1e-12:
                    self.events.at(t1, tick)

            self.events.at(self.clock.now(), tick)
            return

        def epoch_tick():
            tc = self.clock.now()
            spans = []
            while True:
                t1 = min(tc + chunk, t_end)
                spans.append((tc, t1))
                if t1 >= t_end - 1e-12:
                    break
                nxt = self.events.next_time()
                if nxt is not None and nxt <= t1:
                    self.events.at(t1, epoch_tick)
                    break
                tc = t1
            self.traffic.generate_chunks(self.apps, spans)

        self.events.at(self.clock.now(), epoch_tick)

    def setup(self):
        """Place primaries, block non-headroom capacity, plan warm backups.

        Fragmentation can make the last few generated apps unplaceable;
        they are dropped (the paper fixes the app count per setting, we
        fix the target utilization)."""
        placed = []
        for app in self.apps:
            try:
                if self.shards is not None:
                    self.shards.deploy_group(app)
                else:
                    self.controller.deploy_primary(app)
                placed.append(app)
            except ValueError:
                continue
        self.apps = placed

        # block everything beyond `headroom` per server (other tenants)
        for srv in self.cluster.alive_servers():
            excess = srv.free("mem") - self.cfg.headroom * srv.capacity["mem"]
            if excess > 0:
                self._blockers[srv.id] = excess
                self._place_blocker(srv.id, excess)
        self.controller.plan_warm_backups()
        return self

    def _place_blocker(self, server_id: str, mem: float):
        blocker = Variant(name="blocked", family="_reserved",
                          mem_bytes=mem, compute=0.0, accuracy=0.0)
        self.cluster.place("_reserved", blocker, server_id, "primary")

    def _schedule_failure(self, server_ids: List[str], t_fail: float):
        """Crash at t_fail (instances die NOW); the controller reacts
        after the detection latency (2 missed heartbeats + sweep
        alignment, §5.7: ~65ms). Collecting the lost instances at crash
        time keeps a rejoin inside the detection window consistent."""
        def do_fail():
            lost = []
            for sid in server_ids:
                lost.extend(self.cluster.fail_server(sid))
                self.detector.mark_failed(sid)
                self.executor.reset_server(sid)
            # clients see the blackout from the crash instant, well
            # before detection; windows are tagged with the epoch index
            # this injection will occupy (injections are handled in
            # scheduling order, so the sequence number matches). An app
            # goes dark iff its ROUTE pointed at the crashed server —
            # that covers primaries and also progressive recoveries
            # that were already serving while their selected variant
            # was still loading (instance role "loading").
            epoch = self._injection_seq
            self._injection_seq += 1
            if self.traffic is not None:
                routes = self.controller.routing.routes
                # shard plane: a group member loss can black out an app
                # whose route points at a SURVIVING lead (reshard /
                # monolith fallback pause serving); a seamless degrade
                # of a non-lead member keeps serving and is excluded
                shard_dark = (self.shards.darkened_by(set(server_ids))
                              if self.shards is not None else set())
                marked = set()
                for inst in lost:
                    if (inst.app_id in self.controller.apps
                            and routes.get(inst.app_id, (None,))[0]
                            == inst.server_id):
                        marked.add(inst.app_id)
                        backup = None
                        if self.resilience is not None:
                            # hedged requests go to the app's warm
                            # backup, valid only if its host survived
                            # this injection
                            warm = self.controller.warm.get(inst.app_id)
                            if warm is not None:
                                v, wsid, _key = warm
                                srv = self.cluster.servers.get(wsid)
                                if srv is not None and srv.alive:
                                    backup = (v.accuracy, v.compute)
                        self.traffic.mark_down(inst.app_id, t_fail,
                                               epoch, backup=backup)
                for app_id in sorted(shard_dark - marked):
                    if app_id in self.controller.apps:
                        self.traffic.mark_down(app_id, t_fail, epoch)
            t_detect = (self.detector.detection_latency_bound()
                        + DETECT_SWEEP_S / 4)
            self.events.after(t_detect, lambda: self.controller
                              .handle_failures(list(server_ids), t_fail,
                                               lost=lost))

        self.events.at(t_fail, do_fail)

    def inject_failure(self, *, servers: Optional[List[str]] = None,
                       sites: Optional[List[str]] = None,
                       t_fail: float = 1.0,
                       run_for: float = 60.0) -> SimResult:
        """Crash servers/sites at t_fail; run the recovery to completion."""
        failed: List[str] = list(servers or [])
        for site in (sites or []):
            failed.extend(self.cluster.sites[site])

        t_end = t_fail + run_for
        self._schedule_failure(failed, t_fail)
        self._start_traffic(t_end)
        self.events.run_until(t_end)

        recs = self.controller.records
        summary = self.controller.summarize(recs)
        return SimResult(
            recovery_rate=summary["recovery_rate"],
            mttr_avg=summary["mttr_avg"],
            accuracy_reduction=summary["accuracy_reduction"],
            n_affected=summary["n"],
            records=recs,
            traffic=(self.traffic.summarize(t_end)
                     if self.traffic is not None else None))

    # ------------------------------------------------------------------
    # scenario replay
    # ------------------------------------------------------------------
    def _on_rejoin(self, server_id: str):
        srv = self.cluster.servers[server_id]
        if srv.alive:
            return
        self.controller.handle_rejoin(server_id)
        # the node returns empty; re-block the other-tenant share so only
        # (former primary share + headroom) is available for refilling
        mem = self._blockers.get(server_id, 0.0)
        if mem > 0:
            self._place_blocker(server_id, mem)

    def _traffic_dirty(self):
        """App set or rates changed: invalidate the traffic plane's
        epoch-mode eligibility snapshot."""
        if self.traffic is not None:
            self.traffic.snapshot_gen += 1

    def _on_arrival(self, app: Application, stats: dict):
        try:
            self.controller.deploy_primary(app)
            self.apps.append(app)
            self._traffic_dirty()
        except ValueError:
            stats["unplaced_arrivals"] += 1

    def _on_departure(self, app_id: str):
        self.controller.handle_departure(app_id)
        self.apps = [a for a in self.apps if a.id != app_id]
        self._traffic_dirty()

    def _on_spike(self, ev: LoadSpike):
        ids = set(ev.app_ids) if ev.app_ids is not None else None
        targets = [a for a in self.apps
                   if ids is None or a.id in ids]
        saved = [(a, a.request_rate) for a in targets]
        for a in targets:
            a.request_rate *= ev.factor
        self._traffic_dirty()

        def restore():
            for a, r in saved:
                a.request_rate = r
            self._traffic_dirty()
        self.events.after(ev.duration, restore)

    def run_scenario(self, scenario: Scenario, *,
                     reprotect_every: float = REPROTECT_SWEEP_S,
                     settle: float = 20.0) -> ScenarioResult:
        """Replay a Scenario deterministically.

        Failures go through detection latency; rejoining servers return
        empty and are refilled; `controller.reprotect()` runs as a
        periodic event-queue loop (continuous re-protection), replacing
        the manual `replan_lost_backups` call."""
        scenario.validate(self.cluster)
        stats = {"unplaced_arrivals": 0}
        for ev in scenario.sorted_events():
            if isinstance(ev, ServerFail):
                self._schedule_failure([ev.server], ev.t)
            elif isinstance(ev, ShardFail):
                # physically a server crash; the controller's shard
                # plane (when attached) walks hit groups through the
                # degrade/reshard/fallback ladder at detection time
                self._schedule_failure([ev.server], ev.t)
            elif isinstance(ev, SiteFail):
                self._schedule_failure(list(self.cluster.sites[ev.site]),
                                       ev.t)
            elif isinstance(ev, ServerRejoin):
                self.events.at(ev.t, (lambda s=ev.server:
                                      self._on_rejoin(s)))
            elif isinstance(ev, AppArrival):
                self.events.at(ev.t, (lambda a=ev.app:
                                      self._on_arrival(a, stats)))
            elif isinstance(ev, AppDeparture):
                self.events.at(ev.t, (lambda a=ev.app_id:
                                      self._on_departure(a)))
            elif isinstance(ev, LoadSpike):
                self.events.at(ev.t, (lambda e=ev: self._on_spike(e)))
            elif isinstance(ev, LinkDegrade):
                self.events.at(ev.t, (lambda e=ev: self.executor
                                      .degrade_link(e.link, e.factor,
                                                    e.duration)))
            else:
                raise TypeError(f"unhandled scenario event: {ev}")

        t_end = scenario.horizon + settle

        # memoized warm-bytes fold: the warm set only changes when the
        # controller says so (warm_gen), so sweeps between mutations
        # reuse the previous sum bit-for-bit instead of re-scanning
        # every warm entry (a per-sweep O(apps) loop at 100k apps)
        warm_cache = [-1, (0.0, 0)]

        def reprotect_tick():
            self.controller.reprotect()
            # pure observation for the headroom trend; no event/RNG state
            if warm_cache[0] != self.controller.warm_gen:
                warm_cache[0] = self.controller.warm_gen
                warm_cache[1] = (
                    float(sum(v.mem_bytes for v, _, _
                              in self.controller.warm.values())),
                    len(self.controller.warm))
            self._warm_samples.append(warm_cache[1])
            if self.clock.now() + reprotect_every <= t_end:
                self.events.after(reprotect_every, reprotect_tick)

        self.events.after(reprotect_every, reprotect_tick)
        self._start_traffic(t_end)
        self.events.run_until(t_end)

        ctl = self.controller
        flat = ctl.flat_records()
        return ScenarioResult(
            name=scenario.name,
            n_epochs=len(ctl.epoch_records),
            per_epoch=ctl.summarize_epochs(),
            overall=ctl.overall_summary(),
            warm_coverage=ctl.warm_coverage(),
            unplaced_arrivals=stats["unplaced_arrivals"],
            n_apps_final=len(ctl.apps),
            records=flat,
            traffic=(self.traffic.summarize(t_end)
                     if self.traffic is not None else None))

    def run_named_scenario(self, name: str, **kw) -> ScenarioResult:
        sc = build_scenario(name, self.cluster, self.apps,
                            seed=self.cfg.seed)
        return self.run_scenario(sc, **kw)


def run_policy_comparison(cfg: SimConfig, fail_servers: int = 1,
                          fail_sites: int = 0, seeds=(0, 1, 2)):
    """Convenience: same workload, all four policies, averaged."""
    out = {}
    for policy in ("faillite", "full-warm", "full-cold", "full-warm-k"):
        agg = {"recovery_rate": 0.0, "mttr_avg": 0.0,
               "accuracy_reduction": 0.0}
        n = 0
        for seed in seeds:
            # only the three aggregate recovery numbers are returned, so
            # skip the (otherwise-discarded) traffic plane
            c = SimConfig(**{**cfg.__dict__, "policy": policy,
                             "seed": seed, "traffic_rate_scale": 0.0})
            sim = Simulation(c).setup()
            if fail_sites:
                sites = list(sim.cluster.sites)[:fail_sites]
                res = sim.inject_failure(sites=sites)
            else:
                servers = [s.id for s in
                           sim.rng.sample(sim.cluster.alive_servers(),
                                          fail_servers)]
                res = sim.inject_failure(servers=servers)
            if res.n_affected == 0:
                continue
            agg["recovery_rate"] += res.recovery_rate
            if res.recovery_rate > 0:
                agg["mttr_avg"] += res.mttr_avg
            agg["accuracy_reduction"] += res.accuracy_reduction
            n += 1
        out[policy] = {k: v / max(n, 1) for k, v in agg.items()}
    return out


def run_scenario_suite(cfg: SimConfig,
                       names: Optional[List[str]] = None,
                       policies=("faillite", "full-warm", "full-cold",
                                 "full-warm-k")):
    """Sweep every policy over the named scenario library. Each cell is
    a fresh Simulation (same cfg+seed => same workload & event trace),
    so policies are compared on identical fault sequences."""
    from repro_torch.core.scenario import SCENARIOS
    names = list(names) if names is not None else sorted(SCENARIOS)
    out: Dict[str, Dict[str, ScenarioResult]] = {}
    for name in names:
        out[name] = {}
        for policy in policies:
            c = SimConfig(**{**cfg.__dict__, "policy": policy})
            sim = Simulation(c).setup()
            out[name][policy] = sim.run_named_scenario(name)
    return out
