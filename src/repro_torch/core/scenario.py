"""Declarative failure scenarios — trace-driven fault injection.

The paper evaluates one-shot server/site crashes; real edge deployments
see *sequences* of correlated faults: cascades that spill across racks,
rolling maintenance with rejoins, flaky nodes that crash repeatedly, and
workload churn arriving mid-outage. A `Scenario` is a list of timed
events the simulator replays deterministically from a seed, exercising
the controller's re-entrant failure handling and the continuous
re-protection loop.

Event types:
    ServerFail / SiteFail      crash one server / a whole failure domain
    ShardFail                  crash one server hosting a shard of a
                               tensor-parallel group (physically a
                               server crash; the controller's shard
                               plane decides degrade/reshard/fallback)
    ServerRejoin               failed node returns (empty, gets refilled)
    AppArrival / AppDeparture  workload churn
    LoadSpike                  temporary request-rate multiplier
    LinkDegrade                temporary bandwidth cut on a storage link
                               ("cloud", "nic:<sid>", or "disk:<sid>")

Named library (`SCENARIOS`): single-server, site-outage, cascade,
rolling-with-rejoin, churn-under-failure, flaky-node, plus
cold-load-storm (a site outage under a degraded cloud uplink — the
model-state plane's worst case: every surviving server cold-loads at
once and the fetch paths contend; pair it with the "edge" storage
preset), three resilience storms — retry-amplification,
thundering-herd-rejoin, metastable-overload (crash + spike compositions
stressing the request-plane toolkit, core/resilience.py) — and chaos
(a seeded randomized churn stream from
core/chaos.py — the soak harness's always-on scenario). Generators
(`cascade_failures`, `rolling_failures`, `flaky_server`) compose into
custom scenarios.

Every scenario replay is also measured at the *request* level: while the
events above drive the control plane, the simulator's traffic plane
(core/traffic.py + core/metrics.py) streams per-app requests through the
epoch-versioned routing table, so each `ScenarioResult` carries
client-observed availability, MTTR, and accuracy-weighted goodput next
to the per-epoch controller records. `LoadSpike` is therefore no longer
cosmetic: the multiplied rates generate real extra requests (and
queueing-latency pressure) for the spike's duration.

Determinism guarantee: the scenario RNG is seeded from (name, seed)
independently of the workload RNG, and all request-level randomness
derives from the simulation seed — the same (name, seed, cluster)
yields the same event trace AND the same per-request trace; see
`ScenarioResult.fingerprint()`.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import Cluster
from repro_torch.core.variants import Application, synthetic_family


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScenarioEvent:
    t: float


@dataclass(frozen=True)
class ServerFail(ScenarioEvent):
    server: str = ""


@dataclass(frozen=True)
class SiteFail(ScenarioEvent):
    site: str = ""


@dataclass(frozen=True)
class ShardFail(ScenarioEvent):
    """Kill one server hosting a member of a tensor-parallel shard
    group. Physically identical to `ServerFail` (the whole host dies);
    the distinct event type marks the *intent* — stressing the shard
    plane's recovery ladder (degraded-TP continuation, reshard onto
    survivors, monolith fallback) — and keeps traces self-describing.
    With `tp_degree=1` (no groups) it behaves exactly like ServerFail."""
    server: str = ""


@dataclass(frozen=True)
class ServerRejoin(ScenarioEvent):
    server: str = ""


@dataclass(frozen=True)
class AppArrival(ScenarioEvent):
    app: Optional[Application] = None


@dataclass(frozen=True)
class AppDeparture(ScenarioEvent):
    app_id: str = ""


@dataclass(frozen=True)
class LoadSpike(ScenarioEvent):
    factor: float = 2.0
    duration: float = 5.0
    app_ids: Optional[Tuple[str, ...]] = None     # None = every app


@dataclass(frozen=True)
class LinkDegrade(ScenarioEvent):
    """Cut a storage link's bandwidth to `factor`x for `duration`
    seconds. `link` uses the model-state plane's link names
    (core/modelstate.py): "cloud", "nic:<server>", "disk:<server>"."""
    link: str = "cloud"
    factor: float = 0.5
    duration: float = 10.0


FAILURE_EVENTS = (ServerFail, SiteFail, ShardFail)


@dataclass
class Scenario:
    """A named, deterministic event trace."""
    name: str
    events: List[ScenarioEvent]
    horizon: float                 # sim runs until horizon (post-settle)
    description: str = ""

    def sorted_events(self) -> List[ScenarioEvent]:
        return sorted(self.events, key=lambda e: e.t)

    @property
    def n_failure_events(self) -> int:
        return sum(1 for e in self.events
                   if isinstance(e, FAILURE_EVENTS))

    def validate(self, cluster: Cluster) -> None:
        for e in self.events:
            if e.t < 0:
                raise ValueError(f"negative event time: {e}")
            if isinstance(e, (ServerFail, ServerRejoin, ShardFail)) \
                    and e.server not in cluster.servers:
                raise ValueError(f"unknown server in {e}")
            if isinstance(e, SiteFail) and e.site not in cluster.sites:
                raise ValueError(f"unknown site in {e}")
            if isinstance(e, LinkDegrade):
                if e.factor <= 0:
                    raise ValueError(f"non-positive degrade factor: {e}")
                if ":" in e.link:
                    kind, sid = e.link.split(":", 1)
                    if kind not in ("disk", "nic") \
                            or sid not in cluster.servers:
                        raise ValueError(f"unknown link in {e}")
                elif e.link != "cloud":
                    raise ValueError(f"unknown link in {e}")


# ---------------------------------------------------------------------------
# generators (compose into custom scenarios)
# ---------------------------------------------------------------------------

def _pick_servers(cluster: Cluster, rng: random.Random, n: int,
                  site: Optional[str] = None) -> List[str]:
    pool = (list(cluster.sites[site]) if site
            else sorted(s.id for s in cluster.alive_servers()))
    return rng.sample(pool, min(n, len(pool)))


def cascade_failures(cluster: Cluster, rng: random.Random, *,
                     t0: float = 1.0, waves: int = 3, per_wave: int = 2,
                     gap: float = 4.0) -> List[ScenarioEvent]:
    """Correlated cascade: failure waves every `gap` seconds, each wave
    hitting servers co-located with the previous wave when possible
    (overload/thermal spill inside a failure domain)."""
    events: List[ScenarioEvent] = []
    chosen: List[str] = []
    site: Optional[str] = None
    for w in range(waves):
        pool = [sid for sid in
                (cluster.sites[site] if site
                 else sorted(cluster.servers))
                if sid not in chosen]
        if not pool:           # domain exhausted: spill to a new site
            site = None
            pool = [sid for sid in sorted(cluster.servers)
                    if sid not in chosen]
            if not pool:
                break
        hit = rng.sample(pool, min(per_wave, len(pool)))
        chosen.extend(hit)
        site = cluster.servers[hit[0]].site
        events.extend(ServerFail(t=t0 + w * gap, server=sid)
                      for sid in hit)
    return events


def rolling_failures(cluster: Cluster, rng: random.Random, *,
                     n: int = 4, t0: float = 1.0, period: float = 4.0,
                     downtime: float = 6.0,
                     rejoin: bool = True) -> List[ScenarioEvent]:
    """Rolling outage (maintenance-style): one server down every
    `period` seconds, each rejoining `downtime` seconds later."""
    events: List[ScenarioEvent] = []
    for i, sid in enumerate(_pick_servers(cluster, rng, n)):
        t_fail = t0 + i * period
        events.append(ServerFail(t=t_fail, server=sid))
        if rejoin:
            events.append(ServerRejoin(t=t_fail + downtime, server=sid))
    return events


def flaky_server(cluster: Cluster, rng: random.Random, *,
                 cycles: int = 3, t0: float = 1.0, up: float = 4.0,
                 down: float = 2.0,
                 server: Optional[str] = None) -> List[ScenarioEvent]:
    """One node crash-looping: fails, rejoins, fails again."""
    sid = server or _pick_servers(cluster, rng, 1)[0]
    events: List[ScenarioEvent] = []
    t = t0
    for _ in range(cycles):
        events.append(ServerFail(t=t, server=sid))
        events.append(ServerRejoin(t=t + down, server=sid))
        t += down + up
    return events


def churn_apps(rng: random.Random, *, n: int = 3, t0: float = 0.5,
               spacing: float = 2.0, mem: float = 1.0e9,
               spread: float = 5.0,
               prefix: str = "late") -> List[ScenarioEvent]:
    """A stream of app arrivals with fresh synthetic ladders."""
    events: List[ScenarioEvent] = []
    for i in range(n):
        ladder = synthetic_family(f"{prefix}{i}", mem, n_variants=4,
                                  spread=spread)
        app = Application(id=f"{prefix}{i}", family=ladder[0].family,
                          variants=ladder,
                          request_rate=rng.uniform(0.5, 2.0),
                          # same finite SLO rule as setup-time apps
                          # (simulation.synthetic_apps), so churned
                          # apps are SLO-gated like everyone else
                          latency_slo=ladder[0].compute * 4.0,
                          critical=(i % 2 == 0))
        events.append(AppArrival(t=t0 + i * spacing, app=app))
    return events


# ---------------------------------------------------------------------------
# named scenario library
# ---------------------------------------------------------------------------

def _single_server(cluster, apps, rng) -> Scenario:
    sid = _pick_servers(cluster, rng, 1)[0]
    return Scenario(
        name="single-server",
        events=[ServerFail(t=1.0, server=sid)],
        horizon=30.0,
        description="the paper's base case: one server crash")


def _site_outage(cluster, apps, rng) -> Scenario:
    site = rng.choice(sorted(cluster.sites))
    return Scenario(
        name="site-outage",
        events=[SiteFail(t=1.0, site=site)],
        horizon=40.0,
        description="a whole failure domain (rack/pod) goes dark")


def _cascade(cluster, apps, rng) -> Scenario:
    events = cascade_failures(cluster, rng, t0=1.0, waves=3,
                              per_wave=2, gap=4.0)
    return Scenario(
        name="cascade",
        events=events,
        horizon=45.0,
        description="correlated cascade: three failure waves spilling "
                    "through co-located servers")


def _rolling_with_rejoin(cluster, apps, rng) -> Scenario:
    events = rolling_failures(cluster, rng, n=4, t0=1.0, period=4.0,
                              downtime=6.0, rejoin=True)
    return Scenario(
        name="rolling-with-rejoin",
        events=events,
        horizon=45.0,
        description="rolling outage; every node rejoins empty and is "
                    "re-filled by the re-protection loop")


def _churn_under_failure(cluster, apps, rng) -> Scenario:
    events: List[ScenarioEvent] = []
    events += churn_apps(rng, n=3, t0=0.5, spacing=2.0)
    # departures of existing apps (deterministic choice from the seed)
    if apps:
        leave = rng.sample(sorted(a.id for a in apps),
                           min(2, len(apps)))
        events += [AppDeparture(t=3.0 + i * 2.0, app_id=aid)
                   for i, aid in enumerate(leave)]
    events.append(LoadSpike(t=1.5, factor=3.0, duration=6.0))
    events.append(ServerFail(t=2.5,
                             server=_pick_servers(cluster, rng, 1)[0]))
    return Scenario(
        name="churn-under-failure",
        events=events,
        horizon=40.0,
        description="arrivals, departures, and a load spike around a "
                    "mid-churn server crash")


def _flaky_node(cluster, apps, rng) -> Scenario:
    events = flaky_server(cluster, rng, cycles=3, t0=1.0, up=5.0,
                          down=2.0)
    return Scenario(
        name="flaky-node",
        events=events,
        horizon=40.0,
        description="one node crash-looping three times; bookkeeping "
                    "must not double-count repeated failures")


def _cold_load_storm(cluster, apps, rng) -> Scenario:
    """The model-state plane's stress case: a whole site goes dark while
    the cloud uplink is degraded, so every affected app cold-loads at
    once and the fetch paths (peer NICs, shared uplink) contend. With
    the default local-everything storage this degenerates into a plain
    site outage; run it with the "edge" storage preset to see the
    contention (tools/bench_mttr.py does exactly that)."""
    site = rng.choice(sorted(cluster.sites))
    events: List[ScenarioEvent] = [
        SiteFail(t=1.0, site=site),
        LinkDegrade(t=1.0, link="cloud", factor=0.5, duration=30.0),
    ]
    return Scenario(
        name="cold-load-storm",
        events=events,
        horizon=45.0,
        description="site outage under a degraded cloud uplink: a storm "
                    "of simultaneous cold loads contending for fetch "
                    "bandwidth")


def _retry_amplification(cluster, apps, rng) -> Scenario:
    """The resilience layer's headline storm: a server crash immediately
    followed by a cluster-wide 3x load spike — the client-side retry
    wave a blackout triggers. Without the toolkit every spiked request
    against the dead primary is lost (and survivors drown in queueing);
    with it, hedges bridge to warm backups, breakers fail fast, and
    admission thins the spike during the recovery drain
    (tools/bench_resilience.py gates on-beats-off here)."""
    sid = _pick_servers(cluster, rng, 1)[0]
    events: List[ScenarioEvent] = [
        ServerFail(t=1.0, server=sid),
        LoadSpike(t=1.2, factor=3.0, duration=10.0),
    ]
    return Scenario(
        name="retry-amplification",
        events=events,
        horizon=35.0,
        description="server crash + immediate 3x retry wave: the storm "
                    "that erases MTTR wins without request shaping")


def _thundering_herd_rejoin(cluster, apps, rng) -> Scenario:
    """A whole site blacks out, then every one of its servers rejoins
    at the same instant while pent-up demand (2.5x spike) slams the
    cluster — rejoin refill and the spike contend for the same recovery
    drain."""
    site = rng.choice(sorted(cluster.sites))
    sids = sorted(cluster.sites[site])
    events: List[ScenarioEvent] = [SiteFail(t=1.0, site=site)]
    events += [ServerRejoin(t=9.0, server=s) for s in sids]
    events.append(LoadSpike(t=9.0, factor=2.5, duration=8.0))
    return Scenario(
        name="thundering-herd-rejoin",
        events=events,
        horizon=40.0,
        description="site outage, then all its servers rejoin at once "
                    "under a pent-up 2.5x demand wave")


def _metastable_overload(cluster, apps, rng) -> Scenario:
    """The metastable failure mode: a sustained (20 s) 2x overload with
    a crash at its start and a second crash mid-overload — the system
    must recover while queueing pressure never lets up, the regime
    where uncontrolled retries keep a healthy-capacity cluster
    saturated indefinitely."""
    sids = _pick_servers(cluster, rng, 2)
    events: List[ScenarioEvent] = [
        ServerFail(t=1.0, server=sids[0]),
        LoadSpike(t=1.5, factor=2.0, duration=20.0),
    ]
    if len(sids) > 1:
        events.append(ServerFail(t=7.0, server=sids[1]))
    return Scenario(
        name="metastable-overload",
        events=events,
        horizon=40.0,
        description="sustained 2x overload with two crashes inside it: "
                    "recovery under never-relenting queueing pressure")


def _tp_shard_storm(cluster, apps, rng) -> Scenario:
    """The shard plane's stress case: three staggered `ShardFail`
    kills against distinct servers with a load spike between them, so
    several tensor-parallel groups lose a member while demand is up.
    With `tp_degree=1` (the default) no groups exist and every kill is
    an ordinary server crash — the scenario still builds, validates,
    and replays deterministically. Pair it with `tp_degree>=2` and a
    `shard_policy` (degrade / reshard / monolith) to exercise the
    recovery ladder; `tools/bench_shardfail.py` sweeps exactly that."""
    sids = _pick_servers(cluster, rng, 3)
    events: List[ScenarioEvent] = [
        ShardFail(t=1.0 + 6.0 * i, server=sid)
        for i, sid in enumerate(sids)
    ]
    events.append(LoadSpike(t=2.0, factor=2.0, duration=8.0))
    return Scenario(
        name="tp-shard-storm",
        events=events,
        horizon=45.0,
        description="staggered shard-host kills under a 2x spike: "
                    "tensor-parallel groups lose members while demand "
                    "is elevated")


def _chaos(cluster, apps, rng) -> Scenario:
    """Seeded randomized churn stream (core/chaos.py): crashes with
    staggered rejoins, site blackouts, load spikes, and link degrades
    drawn from a marked Poisson process — the soak harness's scenario.
    Imported lazily: chaos.py composes the event vocabulary above."""
    from repro_torch.core.chaos import build_chaos
    return build_chaos(cluster, rng)


ScenarioBuilder = Callable[[Cluster, Sequence[Application],
                            random.Random], Scenario]

SCENARIOS: Dict[str, ScenarioBuilder] = {
    "single-server": _single_server,
    "site-outage": _site_outage,
    "cascade": _cascade,
    "rolling-with-rejoin": _rolling_with_rejoin,
    "churn-under-failure": _churn_under_failure,
    "flaky-node": _flaky_node,
    "cold-load-storm": _cold_load_storm,
    "retry-amplification": _retry_amplification,
    "thundering-herd-rejoin": _thundering_herd_rejoin,
    "metastable-overload": _metastable_overload,
    "tp-shard-storm": _tp_shard_storm,
    "chaos": _chaos,
}


def build_scenario(name: str, cluster: Cluster,
                   apps: Sequence[Application],
                   seed: int = 0) -> Scenario:
    """Materialize a named scenario deterministically from `seed`.

    The scenario RNG is independent of the simulator's workload RNG, so
    the same (name, seed, cluster) always yields the same event trace.
    """
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}")
    rng = random.Random(f"{name}:{seed}")
    sc = SCENARIOS[name](cluster, list(apps), rng)
    sc.validate(cluster)
    return sc
