"""Seeded randomized chaos streams — always-on failure churn.

The named scenario library (core/scenario.py) replays *curated* fault
sequences; the soak harness (tools/soak.py) needs *generated* ones:
long randomized churn streams that compose the whole event vocabulary —
server crashes with staggered rejoins, site blackouts, load spikes, and
link degrades — so the adaptive-protection loop is exercised against
faults nobody hand-picked.

`chaos_events()` draws a marked Poisson process over the stream
duration: event epochs arrive with exponential gaps, each epoch rolls
one event kind from `ChaosConfig`'s mixture weights. The generator
tracks which servers are down (every crash schedules its own rejoin)
and refuses to take the cluster below `1 - max_down_frac` alive — a
chaos stream must stress recovery, not make recovery impossible.

Everything derives from the `random.Random` handed in, so the same
(cluster, seed) yields the same stream — `Scenario` determinism and
`ScenarioResult.fingerprint()` reproducibility hold exactly as for the
curated library. The stream registers as the named scenario
``"chaos"`` (excluded from the pre-model-state golden-fingerprint set,
like ``cold-load-storm``).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List

from repro_torch.core.cluster import Cluster
from repro_torch.core.scenario import (LinkDegrade, LoadSpike, Scenario,
                                 ScenarioEvent, ServerFail, ServerRejoin,
                                 ShardFail, SiteFail)


@dataclass(frozen=True)
class ChaosConfig:
    """Shape of one chaos stream. The four kind weights form a mixture
    (they need not sum to 1; they are normalized)."""
    duration: float = 90.0        # event-injection window (sim s)
    t0: float = 1.0               # first possible event time
    mean_gap_s: float = 7.0       # exponential gap between event epochs
    w_server_fail: float = 0.45
    w_site_fail: float = 0.08
    w_spike: float = 0.22
    w_link_degrade: float = 0.25
    # shard-host kills (ShardFail). 0.0 by default so every existing
    # chaos stream is bit-identical; raise it on tp_degree>=2 configs
    # to fold shard failures into the soak mixture.
    w_shard_fail: float = 0.0
    rejoin_min_s: float = 6.0     # crash downtime bounds
    rejoin_max_s: float = 18.0
    site_stagger_s: float = 2.0   # extra rejoin delay per site member
    spike_lo: float = 2.0         # LoadSpike factor bounds
    spike_hi: float = 4.0
    spike_duration_s: float = 6.0
    degrade_lo: float = 0.3       # LinkDegrade factor bounds
    degrade_hi: float = 0.7
    degrade_duration_s: float = 12.0
    max_down_frac: float = 0.4    # never take > this fraction down


def chaos_events(cluster: Cluster, rng: random.Random,
                 cfg: ChaosConfig = ChaosConfig()) -> List[ScenarioEvent]:
    """One randomized churn stream over `cluster`, seeded by `rng`."""
    weights = (cfg.w_server_fail, cfg.w_site_fail, cfg.w_spike,
               cfg.w_link_degrade, cfg.w_shard_fail)
    total_w = sum(weights)
    events: List[ScenarioEvent] = []
    down_until = {sid: 0.0 for sid in cluster.servers}
    n_servers = len(cluster.servers)
    max_down = cfg.max_down_frac * n_servers
    t = cfg.t0
    while True:
        t += rng.expovariate(1.0 / cfg.mean_gap_s)
        if t >= cfg.t0 + cfg.duration:
            break
        alive = [sid for sid in sorted(cluster.servers)
                 if down_until[sid] <= t]
        n_down = n_servers - len(alive)
        roll = rng.random() * total_w
        if roll < weights[0]:                          # server crash
            if not alive or n_down + 1 > max_down:
                continue
            sid = rng.choice(alive)
            dt = rng.uniform(cfg.rejoin_min_s, cfg.rejoin_max_s)
            events.append(ServerFail(t=t, server=sid))
            events.append(ServerRejoin(t=t + dt, server=sid))
            down_until[sid] = t + dt
        elif roll < weights[0] + weights[1]:           # site blackout
            site = rng.choice(sorted(cluster.sites))
            members = [sid for sid in cluster.sites[site]
                       if down_until[sid] <= t]
            if not members or n_down + len(members) > max_down:
                continue
            events.append(SiteFail(t=t, site=site))
            base = rng.uniform(cfg.rejoin_min_s, cfg.rejoin_max_s)
            for k, sid in enumerate(members):
                dt = base + k * cfg.site_stagger_s
                events.append(ServerRejoin(t=t + dt, server=sid))
                down_until[sid] = t + dt
        elif roll < weights[0] + weights[1] + weights[2]:   # load spike
            events.append(LoadSpike(
                t=t, factor=rng.uniform(cfg.spike_lo, cfg.spike_hi),
                duration=cfg.spike_duration_s))
        elif roll < (weights[0] + weights[1] + weights[2]
                     + weights[3]):                    # link degrade
            if rng.random() < 0.5:
                link = "cloud"
            else:
                link = f"nic:{rng.choice(sorted(cluster.servers))}"
            events.append(LinkDegrade(
                t=t, link=link,
                factor=rng.uniform(cfg.degrade_lo, cfg.degrade_hi),
                duration=cfg.degrade_duration_s))
        else:                                          # shard-host kill
            # only reachable when w_shard_fail > 0 (roll < total_w);
            # same crash/rejoin bookkeeping as a server crash
            if not alive or n_down + 1 > max_down:
                continue
            sid = rng.choice(alive)
            dt = rng.uniform(cfg.rejoin_min_s, cfg.rejoin_max_s)
            events.append(ShardFail(t=t, server=sid))
            events.append(ServerRejoin(t=t + dt, server=sid))
            down_until[sid] = t + dt
    return events


def build_chaos(cluster: Cluster, rng: random.Random,
                cfg: ChaosConfig = ChaosConfig(),
                name: str = "chaos") -> Scenario:
    """A chaos stream as a `Scenario`, with at least one failure: a
    stream that happened to roll only spikes/degrades would make the
    soak's recovery metrics vacuous, so a deterministic fallback crash
    is injected."""
    events = chaos_events(cluster, rng, cfg)
    if not any(isinstance(e, (ServerFail, SiteFail, ShardFail))
               for e in events):
        sid = sorted(cluster.servers)[0]
        events.append(ServerFail(t=cfg.t0, server=sid))
        events.append(ServerRejoin(t=cfg.t0 + cfg.rejoin_min_s,
                                   server=sid))
    horizon = max(e.t + getattr(e, "duration", 0.0) for e in events) + 5.0
    return Scenario(
        name=name, events=events, horizon=horizon,
        description="seeded randomized churn: crashes with staggered "
                    "rejoins, site blackouts, load spikes, and link "
                    "degrades drawn from a marked Poisson process")
