"""The port's shard plane (core/shardgroup.py) and SLO autopilot
(core/autopilot.py), and the simulator that drives them, against the
JAX package's.

The first half mirrors the simulator side of tests/test_shardgroup.py and
tests/test_autopilot.py on the port's classes (the torch planner backend
on the CPU); the second holds the port's ``Simulation`` fingerprints equal
to the JAX ``Simulation``'s on both planner backends.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from repro.core.simulation import SimConfig as JaxSimConfig  # noqa: E402
from repro.core.simulation import Simulation as JaxSimulation  # noqa: E402
from repro_torch.core.autopilot import (AppSignal, AutopilotConfig,  # noqa: E402,E501
                                        AutopilotPolicy, AutopilotView)
from repro_torch.core.controller import RecoveryScheduler  # noqa: E402
from repro_torch.core.scenario import (Scenario, ServerFail,  # noqa: E402
                                       ShardFail)
from repro_torch.core.simulation import SimConfig, Simulation  # noqa: E402
from repro_torch.core.variants import (Application,  # noqa: E402
                                       synthetic_family)

CPU = {"planner_device": "cpu"}
BACKENDS = {"torch": CPU, "numpy": {"planner_backend": "numpy"}}
SHARD_POLICIES = ("auto", "degrade", "reshard", "monolith")


def _shard_sim(policy, **kw):
    cfg = dict(n_sites=3, servers_per_site=3, seed=0, headroom=0.25,
               tp_degree=2, shard_policy=policy, storage="edge", **CPU)
    cfg.update(kw)
    return Simulation(SimConfig(**cfg)).setup()


def _kill_member(sim, app_id, *, lead=False):
    g = sim.shards.groups[app_id]
    rank = min(g.members) if lead else max(g.members)
    victim = g.members[rank].server_id
    return sim.run_scenario(Scenario(
        name="one-shard", horizon=25.0,
        events=[ShardFail(t=1.0, server=victim)]))


# ---------------------------------------------------------------------------
# shard plane (tests/test_shardgroup.py:37-168, simulator side)
# ---------------------------------------------------------------------------

def test_deploy_group_spans_distinct_servers():
    sim = _shard_sim("auto")
    assert sim.shards is not None and sim.shards.groups
    for app in sim.apps:
        g = sim.shards.groups[app.id]
        sids = [m.server_id for m in g.members.values()]
        assert len(g.members) == 2 and len(set(sids)) == 2
        assert g.state == "live"
        srv, vname = sim.controller.routing.routes[app.id]
        assert srv == g.lead.server_id and vname == app.full.name
        for rank in g.members:
            sv = sim.shards.slice_variant(app.full, rank)
            assert sv.mem_bytes == pytest.approx(app.full.mem_bytes / 2)
    sim.shards.check_conservation()


def test_auto_policy_resolves_by_criticality():
    sim = _shard_sim("auto")
    for gid, g in sim.shards.groups.items():
        app = sim.controller.apps[gid]
        assert g.policy == ("degrade" if app.critical else "reshard")


def test_tp1_keeps_shardfail_identical_to_serverfail():
    def run(ev_cls):
        sim = Simulation(SimConfig(n_sites=2, servers_per_site=3, seed=0,
                                   **CPU)).setup()
        assert sim.shards is None
        victim = sim.controller.primaries[sim.apps[0].id]
        return sim.run_scenario(Scenario(
            name="x", horizon=20.0,
            events=[ev_cls(t=1.0, server=victim)])).fingerprint()
    assert run(ShardFail) == run(ServerFail)


def test_degrade_continuation():
    sim = _shard_sim("degrade")
    app = sim.apps[0]
    res = _kill_member(sim, app.id)
    g = sim.shards.groups[app.id]
    assert g.state == "degraded" and len(g.members) == 1
    rec = next(r for r in res.records if r.app_id == app.id)
    assert rec.mode == "shard-degrade" and rec.recovered
    assert rec.phases["repartition"] > 0 and "fetch" not in rec.phases
    dv = sim.shards.lookup_variant(rec.variant)
    assert dv is not None and dv.name.endswith("::tp1of2")
    assert all(v.name != dv.name for v in app.variants)
    assert dv.accuracy < app.full.accuracy
    assert dv.compute > app.full.compute / 2
    sim.shards.check_conservation()


def test_degrade_of_nonlead_is_seamless_lead_is_not():
    sim = _shard_sim("degrade")
    app = sim.apps[0]
    g = sim.shards.groups[app.id]
    assert app.id not in sim.shards.darkened_by(
        {g.members[max(g.members)].server_id})
    assert app.id in sim.shards.darkened_by({g.lead.server_id})


def test_reshard_restores_full_tp():
    sim = _shard_sim("reshard")
    app = sim.apps[0]
    res = _kill_member(sim, app.id)
    g = sim.shards.groups[app.id]
    assert g.state == "live" and len(g.members) == 2
    assert g.pending is None
    assert len({m.server_id for m in g.members.values()}) == 2
    rec = next(r for r in res.records if r.app_id == app.id)
    assert rec.mode == "shard-reshard" and rec.recovered
    assert rec.phases["fetch"] > 0 and rec.phases["repartition"] > 0
    assert rec.mttr > sim.shards.repartition_seconds(
        sim.shards.slice_variant(app.full, 0), 1)
    sim.shards.check_conservation()


def test_monolith_fallback_dissolves_group():
    sim = _shard_sim("monolith")
    app = sim.apps[0]
    res = _kill_member(sim, app.id)
    g = sim.shards.groups[app.id]
    assert g.state == "fallen-back" and not g.members
    assert not sim.shards.is_grouped(app.id)
    rec = next(r for r in res.records if r.app_id == app.id)
    assert rec.recovered
    assert "shard-monolith" in sim.shards.summary()["actions"]
    sim.shards.check_conservation()


def test_ladder_client_mttr_ordering():
    mttr = {}
    for policy in ("degrade", "reshard", "monolith"):
        sim = _shard_sim(policy, servers_per_site=4)
        t = sim.run_named_scenario("tp-shard-storm").traffic
        assert math.isfinite(t.client_mttr_avg), policy
        mttr[policy] = t.client_mttr_avg
    assert mttr["degrade"] < mttr["reshard"] < mttr["monolith"]


def test_second_loss_of_degraded_group_falls_back():
    sim = _shard_sim("degrade")
    app = sim.apps[0]
    g = sim.shards.groups[app.id]
    s1 = g.members[max(g.members)].server_id
    s2 = g.lead.server_id
    sim.run_scenario(Scenario(name="double", horizon=30.0, events=[
        ShardFail(t=1.0, server=s1), ShardFail(t=8.0, server=s2)]))
    assert g.state == "fallen-back"
    summary = sim.shards.summary()
    assert summary["actions"]["shard-degrade"] >= 1
    assert summary["actions"].get("shard-monolith", 0) >= 1
    sim.shards.check_conservation()


# ---------------------------------------------------------------------------
# autopilot (tests/test_autopilot.py:95-221)
# ---------------------------------------------------------------------------

def _app(aid, rate, critical=False):
    return Application(id=aid, family=f"fam-{aid}",
                       variants=synthetic_family(f"fam-{aid}", 2e9),
                       request_rate=rate, critical=critical)


def _view(apps, rates, *, now=0.0, warm=None, fails=(), pilot=None):
    prot = (pilot.protected if pilot is not None
            and pilot.protected is not None else None)
    return AutopilotView(
        now=now, apps={a.id: a for a in apps},
        warm_ids=set(warm if warm is not None
                     else (prot or [a.id for a in apps if a.critical])),
        signals={aid: AppSignal(rate=r) for aid, r in rates.items()},
        fail_times=list(fails))


def _sim(**kw):
    base = dict(n_sites=3, servers_per_site=4, headroom=0.2,
                policy="faillite", seed=0, **CPU)
    base.update(kw)
    return Simulation(SimConfig(**base)).setup()


def test_autopilot_promotes_hot_app_within_static_budget():
    apps = [_app("crit", 5.0, critical=True), _app("hot", 1.0),
            _app("cold", 0.5)]
    dec = AutopilotPolicy().decide(_view(apps, {"crit": 0.1, "hot": 50.0,
                                                "cold": 0.2}))
    assert dec.budget == 1
    assert dec.protected == ["hot"]
    assert dec.promote == ["hot"] and dec.demote == ["crit"]


def test_autopilot_hysteresis_keeps_incumbent_on_small_edge():
    apps = [_app("a", 5.0, critical=True), _app("b", 1.0)]
    pilot = AutopilotPolicy(AutopilotConfig(rate_ewma=1.0))
    pilot.decide(_view(apps, {"a": 10.0, "b": 1.0}))
    dec = pilot.decide(_view(apps, {"a": 10.0, "b": 10.5}))
    assert dec.protected == ["a"] and not dec.demote


def test_autopilot_move_cap_limits_swaps_per_sweep():
    apps = ([_app(f"c{i}", 1.0, critical=True) for i in range(4)]
            + [_app(f"n{i}", 1.0) for i in range(4)])
    pilot = AutopilotPolicy(AutopilotConfig(rate_ewma=1.0, max_moves=2))
    rates = {f"c{i}": 1.0 for i in range(4)}
    rates.update({f"n{i}": 100.0 for i in range(4)})
    dec = pilot.decide(_view(apps, rates))
    assert len(dec.promote) == 2
    assert len(dec.protected) == 4


def test_autopilot_replication_bumps_with_hazard():
    apps = [_app("a", 1.0, critical=True)]
    pilot = AutopilotPolicy()
    calm = pilot.decide(_view(apps, {"a": 1.0}, now=100.0))
    assert calm.hazard == 0 and calm.replication == 2
    hot = pilot.decide(_view(apps, {"a": 1.0}, now=100.0,
                             fails=[80.0, 85.0, 95.0]))
    assert hot.hazard == 3 and hot.replication == 4
    mild = pilot.decide(_view(apps, {"a": 1.0}, now=100.0, fails=[95.0]))
    assert mild.replication == 3


def test_autopilot_trough_shrinks_budget_and_snaps_back():
    cfg = AutopilotConfig(diurnal_amplitude=0.5, diurnal_period=100.0,
                          lead_s=5.0, calm_frac=0.5)
    apps = [_app(f"c{i}", 1.0, critical=True) for i in range(4)]
    pilot = AutopilotPolicy(cfg)
    rates = {a.id: 1.0 for a in apps}
    trough_t = min((pilot._factor(t), t) for t in range(0, 100, 5))[1]
    peak_t = max((pilot._factor(t), t) for t in range(0, 100, 5))[1]
    assert pilot.in_trough(trough_t) and not pilot.in_trough(peak_t)
    assert pilot.decide(_view(apps, rates, now=trough_t)).budget == 2
    assert pilot.decide(_view(apps, rates, now=peak_t)).budget == 4
    risky = pilot.decide(_view(apps, rates, now=trough_t,
                               fails=[trough_t - 1.0]))
    assert risky.budget == 4


class _RecordingExecutor:
    def __init__(self):
        self.order = []
        self.pending = []

    def load(self, app, variant, server_id, on_ready):
        self.order.append(app.id)
        self.pending.append(on_ready)
        return None


@pytest.mark.parametrize("boosted", [True, False])
def test_scheduler_boosts_reorder_criticality_drain(boosted):
    """The drain scheduler's restored boost slot: a boosted low-rate app
    drains before a higher-rate one; without boosts, rate order."""
    ex = _RecordingExecutor()
    sched = RecoveryScheduler(ex, mode="criticality")
    if boosted:
        sched.set_boosts({"slow": 100.0})
    apps = [_app("first", 9.0), _app("fast", 5.0), _app("slow", 1.0)]
    for a in apps:
        sched.submit(a, a.smallest, "s0", lambda t: None)
    assert ex.order == ["first"]
    ex.pending[0](1.0)
    ex.pending[1](2.0)
    assert ex.order == (["first", "slow", "fast"] if boosted
                        else ["first", "fast", "slow"])


def test_autopilot_chaos_run_is_deterministic():
    def run():
        sim = _sim(autopilot=True, traffic_diurnal_amplitude=0.5,
                   traffic_diurnal_period=120.0)
        return sim.run_named_scenario("chaos").fingerprint()

    assert run() == run()


def test_autopilot_off_path_has_no_policy_attached():
    sim = _sim()
    assert sim.controller.autopilot is None
    on = _sim(autopilot=True)
    assert on.controller.autopilot is not None
    assert on.controller.autopilot.protected is None
    assert on.controller.metrics_feed is not None


# ---------------------------------------------------------------------------
# the port's Simulation against the JAX package's
# ---------------------------------------------------------------------------

def _fingerprints(name, **kw):
    jsim = JaxSimulation(JaxSimConfig(**kw)).setup()
    want = jsim.run_named_scenario(name)
    out = {}
    for b, extra in BACKENDS.items():
        sim = Simulation(SimConfig(**kw, **extra)).setup()
        out[b] = (sim, sim.run_named_scenario(name))
    return jsim, want, out


@pytest.mark.parametrize("policy", SHARD_POLICIES)
def test_shard_storm_matches_jax(policy):
    """tp_degree 2 under each shard policy on tp-shard-storm
    (tools/bench_shardfail.py's smoke shape): equal fingerprints, shard
    summaries and placements on both planner backends."""
    jsim, want, got = _fingerprints(
        "tp-shard-storm", n_sites=3, servers_per_site=4, seed=0,
        headroom=0.25, tp_degree=2, shard_policy=policy, storage="edge")
    assert want.records
    for b, (sim, res) in got.items():
        assert res.fingerprint() == want.fingerprint(), b
        assert sim.shard_summary() == jsim.shard_summary(), b
        assert dict(sim.controller.routing.routes) == \
            dict(jsim.controller.routing.routes), b


def test_autopilot_chaos_matches_jax():
    jsim, want, got = _fingerprints(
        "chaos", n_sites=3, servers_per_site=4, headroom=0.2,
        policy="faillite", seed=0, autopilot=True,
        traffic_diurnal_amplitude=0.5, traffic_diurnal_period=120.0)
    for b, (sim, res) in got.items():
        assert res.fingerprint() == want.fingerprint(), b
        assert sim.controller.autopilot.last.protected == \
            jsim.controller.autopilot.last.protected, b
        assert sim.controller.planner_stats()[f"{b}_rounds"] > 0, b
