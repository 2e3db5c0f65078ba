"""The port's simulator against the JAX package's, end to end.

The JAX ``Simulation`` (numpy planner) and the port's ``Simulation`` —
once with ``planner_backend="numpy"`` and once with ``"torch"`` on the
CPU — run the same ``SimConfig``. Every epoch's recovery records (app,
variant, warm or cold, MTTR), the servers the apps end on, the recovery
rate, the number of affected apps and the traffic summary must be equal.
"""

import pytest

torch = pytest.importorskip("torch")

from repro.core.simulation import SimConfig as JaxSimConfig  # noqa: E402
from repro.core.simulation import Simulation as JaxSimulation  # noqa: E402
from repro_torch.core.simulation import SimConfig, Simulation  # noqa: E402

BACKENDS = {"numpy": {}, "torch": {"planner_device": "cpu"}}
SCENARIOS = ["site-outage", "cascade", "rolling-with-rejoin"]


def _record(r):
    return (r.epoch, r.app_id, r.recovered, r.mttr, r.variant, r.accuracy,
            r.mode, r.upgraded_to, r.t_fail, r.source)


def _placement(sim):
    ctl = sim.controller
    return (dict(ctl.primaries),
            {a: (v.name, sid) for a, (v, sid, _k) in ctl.warm.items()},
            dict(ctl.routing.routes))


def _traffic(summary):
    return None if summary is None else summary.fingerprint()


def _inject(sim_cls, cfg_cls, **kw):
    """tests/test_planner.py:515: one primary's server fails."""
    cfg = cfg_cls(n_sites=2, servers_per_site=3, server_mem=24e9,
                  planner="greedy", traffic_rate_scale=0.0, seed=11, **kw)
    sim = sim_cls(cfg).setup()
    victim = sim.controller.primaries[next(iter(sim.controller.apps))]
    res = sim.inject_failure(servers=[victim], run_for=30.0)
    return sim, res


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_inject_failure_matches_jax(backend):
    sim_j, res_j = _inject(JaxSimulation, JaxSimConfig)
    sim_t, res_t = _inject(Simulation, SimConfig, planner_backend=backend,
                           **BACKENDS[backend])
    assert res_j.n_affected > 0
    assert (res_t.recovery_rate, res_t.n_affected, res_t.mttr_avg,
            res_t.accuracy_reduction) == \
        (res_j.recovery_rate, res_j.n_affected, res_j.mttr_avg,
         res_j.accuracy_reduction)
    assert sorted(map(_record, res_t.records.values())) == \
        sorted(map(_record, res_j.records.values()))
    assert _placement(sim_t) == _placement(sim_j)
    stats = sim_t.controller.planner_stats()
    assert stats["backend"] == backend
    assert stats[f"{backend}_rounds"] > 0
    assert set(stats) == {"name", "backend", "coordinators",
                          "torch_rounds", "numpy_rounds"}
    assert stats["coordinators"] == 0


def _scenario(sim_cls, cfg_cls, name, **kw):
    cfg = cfg_cls(n_sites=3, servers_per_site=4, server_mem=24e9,
                  planner="greedy", traffic_rate_scale=4.0,
                  traffic_chunk_s=0.5, seed=3, **kw)
    sim = sim_cls(cfg).setup()
    return sim, sim.run_named_scenario(name)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("name", SCENARIOS)
def test_named_scenarios_match_jax(name, backend):
    sim_j, res_j = _scenario(JaxSimulation, JaxSimConfig, name)
    sim_t, res_t = _scenario(Simulation, SimConfig, name,
                             planner_backend=backend, **BACKENDS[backend])
    assert res_j.records and res_j.traffic is not None
    assert res_t.n_epochs == res_j.n_epochs
    assert [sorted(map(_record, ep.values()))
            for ep in sim_t.controller.epoch_records] == \
        [sorted(map(_record, ep.values()))
         for ep in sim_j.controller.epoch_records]
    assert res_t.per_epoch == res_j.per_epoch
    assert res_t.overall == res_j.overall
    assert res_t.overall["recovery_rate"] == res_j.overall["recovery_rate"]
    assert (res_t.warm_coverage, res_t.unplaced_arrivals,
            res_t.n_apps_final) == (res_j.warm_coverage,
                                    res_j.unplaced_arrivals,
                                    res_j.n_apps_final)
    assert _traffic(res_t.traffic) == _traffic(res_j.traffic)
    assert res_t.fingerprint() == res_j.fingerprint()
    assert _placement(sim_t) == _placement(sim_j)
    assert sim_t.controller.planner_stats()[f"{backend}_rounds"] > 0


def test_torch_backend_needs_a_card_and_cuts_raise():
    """The torch backend is the default and needs a card unless the CPU
    is asked for; the planes the port's first simulator left out (the
    autopilot, the shard plane, the other planners) build and run."""
    assert SimConfig().planner_backend == "torch"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Simulation(SimConfig())
        with pytest.raises(RuntimeError, match="CUDA"):
            Simulation(SimConfig(planner_backend="torch"))
    with pytest.raises(ValueError, match="'torch'"):
        Simulation(SimConfig(planner_backend="jax"))
    small = dict(n_sites=2, servers_per_site=3, seed=0,
                 planner_device="cpu")
    on = Simulation(SimConfig(autopilot=True, **small))
    assert on.controller.autopilot is not None
    assert on.controller.metrics_feed is not None
    tp = Simulation(SimConfig(tp_degree=2, **small)).setup()
    assert tp.shards is not None and tp.shards.groups
    assert tp.shard_summary() is not None
    for planner in ("ilp", "sharded", "load-aware", "locality",
                    "legacy-greedy"):
        sim = Simulation(SimConfig(planner=planner, **small))
        assert sim.controller.planner.name == planner
    with pytest.raises(KeyError, match="unknown planner"):
        Simulation(SimConfig(planner="nope", **small))
