"""Backend protocol + registry (port of ``repro/experiment/backends.py``):
one spec, two execution engines.

A `Backend` turns an `ExperimentSpec` into a `RunResult`. Two are
registered here:

  * ``sim`` — the discrete-event simulator (`core/simulation.py`):
    deterministic, seconds of wall clock for hundreds of apps, carries
    the bit-identical `fingerprint()` replay digest;
  * ``testbed`` — the thread-based mini-testbed (`serving/testbed.py`):
    PyTorch engines on live worker threads sharing the card, real
    heartbeats, real model loads, real client-measured request outcomes
    — the same `ScenarioEvent` stream replayed on a wall clock.

Both plan on `spec.device` (the card unless "cpu" is asked for) with the
greedy family's torch backend unless `spec.planner_backend` says
"numpy". Both run the shard plane for `tp_degree > 1` (the testbed's
tensor-parallel groups hold real weight slices on their workers,
`serving/shard.py`) and report it in ``extras["shard"]``.

Both resolve the scenario the same way (named library or a programmatic
`spec.scenario_builder(cluster, apps, rng)`) and both report through the
same `RunResult` schema, so `run_experiment(spec)` is the single entry
point of the repo and `spec.with_(backend=...)` is the only difference
between a simulated and a live run.
"""

from __future__ import annotations

import random
import time
from typing import Dict, Protocol, runtime_checkable

from repro_torch.core.scenario import Scenario, build_scenario
from repro_torch.experiment.result import RunResult
from repro_torch.experiment.spec import ExperimentSpec


@runtime_checkable
class Backend(Protocol):
    """Execution engine: materialize + run one spec."""
    name: str

    def run(self, spec: ExperimentSpec) -> RunResult: ...


BACKENDS: Dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    BACKENDS[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; "
                       f"have {sorted(BACKENDS)}") from None


def run_experiment(spec: ExperimentSpec) -> RunResult:
    """THE public entry point: run `spec` on its selected backend."""
    return get_backend(spec.backend).run(spec)


def resolve_scenario(spec: ExperimentSpec, cluster, apps) -> Scenario:
    """Named library or programmatic builder — same resolution on every
    backend, with the same (name, seed)-derived RNG."""
    if spec.scenario_builder is not None:
        rng = random.Random(f"{spec.scenario}:{spec.seed}")
        sc = spec.scenario_builder(cluster, list(apps), rng)
        sc.validate(cluster)
        return sc
    return build_scenario(spec.scenario, cluster, apps, seed=spec.seed)


def primary_kill_scenario(app_id=None, *, t_fail: float = 1.0,
                          horizon: float = 30.0):
    """Builder: crash the server hosting `app_id`'s primary (first app
    if None) — the paper's base experiment, victim chosen after
    placement so it is guaranteed to hit a serving replica."""
    from repro_torch.core.scenario import ServerFail

    def build(cluster, apps, rng) -> Scenario:
        target = app_id if app_id is not None else apps[0].id
        victim = next(
            s.id for s in cluster.servers.values()
            for inst in s.instances.values()
            if inst.app_id == target and inst.role == "primary")
        return Scenario(
            name="primary-kill",
            events=[ServerFail(t=t_fail, server=victim)],
            horizon=horizon,
            description=f"crash the server hosting {target}'s primary")
    return build


# ---------------------------------------------------------------------------
# sim backend
# ---------------------------------------------------------------------------

class SimBackend:
    name = "sim"

    def run(self, spec: ExperimentSpec) -> RunResult:
        from repro_torch.core.simulation import SimConfig, Simulation

        t0 = time.perf_counter()
        cfg_kw = dict(
            n_sites=spec.n_sites, servers_per_site=spec.servers_per_site,
            server_mem=spec.server_mem, headroom=spec.headroom,
            critical_frac=spec.critical_frac, alpha=spec.alpha,
            policy=spec.policy, site_independence=spec.site_independence,
            planner=spec.planner, seed=spec.seed,
            traffic_rate_scale=spec.traffic_rate_scale,
            traffic_chunk_s=spec.traffic_chunk_s,
            traffic_diurnal_amplitude=spec.traffic_diurnal_amplitude,
            traffic_diurnal_period=spec.traffic_diurnal_period,
            storage=spec.storage, scheduler=spec.scheduler,
            autopilot=spec.autopilot, resilience=spec.resilience,
            event_mode=spec.event_mode, planner_dtype=spec.planner_dtype,
            planner_backend=spec.planner_backend,
            planner_coordinators=spec.planner_coordinators,
            planner_device=spec.device,
            load_bw=spec.load_bw, warmup_s=spec.warmup_s,
            nic_bw=spec.nic_bw, cloud_bw=spec.cloud_bw,
            replication=spec.replication,
            tp_degree=spec.tp_degree, shard_policy=spec.shard_policy)
        apps = list(spec.apps) if spec.apps is not None else None
        if apps is None and spec.app_mix == "arch":
            from repro_torch.experiment.workload import (ARCH_COMPUTE_CAP,
                                                   arch_mem_cap,
                                                   build_arch_apps)
            apps = build_arch_apps(spec.archs,
                                   apps_per_arch=spec.apps_per_arch,
                                   critical_frac=spec.critical_frac,
                                   seed=spec.seed)
            n_servers = spec.n_sites * spec.servers_per_site
            # mirror the testbed's capacity rule exactly (no other-tenant
            # blockers either: headroom already shaped the sizing)
            cfg_kw.update(
                server_mem=arch_mem_cap(apps, n_servers, spec.headroom),
                server_compute=ARCH_COMPUTE_CAP, headroom=1.0)

        sim = Simulation(SimConfig(**cfg_kw), apps=apps).setup()
        scenario = resolve_scenario(spec, sim.cluster, sim.apps)
        run_kw = {}
        if spec.settle_s is not None:
            run_kw["settle"] = spec.settle_s
        res = sim.run_scenario(scenario, **run_kw)
        return RunResult(
            backend=self.name, scenario=scenario.name, policy=spec.policy,
            seed=spec.seed, n_epochs=res.n_epochs, per_epoch=res.per_epoch,
            overall=res.overall, warm_coverage=res.warm_coverage,
            records=res.records, unplaced_arrivals=res.unplaced_arrivals,
            n_apps_final=res.n_apps_final, traffic=res.traffic,
            plan_wall_s=sim.controller.plan_wall_s,
            wall_s=time.perf_counter() - t0, sim_result=res,
            extras={"protection": sim.protection_summary(),
                    "planner": sim.controller.planner_stats(),
                    **({"shard": sim.shard_summary()}
                       if spec.tp_degree > 1 else {})})


# ---------------------------------------------------------------------------
# testbed backend
# ---------------------------------------------------------------------------

class TestbedBackend:
    name = "testbed"

    def run(self, spec: ExperimentSpec) -> RunResult:
        from repro_torch.serving.testbed import MiniTestbed

        if spec.autopilot:
            raise ValueError(
                "autopilot needs the simulator's live metrics feed; "
                "run the spec with backend='sim'")
        t0 = time.perf_counter()
        tb = MiniTestbed(
            n_sites=spec.n_sites, servers_per_site=spec.servers_per_site,
            apps_per_arch=spec.apps_per_arch,
            critical_frac=spec.critical_frac, headroom=spec.headroom,
            policy=spec.policy, planner=spec.planner, alpha=spec.alpha,
            site_independence=spec.site_independence, seed=spec.seed,
            archs=spec.archs, storage=spec.storage,
            scheduler=spec.scheduler, load_bw=spec.load_bw,
            warmup_s=spec.warmup_s, nic_bw=spec.nic_bw,
            cloud_bw=spec.cloud_bw, replication=spec.replication,
            resilience=spec.resilience,
            tp_degree=spec.tp_degree, shard_policy=spec.shard_policy,
            apps=list(spec.apps) if spec.apps is not None else None,
            device=spec.device, planner_backend=spec.planner_backend,
            planner_coordinators=spec.planner_coordinators)
        try:
            tb.deploy()
            scenario = resolve_scenario(spec, tb.cluster, tb.apps)
            out = tb.run_scenario(
                scenario, time_scale=spec.time_scale,
                settle_s=spec.settle_s, client_hz=spec.client_hz)
        finally:
            tb.shutdown()
        ctl = tb.controller
        return RunResult(
            backend=self.name, scenario=scenario.name, policy=spec.policy,
            seed=spec.seed, n_epochs=out["n_epochs"],
            per_epoch=out["per_epoch"], overall=out["overall"],
            warm_coverage=out["warm_coverage"], records=out["records"],
            unplaced_arrivals=out["unplaced_arrivals"],
            n_apps_final=len(ctl.apps), traffic=out["traffic"],
            plan_wall_s=ctl.plan_wall_s,
            wall_s=time.perf_counter() - t0,
            detect_latency_s=out["detect_latency_s"],
            extras={"client_stats": out["client_stats"],
                    "load_calibration": out.get("load_calibration", {}),
                    "load_errors": out["load_errors"],
                    "refused_no_slot": out["refused_no_slot"],
                    "planner": ctl.planner_stats(),
                    **({"shard": out.get("shard", {})}
                       if spec.tp_degree > 1 else {})})


register_backend(SimBackend())
register_backend(TestbedBackend())
