"""The plain greedy planner against the port's, plan for plan, on random
clusters of the configurations' ladders, and the demands it places by
against the port's ladder."""

from __future__ import annotations

import numpy as np
import pytest

from bench import ladder, plans
from bench.reference import planner as RP
from bench.tests.test_bench_metrics import CONFIGS, config


def random_round(name, seed):
    from repro_torch.core.cluster import Server, Cluster
    from repro_torch.core.planner.base import PlanRequest
    from repro_torch.core.variants import Application, build_ladder
    from bench.harness import model_config
    rng = np.random.default_rng(seed)
    c = config(name)
    cfg = model_config(c)
    full = build_ladder(cfg)[0].mem_bytes
    n_sites, per_site = int(rng.integers(1, 4)), int(rng.integers(1, 4))
    servers = []
    for i in range(n_sites):
        for j in range(per_site):
            mem = full * float(rng.choice([1.0, 1.5, 2.0, 3.0]))
            servers.append(Server(id=f"s{i}-{j}", site=f"site{i}",
                                  capacity={"mem": mem, "compute": 1.0}))
    cluster = Cluster(servers)
    apps = []
    for k in range(int(rng.integers(1, 7))):
        apps.append(Application(
            id=f"app{k}", family=cfg.name,
            variants=build_ladder(cfg.replace(name=f"{cfg.name}.app{k}")),
            request_rate=float(rng.choice([0.5, 1.0, 2.0])),
            critical=bool(rng.integers(2))))
    primaries = {}
    for app in apps:
        sid = servers[int(rng.integers(len(servers)))].id
        v = app.variants[int(rng.integers(len(app.variants)))]
        role = str(rng.choice(["primary", "warm", "cold"]))
        if not cluster.servers[sid].fits(v.demand):
            role = "cold"
        cluster.place(app.id, v, sid, role)
        primaries[app.id] = sid
    for s in servers:
        if rng.random() < 0.25:
            cluster.fail_server(s.id)
    return PlanRequest(apps=apps, cluster=cluster, primaries=primaries,
                       alpha=float(rng.choice([0.0, 0.5, 0.95])),
                       site_independence=bool(rng.integers(2)))


@pytest.mark.parametrize("name", CONFIGS)
def test_plain_planner_equals_the_ports(name):
    from repro_torch.core.planner.policies import GreedyPlanner
    model = config(name)["model"]

    def demand(v):
        return np.array(ladder.demand(model, ladder.tag_of(v)), np.float64)
    placed = 0
    for seed in range(60):
        req = random_round(name, seed)
        rnd = plans._round(req)
        res = GreedyPlanner(backend="numpy").plan(req)
        want = {a: (v.name, sid) for a, (v, sid) in res.assignment.items()}
        got, unplaced = RP.plan(rnd, demand)
        assert got == want, seed
        assert sorted(unplaced) == sorted(res.unplaced), seed
        placed += len(got)
    assert placed > 60


@pytest.mark.parametrize("name", CONFIGS)
def test_rung_demands_equal_the_ports(name):
    from repro_torch.core.variants import build_ladder
    from bench.harness import model_config
    c = config(name)
    for v in build_ladder(model_config(c)):
        got = ladder.demand(c["model"], ladder.tag_of(v.name))
        assert np.array_equal(np.array(got), v.demand_vec), v.name
