"""The port's other planners against the JAX package's: legacy-greedy,
ilp, load-aware, locality and sharded, and the torch backend's latency
hook (the mask that gates K5's round) against numpy's
``plan_greedy(latency_fn=...)``.

Every instance is built twice from one seed, once from each package's
classes, and every comparison is exact: assignments, their order, the
unplaced list and the Eq. 1 objective bits.
"""

import inspect
import logging
import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cluster as jcluster  # noqa: E402
from repro.core import modelstate as jmodelstate  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import variants as jvariants  # noqa: E402
from repro.core.planner import sharded as jsharded  # noqa: E402
from repro_torch.core import cluster as tcluster  # noqa: E402
from repro_torch.core import modelstate as tmodelstate  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core import variants as tvariants  # noqa: E402
from repro_torch.core.planner import sharded as tsharded  # noqa: E402
from repro_torch.core.planner.torch_backend import (  # noqa: E402
    TorchPlanContext, latency_mask, plan_greedy_torch, prepare_round)

PKGS = {"jax": (jcluster, jvariants, jplanner, jmodelstate),
        "torch": (tcluster, tvariants, tplanner, tmodelstate)}
TORCH_CPU = {"backend": "torch", "device": "cpu"}


def _norm(res):
    return ({k: (v.name, s) for k, (v, s) in res.assignment.items()},
            list(getattr(res, "unplaced", ())))


def _same(a, b):
    assert _norm(a) == _norm(b)
    assert list(a.assignment) == list(b.assignment)
    assert a.objective == b.objective                  # bit-identical


# ---------------------------------------------------------------------------
# instances (tests/test_planner.py:24-55), from either package's classes
# ---------------------------------------------------------------------------

def _rand_cluster(pkg, rng: random.Random):
    cl = PKGS[pkg][0]
    servers = []
    for si in range(rng.randint(1, 3)):
        for sj in range(rng.randint(2, 5)):
            servers.append(cl.Server(
                id=f"s{si}-{sj}", site=f"site{si}",
                capacity={"mem": rng.uniform(6e9, 24e9),
                          "compute": rng.uniform(0.5, 2.0)}))
    return cl.Cluster(servers)


def _rand_apps(pkg, rng: random.Random, n: int, max_variants: int = 6):
    var = PKGS[pkg][1]
    out = []
    for i in range(n):
        lad = var.synthetic_family(f"f{i}", rng.uniform(0.3e9, 6e9),
                                   n_variants=rng.randint(2, max_variants),
                                   spread=rng.uniform(1.5, 12.0))
        out.append(var.Application(
            id=f"a{i}", family=f"f{i}", variants=lad,
            request_rate=rng.uniform(0.2, 3.0),
            latency_slo=(rng.uniform(0.005, 0.05)
                         if rng.random() < 0.5 else math.inf),
            critical=rng.random() < 0.5))
    return out


def _lat_fn(app, variant, server):
    """tests/test_planner.py:52: per-server distance + size term."""
    return (0.002 * (sum(map(ord, server.id)) % 7)
            + variant.mem_bytes / 1e12 + 0.001)


def _lat_fn_nan(app, variant, server):
    """About half the (variant, server) pairs over an SLO of 0.02, and a
    NaN (which numpy counts as allowed) on one pair in seven."""
    h = (sum(map(ord, server.id)) * 31 + sum(map(ord, variant.name))) % 97
    if h % 7 == 3:
        return math.nan
    return 0.04 * h / 97.0


def _instance(pkg, seed: int, *, latency: bool, dead: bool = True):
    """tests/test_planner.py:64's instance, with a dead server when asked:
    cluster, apps, and the plan keywords."""
    rng = random.Random(seed * 1009 + 7)
    cluster = _rand_cluster(pkg, rng)
    apps = _rand_apps(pkg, rng, rng.randint(1, 25))
    sids = list(cluster.servers)
    exclude = {a.id: {rng.choice(sids)} for a in apps
               if rng.random() < 0.7}
    site_exclude = {a.id: {f"site{rng.randrange(3)}"} for a in apps
                    if rng.random() < 0.3}
    alpha = rng.choice([0.0, 0.1, 0.25, 0.5])
    latency_fn = _lat_fn if latency else None
    for a in apps[::3]:
        sid = rng.choice(sids)
        if cluster.servers[sid].fits(a.variants[-1].demand):
            cluster.place(a.id, a.variants[-1], sid, "primary")
    if dead and len(sids) > 2 and rng.random() < 0.5:
        cluster.fail_server(rng.choice(sids))
    return cluster, apps, dict(exclude=exclude, site_exclude=site_exclude,
                               alpha=alpha, latency_fn=latency_fn)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_available_planners_equal_the_jax_packages():
    assert tplanner.available_planners() == jplanner.available_planners()
    for name in tplanner.available_planners():
        kw = TORCH_CPU if name in ("greedy", "sharded") else {}
        p = tplanner.get_planner(name, **kw)
        assert p.name == name
        assert p.realtime == jplanner.get_planner(name).realtime
    assert set(jplanner.__all__) - set(tplanner.__all__) == {"have_jax"}


def test_site_indexes_are_verbatim_copies():
    """SiteIndex and CoordinatedSiteIndex are the JAX package's code."""
    for cls in ("SiteIndex", "CoordinatedSiteIndex"):
        assert inspect.getsource(getattr(tsharded, cls)) == \
            inspect.getsource(getattr(jsharded, cls))


# ---------------------------------------------------------------------------
# legacy-greedy (tests/test_planner.py:64)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(20))
def test_legacy_matches_vectorized_and_jax(seed):
    """The port's legacy oracle equals its vectorized planner and the JAX
    package's legacy oracle, half the seeds with a latency_fn."""
    latency = seed % 2 == 0
    cl_j, apps_j, kw_j = _instance("jax", seed, latency=latency,
                                   dead=False)
    cl_t, apps_t, kw_t = _instance("torch", seed, latency=latency,
                                   dead=False)
    old_t = tplanner.faillite_heuristic_legacy(apps_t, cl_t, **kw_t)
    new_t = tplanner.faillite_heuristic(apps_t, cl_t, **kw_t)
    old_j = jplanner.faillite_heuristic_legacy(apps_j, cl_j, **kw_j)
    assert _norm(old_t) == _norm(new_t)
    assert old_t.objective == new_t.objective
    _same(old_t, old_j)
    req = tplanner.PlanRequest(apps=apps_t, cluster=cl_t, **kw_t)
    _same(tplanner.get_planner("legacy-greedy").plan(req), old_t)


# ---------------------------------------------------------------------------
# ilp (tests/test_planner.py:240, :440)
# ---------------------------------------------------------------------------

def _ilp_request(pkg, latency: bool):
    cl, _var, pl, _ms = PKGS[pkg]
    rng = random.Random(11)
    cluster = cl.make_cluster(2, 3, mem=8e9)
    apps = _rand_apps(pkg, rng, 6)
    primaries = {}
    for i, a in enumerate(apps):
        sid = cluster.alive_servers()[i % 6].id
        cluster.place(a.id, a.variants[-1], sid, "primary")
        primaries[a.id] = sid
    return pl.PlanRequest(apps=apps, cluster=cluster, primaries=primaries,
                          alpha=0.1,
                          latency_fn=_lat_fn if latency else None)


@pytest.mark.parametrize("latency", [False, True])
def test_ilp_matches_jax_and_dominates_greedy(latency):
    """The port's branch-and-bound (its incumbent the port's numpy
    greedy) gives the JAX package's assignment and objective, at least
    the greedy planner's on either backend, never on the primary."""
    got = tplanner.get_planner("ilp").plan(_ilp_request("torch", latency))
    want = jplanner.get_planner("ilp").plan(_ilp_request("jax", latency))
    assert _norm(got)[0] == _norm(want)[0]
    assert got.objective == want.objective
    assert (got.optimal, got.nodes) == (want.optimal, want.nodes)
    req = _ilp_request("torch", latency)
    for kw in (TORCH_CPU, {"backend": "numpy"}):
        greedy = tplanner.get_planner("greedy", **kw).plan(req)
        assert got.objective >= greedy.objective - 1e-6
    for aid, (_v, sid) in got.assignment.items():
        assert sid != req.primaries[aid]


def test_ilp_branch_frac_pinned_to_float64():
    from repro_torch.core.planner.ilp import _branch_frac

    x = np.array([0.50000002, 0.50000001])
    f = _branch_frac(x)
    assert f.dtype == np.float64 and int(np.argmax(f)) == 1
    assert _branch_frac(x.astype(np.float32)).dtype == np.float64


# ---------------------------------------------------------------------------
# load-aware and locality
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("diurnal", [False, True])
def test_load_aware_matches_jax(diurnal, seed):
    plans = {}
    for pkg in PKGS:
        cl, apps, kw = _instance(pkg, seed, latency=seed % 2 == 1)
        req = PKGS[pkg][2].PlanRequest(apps=apps, cluster=cl, now=37.0,
                                       **kw)
        plans[pkg] = PKGS[pkg][2].get_planner(
            "load-aware", diurnal=diurnal).plan(req)
    _same(plans["torch"], plans["jax"])


def _locality_plan(pkg, seed, registry: bool):
    cl_m, _var, pl, ms = PKGS[pkg]
    cluster, apps, kw = _instance(pkg, seed, latency=seed % 3 == 0)
    state = pl.PlannerState(cluster, subscribe=False)
    if registry:
        reg = ms.ModelRegistry(cluster, ms.StorageConfig(
            nic_bw=1e9, cloud_bw=0.5e9, replicate_all=False,
            replication=1))
        rng = random.Random(seed)
        sids = list(cluster.servers)
        for a in apps:
            for v in a.variants:
                if rng.random() < 0.5:
                    reg.stage(v.name, rng.choice(sids))
        state.attach_registry(reg)
    req = pl.PlanRequest(apps=apps, cluster=cluster, state=state, **kw)
    return pl.get_planner("locality", band=0.1).plan(req)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("registry", [True, False])
def test_locality_matches_jax(registry, seed):
    """With a registry the locality planner ranks headroom bands and
    breaks ties on fetch time; without one it is plain Algorithm 1."""
    _same(_locality_plan("torch", seed, registry),
          _locality_plan("jax", seed, registry))


# ---------------------------------------------------------------------------
# sharded (tests/test_scale.py:141-172, tests/test_planner.py:458-496)
# ---------------------------------------------------------------------------

def _scale_instance(n_apps, n_sites, per_site, seed):
    """tests/test_scale.py's instance, from the port's classes."""
    rng = np.random.default_rng(seed)
    servers = []
    for si in range(n_sites):
        for sj in range(per_site):
            servers.append(tcluster.Server(
                id=f"s{si}-{sj}", site=f"site{si}",
                capacity={"mem": float(rng.uniform(8e9, 32e9)),
                          "compute": float(rng.uniform(0.5, 2.0))}))
    cluster = tcluster.Cluster(servers)
    prng = random.Random(seed)
    apps = []
    for i in range(n_apps):
        lad = tvariants.synthetic_family(f"f{i}", prng.uniform(0.5e9, 4e9),
                                         n_variants=4)
        apps.append(tvariants.Application(
            id=f"a{i}", family=f"f{i}", variants=lad,
            request_rate=prng.uniform(0.5, 2.0),
            critical=prng.random() < 0.5))
    return apps, cluster


def _scale_cases():
    apps, cl = _scale_instance(60, 4, 6, 7)
    exclude = {a.id: {cl.alive_servers()[i % 4].id}
               for i, a in enumerate(apps)}
    site_exclude = {apps[0].id: {cl.alive_servers()[0].site}}
    yield "exclusions", apps, cl, dict(exclude=exclude,
                                       site_exclude=site_exclude)
    apps, cl = _scale_instance(50, 5, 4, 3)
    for s in cl.alive_servers()[::3]:
        cl.fail_server(s.id)
    yield "dead", apps, cl, {}
    for seed in (0, 1, 2):
        apps, cl = _scale_instance(120, 6, 8, seed)
        yield f"seed{seed}", apps, cl, {}


@pytest.mark.parametrize("case", ["exclusions", "dead", "seed0", "seed1",
                                  "seed2"])
def test_sharded_matches_greedy_on_both_backends(case):
    """sharded on torch (one round launch) and on numpy with 1, 2 and 3
    coordinators equals greedy, bit for bit."""
    _, apps, cl, kw = next(c for c in _scale_cases() if c[0] == case)
    req = tplanner.PlanRequest(apps=apps, cluster=cl, alpha=0.1, **kw)
    dense = tplanner.get_planner("greedy", backend="numpy").plan(req)
    for planner_kw in (TORCH_CPU, {"backend": "numpy"},
                       {"backend": "numpy", "coordinators": 2},
                       {"backend": "numpy", "coordinators": 3}):
        p = tplanner.get_planner("sharded", **planner_kw)
        _same(p.plan(req), dense)
        ran = "torch_rounds" if p.backend == "torch" else "sharded_rounds"
        assert p.stats[ran] == 1 and p.stats["fallback_dense"] == 0
        assert p.stats["coordinators"] == planner_kw.get("coordinators", 0)
    # the backend wins over the coordinators, as in the JAX package
    p = tplanner.get_planner("sharded", coordinators=2, **TORCH_CPU)
    _same(p.plan(req), dense)
    assert (p.stats["torch_rounds"], p.stats["sharded_rounds"]) == (1, 0)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_sharded_dense_fallback_warns_once_and_counts(backend, caplog):
    """A latency_fn request takes the dense path (on torch, the masked
    round), warned once per planner and counted per round; it equals the
    greedy planner's plan and the JAX package's."""
    rng = random.Random(21)
    cluster = _rand_cluster("torch", rng)
    apps = _rand_apps("torch", rng, 8)
    kw = TORCH_CPU if backend == "torch" else {"backend": "numpy"}
    planner = tplanner.get_planner("sharded", **kw)
    req = tplanner.PlanRequest(apps=apps, cluster=cluster, alpha=0.1,
                               latency_fn=_lat_fn)
    with caplog.at_level(logging.WARNING, "repro_torch.planner.sharded"):
        r1 = planner.plan(req)
        planner.plan(req)
    assert planner.stats["fallback_dense"] == 2
    assert planner.stats["torch_rounds"] == planner.stats[
        "sharded_rounds"] == 0
    warns = [r for r in caplog.records if "dense" in r.getMessage().lower()]
    assert len(warns) == 1
    _same(r1, tplanner.get_planner("greedy", backend="numpy").plan(req))
    jrng = random.Random(21)
    jcl = _rand_cluster("jax", jrng)
    japps = _rand_apps("jax", jrng, 8)
    want = jplanner.get_planner("greedy").plan(jplanner.PlanRequest(
        apps=japps, cluster=jcl, alpha=0.1, latency_fn=_lat_fn))
    _same(r1, want)


# ---------------------------------------------------------------------------
# the torch backend's latency hook
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed", range(20))
def test_torch_latency_round_matches_numpy(seed, dtype):
    """plan_greedy_torch with a latency_fn (the masked round's plain
    version on the CPU) equals numpy's plan_greedy(latency_fn=...) of
    both packages: exclusions, dead servers, NaN latencies."""
    fn = _lat_fn_nan if seed % 2 else _lat_fn
    cl_j, apps_j, kw_j = _instance("jax", seed, latency=True)
    cl_t, apps_t, kw_t = _instance("torch", seed, latency=True)
    kw_j["latency_fn"] = kw_t["latency_fn"] = fn
    want = jplanner.plan_greedy(apps_j, cl_j, state=jplanner.PlannerState(
        cl_j, subscribe=False, dtype=dtype), **kw_j)
    st = tplanner.PlannerState(cl_t, subscribe=False, dtype=dtype)
    got = plan_greedy_torch(apps_t, cl_t, state=st,
                            ctx=TorchPlanContext("cpu"), **kw_t)
    _same(got, want)
    _same(tplanner.plan_greedy(apps_t, cl_t, state=tplanner.PlannerState(
        cl_t, subscribe=False, dtype=dtype), **kw_t), want)


def test_latency_mask_layout_and_call_order():
    """The mask is (A, V, S) uint8 in placement order over global rows:
    dead rows and padded variants 0, NaN allowed; latency_fn is called
    once per (app, variant, alive server), in the numpy path's order."""
    cl, apps, kw = _instance("torch", 4, latency=True, dead=False)
    sids = list(cl.servers)
    cl.fail_server(sids[1])
    st = tplanner.PlannerState(cl, subscribe=False)
    st.sync()
    calls = []

    def fn(app, v, srv):
        calls.append((app.id, v.name, srv.id))
        return _lat_fn_nan(app, v, srv)

    order, start, nvar, inputs = prepare_round(
        apps, cl, st, kw["exclude"], kw["site_exclude"], kw["alpha"],
        TorchPlanContext("cpu"), fn)
    lat = inputs.lat
    alive = [s for s in sids if cl.servers[s].alive]
    assert calls == [(a.id, v.name, s) for a in apps for v in a.variants
                     for s in alive]
    V = inputs.dm.shape[1]
    assert lat.dtype == torch.uint8 and tuple(lat.shape) == (
        len(apps), V, len(sids)) and lat.is_contiguous()
    assert not lat[:, :, 1].any()
    for i, app in enumerate(order):
        assert not lat[i, len(app.variants):].any()
        for j, v in enumerate(app.variants):
            for s in alive:
                x = _lat_fn_nan(app, v, cl.servers[s])
                assert bool(lat[i, j, sids.index(s)]) == (
                    not x > app.latency_slo)
    again = latency_mask(apps, order, cl, st, st.alive_rows(), V,
                         _lat_fn_nan)
    assert np.array_equal(again, lat.numpy())
