"""The port's planner against the JAX package's: K5's plain version
against the numpy oracle and the interpret-mode Pallas kernel, the torch
planner backend (``plan_greedy_torch`` on the CPU) against numpy's
``vectorized.plan_greedy``, and the port's copies of the numpy planner,
``PlannerState`` and ``Cluster`` against the originals.

Every comparison is exact: indices, values, assignments, their order,
and the Eq. 1 objective bits. The same instance is built twice from one
seed, once from each package's classes.
"""

import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cluster as jcluster  # noqa: E402
from repro.core import variants as jvariants  # noqa: E402
from repro.core.planner import state as jstate  # noqa: E402
from repro.core.planner import vectorized as jvec  # noqa: E402
from repro.kernels.planner_argmax.ops import masked_argmax as jmasked_argmax  # noqa: E402,E501
from repro.kernels.planner_argmax.ref import masked_argmax_ref  # noqa: E402
from repro_torch.core import cluster as tcluster  # noqa: E402
from repro_torch.core import variants as tvariants  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core.planner import kernels as tkernels  # noqa: E402
from repro_torch.core.planner import state as tstate  # noqa: E402
from repro_torch.core.planner import vectorized as tvec  # noqa: E402
from repro_torch.core.planner.torch_backend import (  # noqa: E402
    TorchPlanContext, plan_greedy_torch)
from repro_torch.kernels.planner_argmax import ops as k5  # noqa: E402
from repro_torch.kernels.planner_argmax import ref as tref  # noqa: E402

try:                                       # dev extra — seeded sweep
    from hypothesis import given, settings  # when not installed
    from hypothesis import strategies as hst
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

PKGS = {"jax": (jcluster, jvariants), "torch": (tcluster, tvariants)}


# ---------------------------------------------------------------------------
# K5: masked argmax
# ---------------------------------------------------------------------------

def _argmax_cases(rng, n, dtype):
    """(values, mask) pairs: random and tied values (rounded, and all
    equal) under sparse, dense, empty and full masks."""
    vals = rng.standard_normal(n).astype(dtype)
    out = []
    for v in (vals, np.round(vals), np.full(n, 0.5, dtype)):
        for mask in (rng.random(n) < 0.1, rng.random(n) < 0.7,
                     np.zeros(n, bool), np.ones(n, bool)):
            out.append((v.astype(dtype), mask))
    return out


@pytest.mark.parametrize("n", [1, 7, 300, 1000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_masked_argmax_plain_matches_ref_and_pallas(dtype, n):
    """K5's plain version (the CPU path of ``ops.masked_argmax``) equals
    the numpy oracle and the Pallas kernel in interpret mode exactly:
    the first maximum, ties to the smaller index, (-1, -inf) on an empty
    mask; S not a multiple of the kernel's 512 and S = 1."""
    rng = np.random.default_rng(n * 7 + (dtype == np.float64))
    for v, mask in _argmax_cases(rng, n, dtype):
        wi, wv = masked_argmax_ref(v, mask)
        assert tref.masked_argmax_ref(v, mask) == (wi, wv)
        gi, gv = k5.masked_argmax(torch.from_numpy(v),
                                  torch.from_numpy(mask))
        assert gi.dtype == torch.int32 and gv.dtype == torch.from_numpy(
            v).dtype
        assert (int(gi), float(gv)) == (int(wi), float(wv))
    # the TPU kernel itself, on the tied values (interpret mode compiles
    # per call, so one value kind)
    with jax.enable_x64(True):
        for v, mask in _argmax_cases(rng, n, dtype)[4:8]:
            wi, wv = masked_argmax_ref(v, mask)
            pi, pv = jmasked_argmax(jnp.asarray(v), jnp.asarray(mask),
                                    impl="pallas", block=128,
                                    interpret=True)
            assert pv.dtype == v.dtype
            assert (int(pi), float(pv)) == (int(wi), float(wv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_argmax_rows_share_one_column(dtype):
    """The batched form the planner calls: (V, S) masks over one (S,)
    headroom column broadcast with a row stride of 0; each row equals
    the oracle on that row."""
    rng = np.random.default_rng(5)
    S, V = 257, 8
    head = torch.from_numpy(np.round(rng.standard_normal(S) * 2)).to(dtype)
    mask = torch.from_numpy(rng.random((V, S)) < 0.3)
    mask[3] = False
    mask[5] = True
    vals = head.expand(V, S)
    assert vals.stride(0) == 0
    idx, val = k5.masked_argmax(vals, mask)
    assert idx.shape == (V,) and val.shape == (V,)
    for r in range(V):
        wi, wv = masked_argmax_ref(head.numpy(), mask[r].numpy())
        assert (int(idx[r]), float(val[r])) == (wi, float(wv))
    assert int(idx[3]) == -1 and float(val[3]) == -math.inf


def test_masked_argmax_rejects_what_the_kernel_does_not_take():
    v = torch.zeros(4)
    with pytest.raises(ValueError, match="one shape"):
        k5.masked_argmax(v, torch.zeros(5, dtype=torch.bool))
    with pytest.raises(TypeError, match="bool"):
        k5.masked_argmax(v, torch.zeros(4))
    with pytest.raises(TypeError, match="float32 or float64"):
        k5.masked_argmax(v.half(), torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="S >= 1"):
        k5.masked_argmax(torch.zeros(2, 0), torch.zeros(2, 0,
                                                        dtype=torch.bool))


# ---------------------------------------------------------------------------
# instances, built from each package's classes
# ---------------------------------------------------------------------------

def _fixed_cluster(pkg, rng: random.Random):
    """Random capacities on a 2 x 3 shape (tests/test_planner.py:270)."""
    cl, _ = PKGS[pkg]
    servers = []
    for si in range(2):
        for sj in range(3):
            servers.append(cl.Server(
                id=f"s{si}-{sj}", site=f"site{si}",
                capacity={"mem": rng.uniform(6e9, 24e9),
                          "compute": rng.uniform(0.5, 2.0)}))
    return cl.Cluster(servers)


def _apps(pkg, rng: random.Random, n: int, max_variants: int = 4):
    """tests/test_planner.py:284 (``_jax_apps``)."""
    _, var = PKGS[pkg]
    out = []
    for i in range(n):
        lad = var.synthetic_family(f"f{i}", rng.uniform(0.3e9, 6e9),
                                   n_variants=rng.randint(2, max_variants),
                                   spread=rng.uniform(1.5, 12.0))
        out.append(var.Application(
            id=f"a{i}", family=f"f{i}", variants=lad,
            request_rate=rng.uniform(0.2, 3.0),
            critical=rng.random() < 0.5))
    return out


def _instance(pkg, seed: int, n_max: int = 20, max_variants: int = 4):
    """The random instance of tests/test_planner.py:298-320: cluster,
    apps, exclusions, alpha, a dead server, pre-placed primaries."""
    rng = random.Random(seed)
    cluster = _fixed_cluster(pkg, rng)
    apps = _apps(pkg, rng, rng.randint(1, n_max), max_variants)
    sids = list(cluster.servers)
    exclude = {a.id: {rng.choice(sids)} for a in apps
               if rng.random() < 0.6}
    site_exclude = {a.id: {f"site{rng.randrange(3)}"} for a in apps
                    if rng.random() < 0.3}
    alpha = rng.choice([0.0, 0.1, 0.4])
    if rng.random() < 0.3:
        cluster.fail_server(rng.choice(sids))
    for a in apps[::4]:
        sid = rng.choice(sids)
        if cluster.servers[sid].fits(a.variants[-1].demand):
            cluster.place(a.id, a.variants[-1], sid, "primary")
    return cluster, apps, dict(exclude=exclude, site_exclude=site_exclude,
                               alpha=alpha)


def _norm(res):
    return ({k: (v.name, s) for k, (v, s) in res.assignment.items()},
            list(res.unplaced))


def _check_torch_parity(seed: int, dtype: str) -> None:
    cl_j, apps_j, kw_j = _instance("jax", seed)
    cl_t, apps_t, kw_t = _instance("torch", seed)
    r_np = jvec.plan_greedy(
        apps_j, cl_j, state=jstate.PlannerState(cl_j, subscribe=False,
                                                dtype=dtype), **kw_j)
    r_t = plan_greedy_torch(
        apps_t, cl_t, state=tstate.PlannerState(cl_t, subscribe=False,
                                                dtype=dtype),
        ctx=TorchPlanContext("cpu"), **kw_t)
    assert _norm(r_np) == _norm(r_t)
    assert list(r_np.assignment) == list(r_t.assignment)
    assert r_np.objective == r_t.objective           # bit-identical


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_torch_backend_matches_numpy_random_instances(dtype):
    """The torch backend on the CPU is bit-identical to the JAX package's
    numpy planner across random clusters, exclusions, alphas, dead
    servers and capacity-starved instances."""
    def check(seed):
        _check_torch_parity(seed, dtype)

    if HAVE_HYPOTHESIS:
        @settings(max_examples=30, deadline=None)
        @given(hst.integers(min_value=0, max_value=2**31 - 1))
        def run(seed):
            check(seed)
        run()
    else:
        for seed in range(30):
            check(seed * 7919 + 13)


def test_torch_backend_dirty_row_sync_sequence_matches_numpy():
    """Incremental rounds (tests/test_planner.py:351): two identically
    mutated clusters, one planned by numpy and one by the torch backend
    with a persistent DeviceMirror — every round stays bit-identical, and
    the mirror moves dirty rows, not full re-uploads."""
    cl_np = _fixed_cluster("jax", random.Random(5))
    cl_t = _fixed_cluster("torch", random.Random(5))
    apps_np = _apps("jax", random.Random(6), 12)
    apps_t = _apps("torch", random.Random(6), 12)
    st_np = jstate.PlannerState(cl_np, dtype="float32")
    st_t = tstate.PlannerState(cl_t, dtype="float32")
    ctx = TorchPlanContext("cpu")
    mirror = ctx.mirror(st_t)
    mut = random.Random(7)
    downed = []
    for rnd in range(5):
        keep = [mut.random() < 0.7 for _ in apps_np]
        sub_np = [a for a, k in zip(apps_np, keep) if k] or apps_np[:1]
        sub_t = [a for a, k in zip(apps_t, keep) if k] or apps_t[:1]
        r_np = jvec.plan_greedy(sub_np, cl_np, state=st_np, alpha=0.1)
        r_t = plan_greedy_torch(sub_t, cl_t, state=st_t, alpha=0.1,
                                ctx=ctx)
        assert _norm(r_np) == _norm(r_t)
        assert r_np.objective == r_t.objective
        for (aid, (v, sid)), (_, (vt, _)) in list(zip(
                r_np.assignment.items(), r_t.assignment.items()))[:3]:
            cl_np.place(f"{aid}-r{rnd}", v, sid, "backup")
            cl_t.place(f"{aid}-r{rnd}", vt, sid, "backup")
        if downed and rnd % 2:
            sid = downed.pop()
            cl_np.revive_server(sid)
            cl_t.revive_server(sid)
        else:
            alive = [s.id for s in cl_np.alive_servers()]
            if len(alive) > 2:
                sid = mut.choice(alive)
                cl_np.fail_server(sid)
                cl_t.fail_server(sid)
                downed.append(sid)
    assert mirror.full_uploads == 1
    assert mirror.rows_scattered > 0
    # the mirror equals the state it mirrors, and a round never wrote it
    st_t.sync()
    free, head, alive, cap = mirror.arrays()
    assert np.array_equal(free.numpy(), st_t.free)
    assert np.array_equal(head.numpy(), st_t.head)
    assert np.array_equal(alive.numpy(), st_t.alive)
    assert np.array_equal(cap.numpy(), st_t.capacity)


def _numpy_place_then_upgrade(free, cap, budget, allowed, dm, start):
    """One app through vectorized.plan_greedy's Lines 7-14, on numpy
    arrays in place (free/cap in the state dtype, budget f64): the
    reference for the device functions' updates."""
    eps = 1e-9
    head = (free / cap).min(axis=1)
    for j in range(start, dm.shape[0]):
        d = dm[j]
        if not (budget >= d - eps).all():
            continue
        feas = (free >= d - eps).all(axis=1) & allowed
        if not feas.any():
            continue
        k = int(np.argmax(np.where(feas, head, -np.inf)))
        free[k] -= d
        budget -= d
        head[k] = (free[k] / cap[k]).min()
        break
    else:
        return head, -1, -1, -1
    extras = dm[:j] - dm[j]
    ups = np.flatnonzero((free[k] >= extras - eps).all(axis=1)
                         & (budget >= extras - eps).all(axis=1))
    j_up = -1
    if ups.size:
        j_up = int(ups[0])
        free[k] += dm[j]
        budget += dm[j]
        free[k] -= dm[j_up]
        budget -= dm[j_up]
        head[k] = (free[k] / cap[k]).min()
    return head, j, k, j_up


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_place_and_upgrade_update_the_state_like_numpy(dtype):
    """``place_chunk`` and ``upgrade_chunk`` leave free, head and budget
    bit-equal to numpy's in-place updates: the f64-then-cast subtract of
    Line 11 and the give-then-take two casts of the upgrade (a single f32
    subtract or one fused delta rounds differently)."""
    from repro_torch.core.planner.torch_backend import _cmp_thresholds
    rng = np.random.default_rng(11)
    for _ in range(300):
        S, V = 5, 4
        cap = rng.uniform(8e9, 24e9, (S, 2)).astype(dtype)
        cap[:, 1] = rng.uniform(0.5, 2.0, S)
        free = (cap * rng.uniform(0.05, 0.6, (S, 2))).astype(dtype)
        full = rng.uniform(0.3e9, 6e9)
        mem = full * (rng.uniform(1.5, 12.0) ** (-np.arange(V) / (V - 1)))
        dm = np.stack([mem, mem / 32e9], axis=1)
        allowed = rng.random(S) < 0.8
        budget = np.array([free[:, 0].sum(), free[:, 1].sum()],
                          np.float64) * rng.uniform(0.3, 1.0)
        start = int(rng.integers(0, V))
        f_np, b_np = free.copy(), budget.copy()
        h_np, j, k, j_up = _numpy_place_then_upgrade(
            f_np, cap, b_np, allowed, dm, start)

        t = {n: torch.from_numpy(a.copy()) for n, a in
             (("free", free), ("cap", cap), ("budget", budget))}
        t["head"] = (t["free"] / t["cap"]).amin(-1)
        dmt = torch.from_numpy(dm[None])
        jj, kk = tkernels.place_chunk(
            t["free"], t["head"], t["budget"], t["cap"],
            torch.from_numpy(allowed[None]), dmt,
            torch.from_numpy(_cmp_thresholds(dm, np.dtype(dtype))[None]),
            [start], [V])
        placed = int(jj[0]) < V - start
        assert (int(jj[0]) + start if placed else -1,
                int(kk[0]) if placed else -1) == (j, k)
        up = tkernels.upgrade_chunk(t["free"], t["head"], t["budget"],
                                    t["cap"], dmt, [j], [k])
        assert int(up[0]) == j_up
        assert np.array_equal(t["free"].numpy(), f_np)
        assert np.array_equal(t["head"].numpy(), h_np)
        assert np.array_equal(t["budget"].numpy(), b_np)


def test_reused_context_follows_new_apps_under_old_ids():
    """A planning context reused across rounds whose apps reuse ids with
    other variant ladders plans each round with its own apps' demands
    (the JAX package's AppMatrixCache keys rows by id alone and would
    plan the second instance with the first one's demands)."""
    ctx = TorchPlanContext("cpu")
    for seed in (1, 2, 3, 4):
        cl_j, apps_j, kw_j = _instance("jax", seed)
        cl_t, apps_t, kw_t = _instance("torch", seed)
        r_np = jvec.plan_greedy(apps_j, cl_j, **kw_j)
        r_t = plan_greedy_torch(apps_t, cl_t, ctx=ctx, **kw_t)
        assert _norm(r_np) == _norm(r_t)
        assert r_np.objective == r_t.objective


def test_app_matrix_cache_pads_to_the_rounds_longest_ladder():
    """A round's demand rows are as wide as its longest variant ladder,
    not as the widest ladder the cache has seen; a context reused from
    a round of long ladders to rounds of short ones stays bit-identical
    to numpy."""
    ctx = TorchPlanContext("cpu")
    long_j = _apps("jax", random.Random(8), 6, max_variants=8)
    long_t = _apps("torch", random.Random(8), 6, max_variants=8)
    rows = ctx.apps.rows(long_t)
    dm, vm, _ = ctx.apps.gather(rows)
    assert dm.shape[1] == vm.shape[1] == max(len(a.variants)
                                             for a in long_t)
    assert ctx.apps.gather(rows[:1])[0].shape[1] == \
        len(long_t[0].variants)
    cl_j = _fixed_cluster("jax", random.Random(9))
    cl_t = _fixed_cluster("torch", random.Random(9))
    r_np = jvec.plan_greedy(long_j, cl_j)
    r_t = plan_greedy_torch(long_t, cl_t, ctx=ctx)
    assert _norm(r_np) == _norm(r_t) and r_np.objective == r_t.objective
    for seed in (5, 6):
        cl_j, apps_j, kw_j = _instance("jax", seed, max_variants=2)
        cl_t, apps_t, kw_t = _instance("torch", seed, max_variants=2)
        r_np = jvec.plan_greedy(apps_j, cl_j, **kw_j)
        r_t = plan_greedy_torch(apps_t, cl_t, ctx=ctx, **kw_t)
        assert _norm(r_np) == _norm(r_t)
        assert r_np.objective == r_t.objective


# ---------------------------------------------------------------------------
# the copies: numpy planner, PlannerState, Cluster
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_numpy_planner_copy_matches_original(seed):
    """The port's numpy ``plan_greedy`` (its numpy backend and parity
    oracle) against the original on the same instance, with up to six
    variants per app."""
    for dtype in ("float64", "float32"):
        cl_j, apps_j, kw_j = _instance("jax", seed * 31 + 1, 25, 6)
        cl_t, apps_t, kw_t = _instance("torch", seed * 31 + 1, 25, 6)
        r_j = jvec.plan_greedy(apps_j, cl_j, state=jstate.PlannerState(
            cl_j, subscribe=False, dtype=dtype), **kw_j)
        r_t = tvec.plan_greedy(apps_t, cl_t, state=tstate.PlannerState(
            cl_t, subscribe=False, dtype=dtype), **kw_t)
        assert _norm(r_j) == _norm(r_t)
        assert r_j.objective == r_t.objective
        # and the torch backend on the port's own classes agrees too
        r_d = plan_greedy_torch(apps_t, cl_t, state=tstate.PlannerState(
            cl_t, subscribe=False, dtype=dtype), device="cpu", **kw_t)
        assert _norm(r_d) == _norm(r_t) and r_d.objective == r_t.objective


def test_planner_state_and_cluster_copies_match_originals():
    """Same mutations on both packages' clusters -> the same PlannerState
    arrays after every sync, the same worst-fit / group / scratch
    answers, and the same cluster bookkeeping."""
    clusters = {p: PKGS[p][0].make_cluster(3, 4, mem=16e9, compute=1.0)
                for p in PKGS}
    apps = {p: _apps(p, random.Random(3), 10, 5) for p in PKGS}
    states = {p: (jstate if p == "jax" else tstate).PlannerState(
        clusters[p], dtype="float64") for p in PKGS}
    rng = random.Random(4)
    sids = list(clusters["jax"].servers)
    for step in range(30):
        op, a_i, sid = rng.random(), rng.randrange(10), rng.choice(sids)
        v_i = rng.randrange(len(apps["jax"][a_i].variants))
        role = rng.choice(["primary", "backup", "cold"])
        lost = {}
        for p in PKGS:
            cl, app = clusters[p], apps[p][a_i]
            if op < 0.6:
                srv = cl.servers[sid]
                if srv.alive and srv.fits(app.variants[v_i].demand):
                    cl.place(app.id, app.variants[v_i], sid, role)
            elif op < 0.75:
                lost[p] = sorted((i.app_id, i.role)
                                 for i in cl.fail_server(sid))
            else:
                cl.revive_server(sid)
        assert lost.get("jax") == lost.get("torch")
        st = {p: states[p] for p in PKGS}
        for s in st.values():
            s.sync()
        assert np.array_equal(st["jax"].free, st["torch"].free)
        assert np.array_equal(st["jax"].head, st["torch"].head)
        assert np.array_equal(st["jax"].alive, st["torch"].alive)
        d = apps["jax"][a_i].variants[v_i].demand_vec
        assert st["jax"].worst_fit(d, [sid]) == st["torch"].worst_fit(
            d, [sid])
        assert st["jax"].place_group(d, 2) == st["torch"].place_group(d, 2)
        sj, stt = st["jax"].scratch(0.1), st["torch"].scratch(0.1)
        assert np.array_equal(sj.budget, stt.budget)
        assert sj.worst_fit(d) == stt.worst_fit(d)
        for p in PKGS:
            assert [s.id for s in clusters[p].alive_servers()] == \
                [s.id for s in clusters["jax"].alive_servers()]
            assert {s.id: s.headroom() for s in
                    clusters[p].servers.values()} == \
                {s.id: s.headroom() for s in
                 clusters["jax"].servers.values()}


# ---------------------------------------------------------------------------
# registry and validation (tests/test_planner.py:499)
# ---------------------------------------------------------------------------

def test_planner_registry_and_validation():
    get_planner = tplanner.get_planner
    assert tplanner.available_planners() == ("greedy",)
    assert get_planner("greedy", device="cpu").stats["backend"] == "torch"
    assert get_planner("greedy", backend="numpy").stats["backend"] \
        == "numpy"
    p = get_planner("greedy", backend="torch", device="cpu")
    assert p.stats == {"backend": "torch", "torch_rounds": 0,
                       "numpy_rounds": 0}
    with pytest.raises(ValueError, match="unknown planner backend"):
        get_planner("greedy", backend="tpu")
    with pytest.raises(ValueError, match="'torch'"):
        get_planner("greedy", backend="jax")
    for name in ("legacy-greedy", "ilp", "load-aware", "locality",
                 "sharded"):
        with pytest.raises(KeyError, match="ROADMAP"):
            get_planner(name)
    with pytest.raises(KeyError, match="unknown planner"):
        get_planner("nope")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            get_planner("greedy")
        with pytest.raises(RuntimeError, match="CUDA"):
            get_planner("greedy", backend="torch")
        with pytest.raises(RuntimeError, match="CUDA"):
            plan_greedy_torch([], state=None,
                              cluster=tcluster.make_cluster(1, 2))


def test_torch_planner_counts_rounds_and_latency_fallback():
    """The greedy planner counts its rounds per backend; a request with a
    ``latency_fn`` plans on numpy only, and the torch backend refuses it
    (naming its ROADMAP item) instead of planning on the host."""
    cl_t, apps_t, kw = _instance("torch", 3)
    cl_j, apps_j, _ = _instance("jax", 3)
    planner = tplanner.get_planner("greedy", backend="torch", device="cpu")
    st = tstate.PlannerState(cl_t, subscribe=False)
    req = tplanner.PlanRequest(apps=apps_t, cluster=cl_t, state=st,
                               exclude=kw["exclude"],
                               site_exclude=kw["site_exclude"],
                               alpha=kw["alpha"])
    res = planner.plan(req)
    ref = jvec.plan_greedy(apps_j, cl_j, **kw)
    assert _norm(res) == _norm(ref) and res.objective == ref.objective
    req.latency_fn = lambda app, v, srv: 0.0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        planner.plan(req)
    assert planner.stats == {"backend": "torch", "torch_rounds": 1,
                             "numpy_rounds": 0}
    oracle = tplanner.get_planner("greedy", backend="numpy")
    st_np = tstate.PlannerState(cl_t, subscribe=False)
    req.state = st_np
    res_np = oracle.plan(req)
    ref_lat = jvec.plan_greedy(apps_j, cl_j, latency_fn=req.latency_fn,
                               **kw)
    assert _norm(res_np) == _norm(ref_lat)
    assert oracle.stats == {"backend": "numpy", "torch_rounds": 0,
                            "numpy_rounds": 1}
