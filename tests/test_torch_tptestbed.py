"""The port's live testbed with tensor-parallel groups
(`MiniTestbed(tp_degree=2, device="cpu")`, `serving/shard.py`) on the
CPU: tests/test_shardgroup.py's slow reshard test on the port, a degrade
that aliases the gathered engine and then installs the zero-filled one,
a lead loss that is not seamless, a monolith fallback, an arrival built
in the background, a failed rebuild reported (P12), the experiment
API's ``extras["shard"]`` with the JAX manager's keys, and the CLI and
serving entry point (`python -m repro_torch.launch.serve --device cpu`).
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.simulation import SimConfig as JSimConfig  # noqa: E402
from repro.core.simulation import Simulation as JSimulation  # noqa: E402
from repro.serving import shard as JSHARD  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.scenario import (AppArrival, Scenario,  # noqa: E402
                                       ShardFail)
from repro_torch.core.variants import (Application,  # noqa: E402
                                       synthetic_family)
from repro_torch.core.shardgroup import degraded_name  # noqa: E402
from repro_torch.experiment import ExperimentSpec, run_experiment  # noqa: E402
from repro_torch.experiment.cli import main as cli_main  # noqa: E402
from repro_torch.parallel.sharding import _tree_paths  # noqa: E402
from repro_torch.serving import shard as TSHARD  # noqa: E402
from repro_torch.serving.testbed import MiniTestbed  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _leaves(tree):
    """Leaves of a torch tree in walk order, as float32 numpy."""
    return [leaf for _p, leaf in _tree_paths(bridge.params_to_numpy(tree))]


def _testbed(policy, archs, **kw):
    return MiniTestbed(n_sites=3, servers_per_site=1, archs=archs,
                       apps_per_arch=1, seed=3, headroom=0.35, tp_degree=2,
                       shard_policy=policy, device="cpu", **kw)


def _kill(tb, server, settle_s=30.0, horizon=8.0):
    return tb.run_scenario(Scenario(
        name="tb-shard", horizon=horizon,
        events=[ShardFail(t=1.0, server=server)]),
        settle_s=settle_s, client_hz=10.0)


def test_testbed_reshard_measures_real_mttr():
    """tests/test_shardgroup.py::test_testbed_reshard_measures_real_mttr
    on the port, plus the re-gathered engine's weights."""
    tb = _testbed("reshard", ["rwkv6-3b"])
    try:
        tb.deploy()
        app = tb.apps[0]
        g = tb.shards.groups[app.id]
        victim = g.members[max(g.members)].server_id
        res = _kill(tb, victim)
        assert g.state == "live" and len(g.members) == 2
        assert victim not in {m.server_id for m in g.members.values()}
        shard = res["shard"]
        meas = shard["measured"]
        # a real slice re-materialize + re-gather + rebuild happened
        assert meas["slice_fetch_s"]["n"] >= 1
        assert meas["reshard_mttr_s"]["n"] >= 1
        assert meas["reshard_mttr_s"]["avg_s"] > 0
        # the measured repartition calibrated the sim's cost model
        assert shard["repartition_scale"] != 1.0
        # and the lead is serving the gathered full engine again
        lead = tb.workers[g.lead.server_id]
        assert lead.has(app.full.name)
        assert res["load_errors"] == []
        # ... whose weights are bit-equal to a monolith load's
        ref = TSHARD.checkpoint_params(app.full, "cpu")
        got = lead.engines[app.full.name].params
        assert all(np.array_equal(a, b) for a, b in zip(
            _leaves(got), _leaves(ref), strict=True))
        # the killed member lost its slice with its engines
        assert not tb.workers[victim].shard_store
    finally:
        tb.shutdown()


def test_testbed_degrade_aliases_then_installs_zero_filled_engine():
    tb = _testbed("degrade", ["qwen2.5-3b"])
    aliased = []
    try:
        tb.deploy()
        app = tb.apps[0]
        g = tb.shards.groups[app.id]
        lead = tb.workers[g.lead.server_id]
        alias = lead.alias
        lead.alias = lambda dst, src: aliased.append(
            (dst, src, alias(dst, src))) or aliased[-1][2]
        victim = g.members[max(g.members)].server_id
        res = _kill(tb, victim)
        dv = degraded_name(app.full, 1, 2)
        assert g.state == "degraded" and g.lead.server_id == lead.id
        # the route flipped to the degraded name on the surviving lead
        # and was answered at once by the gathered engine under an alias
        assert aliased == [(dv, app.full.name, True)]
        assert tb.router.lookup(app.id) == (lead.id, dv)
        meas = res["shard"]["measured"]
        assert meas["degrade_rebuild_s"]["n"] == 1
        assert meas["degrade_mttr_s"]["avg_s"] > 0
        # then the honest rebuild swapped in: rank 1's half is zeros
        eng = lead.engines[dv]
        assert eng is not lead.engines[app.full.name]
        wq_full = lead.engines[app.full.name].params["cycles"][0]["attn"][
            "wq"]
        wq = eng.params["cycles"][0]["attn"]["wq"]
        half = wq.shape[-2] // 2
        assert torch.equal(wq[..., :half, :], wq_full[..., :half, :])
        assert not wq[..., half:, :].any()
        # a seamless loss: the clients never saw a blackout
        assert res["client_stats"][app.id].downtime is None
        assert res["load_errors"] == []
    finally:
        tb.shutdown()


def test_testbed_lead_loss_under_degrade_is_not_seamless():
    tb = _testbed("degrade", ["qwen2.5-3b"])
    try:
        tb.deploy()
        app = tb.apps[0]
        g = tb.shards.groups[app.id]
        victim = g.lead.server_id
        assert tb.shards.darkened_by({victim}) == {app.id}
        res = _kill(tb, victim)
        dv = degraded_name(app.full, 1, 2)
        assert g.state == "degraded" and set(g.members) == {1}
        new_lead = tb.workers[g.members[1].server_id]
        # no gathered engine survived to alias: the route waited for the
        # zero-filled rebuild on the new lead
        assert tb.router.lookup(app.id) == (new_lead.id, dv)
        assert not new_lead.has(app.full.name) and new_lead.has(dv)
        st = res["client_stats"][app.id]
        assert st.downtime is not None and st.downtime > 0
        assert res["traffic"].n_windows >= 1
        assert res["load_errors"] == []
    finally:
        tb.shutdown()


def test_testbed_monolith_fallback():
    tb = _testbed("monolith", ["qwen2.5-3b"])
    try:
        tb.deploy()
        app = tb.apps[0]
        g = tb.shards.groups[app.id]
        victim = g.members[max(g.members)].server_id
        res = _kill(tb, victim)
        assert g.state == "fallen-back" and not g.members
        assert res["shard"]["actions"] == {"shard-monolith": 1}
        recs = [r for r in res["records"] if r.app_id == app.id]
        assert recs and all(r.recovered for r in recs)
        sid, vname = tb.router.lookup(app.id)
        assert "::" not in vname and tb.workers[sid].has(vname)
        # the group's gathered engines were torn down everywhere
        assert not any(n.startswith(app.full.name + "::")
                       for w in tb.workers.values() for n in w.engines)
        assert res["load_errors"] == []
    finally:
        tb.shutdown()


def test_testbed_arrival_builds_a_group_in_the_background():
    """An `AppArrival` (a profile-only ladder, mapped onto a testbed arch)
    is deployed as a group; its slices and engine build on an executor
    thread, and the route reaches the router once the engine is up."""
    tb = MiniTestbed(n_sites=3, servers_per_site=2, archs=["qwen2.5-3b"],
                     apps_per_arch=1, seed=3, headroom=0.35, tp_degree=2,
                     device="cpu")
    try:
        tb.deploy()
        late = Application(id="late0", family="x",
                           variants=synthetic_family("x", 1e9))
        res = tb.run_scenario(Scenario(
            name="arrival", horizon=2.0,
            events=[AppArrival(t=0.5, app=late)]),
            settle_s=3.0, client_hz=10.0)
        g = tb.shards.groups["late0"]
        assert g.state == "live" and len(g.members) == 2
        full = next(a for a in tb.apps if a.id == "late0").full
        assert tb.router.lookup("late0") == (g.lead.server_id, full.name)
        assert tb.workers[g.lead.server_id].has(full.name)
        assert all(tb.workers[m.server_id].shard_store
                   for m in g.members.values())
        assert res["shard"]["measured"]["deploy_build_s"]["n"] == 2
        assert res["client_stats"]["late0"].ok > 0
        assert res["unplaced_arrivals"] == 0 and res["load_errors"] == []
    finally:
        tb.shutdown()


@pytest.mark.parametrize("policy,what", [("degrade", "degraded rebuild"),
                                         ("reshard", "repartition")])
def test_testbed_reports_a_failed_rebuild(policy, what):
    """A rebuild that raises other than `WorkerDown` (here as a failed
    kernel launch does) reaches `load_errors`; the JAX shard plane drops
    every RuntimeError there (ROADMAP P12)."""
    tb = _testbed(policy, ["qwen2.5-3b"])
    try:
        tb.deploy()
        app = tb.apps[0]
        g = tb.shards.groups[app.id]

        def broken(*_a, **_kw):
            raise RuntimeError("CUDA error: an illegal memory access")
        tb.shards._install = broken
        res = _kill(tb, g.members[max(g.members)].server_id, settle_s=2.0,
                    horizon=1.0)
        assert [e for e in res["load_errors"]
                if e.startswith(f"{what} of {app.id}")
                and "illegal memory access" in e], res["load_errors"]
    finally:
        tb.shutdown()


def test_run_experiment_reports_shard_with_jax_keys():
    res = run_experiment(ExperimentSpec(backend="testbed", tp_degree=2,
                                        device="cpu"))
    shard = res.extras["shard"]
    # the JAX testbed manager's summary keys, without a JAX testbed run
    jsim = JSimulation(JSimConfig(tp_degree=2)).setup()
    jman = JSHARD.TestbedShardManager(
        types.SimpleNamespace(controller=jsim.controller), tp_degree=2)
    want = jman.summary()
    assert set(shard) == set(want)
    assert set(shard["measured"]) == set(want["measured"])
    assert shard["measured"]["deploy_build_s"]["n"] == shard["n_groups"]
    assert res.extras["load_errors"] == []
    assert res.overall["recovery_rate"] == 1.0


def test_cli_runs_the_tp_testbed_and_launch_serve():
    assert cli_main(["run", "--smoke", "--backend", "testbed", "--device",
                     "cpu", "--tp-degree", "2", "--shard-policy",
                     "reshard"]) == 0
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--archs", "qwen2.5-3b,rwkv6-3b", "--observe", "10"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "recovery 100%" in out.stdout and "client view:" in out.stdout
