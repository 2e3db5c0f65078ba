"""The port's live failover testbed (``repro_torch.serving.testbed``) on
the CPU, against the JAX package's simulator.

Mirrors tests/test_serving.py::test_mini_testbed_failover_end_to_end and
tests/test_experiment.py::test_cross_backend_parity with
``device="cpu"``: the port's worker threads serve the smoke ladders, a
primary dies, the detector and controller fail it over, and the
failover choices (``RunResult.recovery_by_app()``) must equal the JAX
simulator's on the same spec (the JAX sim is deterministic, and the JAX
package's own test holds it equal to the JAX testbed). With
``archs=None`` every default testbed arch is served by live workers,
qwen3-32b and the MoE arch included. A testbed run must also report, not
hide, a failure other than a dead server (the port's WorkerDown rule).
"""

import math
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro.experiment import ExperimentSpec as JaxSpec  # noqa: E402
from repro.experiment import run_experiment as run_jax  # noqa: E402
from repro_torch.core.heartbeat import FailureDetector, WallClock  # noqa: E402
from repro_torch.core.variants import (Application,  # noqa: E402
                                       synthetic_family)
from repro_torch.experiment import ExperimentSpec, run_experiment  # noqa: E402
from repro_torch.experiment.workload import TESTBED_ARCHS  # noqa: E402
from repro_torch.serving.router import Router  # noqa: E402
from repro_torch.serving.server import WorkerDown, WorkerServer  # noqa: E402
from repro_torch.serving import testbed as TB  # noqa: E402
from repro_torch.serving.testbed import MiniTestbed  # noqa: E402

PARITY = dict(scenario="single-server", app_mix="arch",
              archs=["qwen2.5-3b", "rwkv6-3b", "recurrentgemma-2b"],
              n_sites=3, servers_per_site=2, headroom=0.35, client_hz=20.0,
              time_scale=0.25, settle_s=25.0, seed=1)


def test_mini_testbed_failover_end_to_end():
    tb = MiniTestbed(apps_per_arch=1, archs=["qwen2.5-3b", "rwkv6-3b"],
                     seed=3, headroom=0.35, device="cpu")
    try:
        tb.deploy()
        res = tb.run_failure_experiment(observe_s=25.0, client_hz=10.0)
        assert res["detect_latency_s"] < 0.5
        s = res["summary"]
        assert s["n"] >= 1
        assert s["recovery_rate"] == 1.0
        # clients of unaffected apps kept being served
        healthy = [st for app_id, st in res["client_stats"].items()
                   if app_id not in res["records"]]
        assert all(st.ok > 0 for st in healthy)
        assert not tb.errors
        # the engines really run on the CPU
        assert all(w.device.type == "cpu" for w in tb.workers.values())
    finally:
        tb.shutdown()


def _parity(spec_kw):
    jax_sim = run_jax(JaxSpec(backend="sim", **spec_kw))
    tb = run_experiment(ExperimentSpec(backend="testbed", device="cpu",
                                       **spec_kw))
    sim = run_experiment(ExperimentSpec(backend="sim", device="cpu",
                                        **spec_kw))
    assert tb.recovery_by_app() == jax_sim.recovery_by_app()
    assert sim.recovery_by_app() == jax_sim.recovery_by_app()
    assert tb.overall["recovery_rate"] == 1.0
    assert set(sim.to_row()) == set(tb.to_row()) == set(jax_sim.to_row())
    # real detection + real client-observed downtime on the testbed
    assert 0.0 < tb.detect_latency_s < 1.0
    t = tb.traffic
    assert t.n_windows >= 1 and t.n_offered > 0
    assert math.isfinite(t.client_mttr_avg) and t.client_mttr_avg > 0.0
    assert tb.extras["load_errors"] == []
    # the torch planner backend planned every round, on the CPU
    assert tb.extras["planner"]["backend"] == "torch"
    return tb


def test_cross_backend_parity_with_jax_sim():
    _parity(PARITY)


def test_cross_backend_parity_all_testbed_archs():
    """The default arch list: qwen3-32b (qk_norm) and qwen3-moe-30b-a3b
    (MoE) are served by live workers too, and every app's clients got
    answers."""
    tb = _parity({**PARITY, "archs": None})
    stats = tb.extras["client_stats"]
    assert {a.split("-app")[0] for a in stats} == set(TESTBED_ARCHS)
    assert all(st.ok > 0 for st in stats.values()), \
        {a: (st.ok, st.failed) for a, st in stats.items()}


def test_testbed_rejects_profile_only_apps():
    ladder = synthetic_family("x", 1e9)
    with pytest.raises(ValueError):
        MiniTestbed(apps=[Application(id="x0", family="x",
                                      variants=ladder)], device="cpu")


def test_unported_planes_raise():
    """The testbed's shard plane is ported (tests/test_torch_tpshard.py
    runs it): `tp_degree > 1` attaches a `TestbedShardManager` with the
    asked policy instead of raising. The testbed refuses the autopilot as
    the JAX one does; the sim backend runs the shard plane, the autopilot
    and sharded rounds with coordinators."""
    tb = MiniTestbed(tp_degree=2, shard_policy="reshard", device="cpu")
    try:
        assert tb.executor.shard_plane is tb.shards
        assert (tb.shards.tp_degree, tb.shards.policy) == (2, "reshard")
        assert tb.controller.shards is tb.shards
    finally:
        tb.shutdown()
    for kw in ({"tp_degree": 2}, {"planner_coordinators": 2,
                                  "planner": "sharded"},
               {"autopilot": True}):
        spec = ExperimentSpec.smoke("sim").with_(device="cpu", **kw)
        res = run_experiment(spec)
        assert res.overall["recovery_rate"] > 0
        assert ("shard" in res.extras) == ("tp_degree" in kw)
    with pytest.raises(ValueError, match="autopilot"):
        run_experiment(ExperimentSpec(backend="testbed", device="cpu",
                                      autopilot=True))


class _Worker:
    """A stand-in serving cell whose load raises ``exc``."""

    def __init__(self, exc):
        self.exc = exc

    def load(self, app, variant):
        raise self.exc

    def has(self, name):
        return False


@pytest.mark.parametrize("exc,reported", [
    (WorkerDown("s0 died during load"), False),
    (RuntimeError("flash_attention: CUDA error 98 at launch"), True),
    (torch.OutOfMemoryError("CUDA out of memory"), True),
])
def test_executor_reports_every_failure_but_a_dead_server(exc, reported,
                                                          capsys):
    """The JAX executor drops every RuntimeError as "server died
    mid-load"; a failed kernel build or launch and an out-of-memory error
    are RuntimeErrors in PyTorch, so the port drops only WorkerDown."""
    app = Application(id="a", family="x", variants=synthetic_family("x", 1e9))
    ex = TB.TestbedExecutor({"s0": _Worker(exc)}, Router(), threading.RLock())
    ready = []
    ex.load(app, app.full, "s0", ready.append)
    ex.prepare_warm(app, app.smallest, "s0")
    ex.join()
    assert ready == []
    assert len(ex.errors) == (2 if reported else 0)
    if reported:
        assert all(str(exc) in line for line in ex.errors)
        assert sorted(line.split(": ")[0] for line in ex.errors) == [
            f"load {app.full.name} on s0", f"warm {app.smallest.name} on s0"]
        assert str(exc) in capsys.readouterr().err      # printed as well


class _FailingEngine:
    """Admits a request, then fails its decode step."""

    def try_admit(self, req):
        return True

    def active_count(self):
        return 1

    def step(self):
        raise RuntimeError("decode_attention: CUDA error 700 at launch")


def test_worker_records_a_failing_decode_step():
    errors = []
    w = WorkerServer("w", FailureDetector(WallClock()), device="cpu",
                     errors=errors).start()
    try:
        w.install("m", _FailingEngine())
        assert w.submit("m", object())
        deadline = time.monotonic() + 5.0
        while not errors and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(errors) == 1 and "CUDA error 700" in errors[0]
        assert errors[0].startswith("decode step on w")
        assert all(t.is_alive() for t in w._threads)   # the cell lives on
        w.kill()
        with pytest.raises(WorkerDown):
            w.load(None, None)
        assert issubclass(WorkerDown, RuntimeError)
    finally:
        w.kill()
        w.join()
