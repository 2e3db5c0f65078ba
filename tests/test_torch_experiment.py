"""The port's experiment layer (``repro_torch.experiment``, ``python -m
repro_torch``) — a mirror of tests/test_experiment.py's simulator-side
tests on the CPU (``device="cpu"``), plus the port's own rules: the spec
adds ``device`` and defaults ``planner_backend`` to "torch", and the CLI
runs on the card unless ``--device cpu`` is given. The sim backend's deterministic fingerprint must equal
the JAX package's on the same spec.
"""

import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro.experiment import ExperimentSpec as JaxSpec  # noqa: E402
from repro.experiment import run_experiment as run_jax  # noqa: E402
from repro_torch.experiment import (BACKENDS, ExperimentSpec,  # noqa: E402
                                    RunResult, get_backend,
                                    primary_kill_scenario, run_experiment)
from repro_torch.experiment.cli import main  # noqa: E402

TINY = dict(n_sites=2, servers_per_site=2, headroom=0.3,
            traffic_rate_scale=5.0, settle_s=10.0, seed=0, device="cpu")


def _no_device(kw):
    return {k: v for k, v in kw.items() if k != "device"}


# ---------------------------------------------------------------------------
# spec + registry
# ---------------------------------------------------------------------------

def test_spec_roundtrip():
    spec = ExperimentSpec(scenario="cascade", policy="full-warm",
                          seed=7, n_sites=3, archs=["qwen2.5-3b"],
                          app_mix="arch", device="cpu")
    again = ExperimentSpec.from_dict(spec.to_dict())
    assert again == spec
    assert json.loads(json.dumps(spec.to_dict())) == spec.to_dict()


def test_spec_rejects_unknown_fields_and_mixes():
    with pytest.raises(ValueError):
        ExperimentSpec.from_dict({"no_such_field": 1})
    with pytest.raises(ValueError):
        ExperimentSpec(app_mix="bogus")


def test_spec_testbed_forces_arch_mix():
    assert ExperimentSpec(backend="testbed").app_mix == "arch"
    assert ExperimentSpec(backend="sim").app_mix == "synthetic"


def test_spec_is_the_jax_spec_plus_device():
    """Same fields and presets as the JAX spec, but for ``device`` and
    the planner backend's default (torch on the card, ROADMAP P7)."""
    for backend in ("sim", "testbed"):
        ours = ExperimentSpec.smoke(backend).to_dict()
        theirs = JaxSpec.smoke(backend).to_dict()
        assert ours.pop("device") is None
        assert ours.pop("planner_backend") == "torch"
        assert theirs.pop("planner_backend") == "numpy"
        assert ours == theirs


def test_backend_registry():
    assert {"sim", "testbed"} <= set(BACKENDS)
    assert get_backend("sim").name == "sim"
    with pytest.raises(KeyError):
        get_backend("quantum")


# ---------------------------------------------------------------------------
# sim backend
# ---------------------------------------------------------------------------

def test_sim_run_result_schema():
    res = run_experiment(ExperimentSpec(scenario="single-server", **TINY))
    assert isinstance(res, RunResult)
    assert res.backend == "sim"
    assert res.n_epochs >= 1
    assert res.overall["recovery_rate"] == 1.0
    assert res.traffic is not None and res.traffic.n_offered > 0
    assert res.plan_wall_s > 0.0
    assert math.isnan(res.detect_latency_s)
    by_app = res.recovery_by_app()
    assert by_app and all(len(v) == 3 for v in by_app.values())
    assert set(res.to_row()) >= {"backend", "scenario", "recovery_rate",
                                 "client_mttr_ms", "availability"}
    assert res.extras["planner"]["backend"] == "torch"


def test_sim_path_identical_to_legacy_entry_point():
    from repro_torch.core.simulation import SimConfig, Simulation

    res = run_experiment(ExperimentSpec(scenario="site-outage", **TINY))
    sim = Simulation(SimConfig(n_sites=2, servers_per_site=2,
                               headroom=0.3, traffic_rate_scale=5.0,
                               seed=0, planner_device="cpu")).setup()
    legacy = sim.run_named_scenario("site-outage", settle=10.0)
    assert res.fingerprint() == legacy.fingerprint()


@pytest.mark.parametrize("scenario", ["single-server", "site-outage",
                                      "cascade"])
@pytest.mark.parametrize("planner_backend", ["torch", "numpy"])
def test_sim_fingerprint_equals_jax(scenario, planner_backend):
    """The port's sim backend, planning on torch (CPU) or numpy, gives the
    JAX package's deterministic replay digest on the same spec."""
    ours = run_experiment(ExperimentSpec(scenario=scenario,
                                         planner_backend=planner_backend,
                                         **TINY))
    theirs = run_jax(JaxSpec(scenario=scenario, **_no_device(TINY)))
    assert ours.fingerprint() == theirs.fingerprint()
    assert ours.to_row().keys() == theirs.to_row().keys()


NEW_KNOBS = {
    "tp2": dict(tp_degree=2, scenario="tp-shard-storm"),
    "tp2-degrade": dict(tp_degree=2, shard_policy="degrade",
                        scenario="tp-shard-storm"),
    "coordinators2": dict(planner="sharded", planner_coordinators=2),
    "autopilot": dict(autopilot=True, scenario="chaos"),
    "locality": dict(planner="locality", storage="edge",
                     scheduler="criticality"),
    "all": dict(tp_degree=2, planner="locality", planner_coordinators=2,
                autopilot=True, scenario="tp-shard-storm"),
}


@pytest.mark.parametrize("planner_backend", ["torch", "numpy"])
@pytest.mark.parametrize("case", list(NEW_KNOBS))
def test_sim_new_knobs_fingerprint_equals_jax(case, planner_backend):
    """The knobs this slice opens on the sim backend (tp_degree, shard
    policy, planner_coordinators, autopilot, the other planners) give
    the JAX package's fingerprint and shard summary."""
    kw = dict(TINY, **NEW_KNOBS[case])
    ours = run_experiment(ExperimentSpec(planner_backend=planner_backend,
                                         **kw))
    theirs = run_jax(JaxSpec(**_no_device(kw)))
    assert ours.fingerprint() == theirs.fingerprint()
    assert ours.extras.get("shard") == theirs.extras.get("shard")
    assert ("shard" in ours.extras) == (kw.get("tp_degree", 1) > 1)
    stats = ours.extras["planner"]
    assert stats["backend"] == planner_backend
    assert stats["coordinators"] == kw.get("planner_coordinators", 0)


def test_scenario_builder_hook():
    res = run_experiment(ExperimentSpec(
        scenario="primary-kill",
        scenario_builder=primary_kill_scenario(), **TINY))
    assert res.scenario == "primary-kill"
    assert any(r.app_id == "app0" for r in res.records)


def test_arch_mix_runs_on_sim():
    kw = dict(scenario="single-server", app_mix="arch",
              archs=["qwen2.5-3b", "rwkv6-3b"], n_sites=2,
              servers_per_site=1, headroom=0.35, traffic_rate_scale=5.0,
              settle_s=10.0, seed=3)
    res = run_experiment(ExperimentSpec(device="cpu", **kw))
    assert res.overall["recovery_rate"] == 1.0
    fams = {r.variant.split(":")[0] for r in res.records}
    assert fams <= {"qwen2.5-3b", "rwkv6-3b"}
    assert res.recovery_by_app() == run_jax(JaxSpec(**kw)).recovery_by_app()


def test_fingerprint_raises_on_non_deterministic_backend():
    res = run_experiment(ExperimentSpec(scenario="single-server", **TINY))
    res.sim_result = None
    with pytest.raises(ValueError):
        res.fingerprint()


def test_load_bw_sweeps_without_monkeypatching():
    slow = run_experiment(ExperimentSpec(**TINY, policy="full-cold",
                                         load_bw=4e9))
    fast = run_experiment(ExperimentSpec(**TINY, policy="full-cold",
                                         load_bw=16e9))
    assert fast.overall["mttr_avg"] < slow.overall["mttr_avg"]


def test_storage_and_scheduler_fields_reach_backend():
    res = run_experiment(ExperimentSpec(**TINY, scenario="cold-load-storm",
                                        storage="edge",
                                        scheduler="criticality"))
    assert res.overall["recovery_rate"] > 0.0
    srcs = {r.source for r in res.records if r.source}
    assert srcs <= {"local", "peer", "cloud"} and srcs


def test_unported_planner_raises():
    """Every planner of the JAX package now resolves (the locality one on
    the sim backend, equal to JAX's); an unknown name still raises."""
    got = run_experiment(ExperimentSpec(planner="locality", **TINY))
    want = run_jax(JaxSpec(planner="locality", **_no_device(TINY)))
    assert got.fingerprint() == want.fingerprint()
    with pytest.raises(KeyError, match="unknown planner"):
        run_experiment(ExperimentSpec(planner="nope", **TINY))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_list(capsys):
    assert main(["list"]) == 0
    out = capsys.readouterr().out
    assert "sim" in out and "testbed" in out and "single-server" in out
    planners = [ln for ln in out.splitlines() if ln.startswith("planners:")]
    assert planners == ["planners:  greedy, ilp, legacy-greedy, "
                        "load-aware, locality, sharded"]


def test_cli_new_flags_parse_and_roundtrip():
    """--autopilot, --planner-coordinators, --tp-degree and
    --shard-policy reach the spec, which survives to_dict/from_dict."""
    from repro_torch.experiment.cli import _build_parser, _spec_from_args
    args = _build_parser().parse_args([
        "run", "--autopilot", "--planner", "sharded",
        "--planner-coordinators", "3", "--tp-degree", "2",
        "--shard-policy", "reshard", "--device", "cpu"])
    spec = _spec_from_args(args)
    assert (spec.autopilot, spec.planner_coordinators, spec.tp_degree,
            spec.shard_policy) == (True, 3, 2, "reshard")
    assert ExperimentSpec.from_dict(spec.to_dict()) == spec
    plain = _spec_from_args(_build_parser().parse_args(["run"]))
    assert (plain.autopilot, plain.planner_coordinators, plain.tp_degree,
            plain.shard_policy) == (False, 0, 1, "auto")
    with pytest.raises(SystemExit):
        _build_parser().parse_args(["run", "--shard-policy", "nope"])


def test_cli_run_smoke_json(capsys):
    assert main(["run", "--smoke", "--backend", "sim", "--device", "cpu",
                 "--json"]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["backend"] == "sim"
    assert row["recovery_rate"] == 1.0


def test_cli_run_out_dumps_runresult(tmp_path, capsys):
    out = tmp_path / "result.json"
    assert main(["run", "--smoke", "--backend", "sim", "--device", "cpu",
                 "--planner-backend", "numpy", "--out", str(out)]) == 0
    capsys.readouterr()
    doc = json.loads(out.read_text())
    assert doc["spec"]["backend"] == "sim"
    assert doc["spec"]["device"] == "cpu"
    assert doc["planner"]["backend"] == "numpy"
    assert doc["row"]["recovery_rate"] == 1.0
    assert doc["records"] and {"app_id", "mttr_ms", "phases"} \
        <= set(doc["records"][0])
    json.dumps(doc)
    assert ExperimentSpec.from_dict(doc["spec"]).backend == "sim"


def test_cli_testbed_smoke_on_cpu(capsys):
    """`python -m repro_torch run --smoke --backend testbed --device cpu`:
    the live testbed's smoke preset, served on the CPU."""
    assert main(["run", "--smoke", "--backend", "testbed", "--device",
                 "cpu", "--json"]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["backend"] == "testbed"
    assert row["recovery_rate"] == 1.0
    assert row["n_offered"] > 0


def test_cli_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule is moot")
    for backend in ("sim", "testbed"):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["run", "--smoke", "--backend", backend])
