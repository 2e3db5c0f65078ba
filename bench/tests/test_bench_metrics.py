"""The metric readers on synthetic runs, the frozen ladder against the
port's, the configuration files against the port's configurations, and the
kernel formulas against the bounds of PERF.md's kernel table."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from bench import flops, harness, ladder

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = ["qwen2.5-3b", "rwkv6-3b"]


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def rec(idx, app, due, sub, first, done, n_tok=3, variant="m.app0:full"):
    r = harness.Record(idx, app, due, np.zeros(10, np.int32), n_tok - 1)
    r.t_sub, r.t_first, r.t_done, r.done = sub, first, done, True
    r.tokens, r.variant = list(range(n_tok)), variant
    return r


def run_of(records, kills=(), seconds=10.0, recoveries=(), accuracy=None,
           probes=()):
    return harness.Run(cell=None, seed=0, seconds=seconds, setup_s=12.5,
                       t0=100.0, t1=100.0 + seconds, records=list(records),
                       kills=list(kills), recoveries=list(recoveries),
                       accuracy=accuracy or (lambda v: 1.0),
                       probes=list(probes))


def metric(name):
    return harness.load_metric(name)


def test_ttft_p90_over_every_request():
    recs = [rec(i, "app0", 100.0 + i, 100.0 + i, 100.0 + i + 0.001 * (i + 1),
                100.5 + i) for i in range(10)]
    v = metric("ttft_p90_ms").read(run_of(recs))
    assert v == pytest.approx(np.percentile(np.arange(1, 11), 90))
    # an unanswered request counts as answered when the drain ended
    late = harness.Record(10, "app1", 105.0, np.zeros(4, np.int32), 1)
    v2 = metric("ttft_p90_ms").read(run_of(recs + [late]))
    assert v2 > v


def test_ttft_p50_over_every_request():
    recs = [rec(i, "app0", 100.0 + i, 100.0 + i, 100.0 + i + 0.001 * (i + 1),
                100.5 + i) for i in range(9)]
    assert metric("ttft_p50_ms").read(run_of(recs)) == pytest.approx(5.0)
    late = [harness.Record(9 + i, "app1", 105.0, np.zeros(4, np.int32), 1)
            for i in range(3)]
    assert metric("ttft_p50_ms").read(run_of(recs + late)) == \
        pytest.approx(np.percentile(list(range(1, 10)) + [65e3] * 3, 50))
    assert metric("ttft_p50_ms").read(run_of([])) is None


def test_the_traced_slice_opens_before_a_request():
    from bench import traffic
    mix = json.loads((BENCH / "traffic" / "longdoc64k.json").read_text())
    for seed in (1, 2**31 + 41, 2**31 + 12345):
        sched = traffic.schedule(mix, seed, 51.0, 4)
        t = harness.trace_start(sched, 51.0)
        first = min(a.t_due for a in sched if a.t_due >= 0.4 * 51.0)
        assert t == pytest.approx(first - harness.TRACE_LEAD_S)
        assert t + 0.08 * 51.0 <= 51.0
    assert harness.trace_start([], 51.0) == pytest.approx(
        0.4 * 51.0 - harness.TRACE_LEAD_S)


def test_tokens_per_s_counts_what_completed_in_the_window():
    recs = [rec(0, "a", 100, 100, 100.1, 101, n_tok=4),
            rec(1, "a", 101, 101, 101.1, 109.9, n_tok=5),
            rec(2, "a", 109, 109, 109.5, 110.5, n_tok=7)]
    assert metric("tokens_per_s").read(run_of(recs)) == pytest.approx(0.9)


def test_mttr_from_a_kill_and_first_token_log():
    kills = [harness.Kill(102.0, "s0-0", ["app0", "app1"]),
             harness.Kill(106.0, "s1-0", ["app2"])]
    recs = [
        rec(0, "app0", 101.5, 101.6, 101.9, 102.5),   # before: not counted
        rec(1, "app0", 102.1, 102.3, 102.35, 102.6),  # first after: 350 ms
        rec(2, "app0", 102.2, 102.4, 102.45, 102.9),
        rec(3, "app1", 101.9, 102.8, 102.9, 103.0),   # resent: 900 ms
        rec(4, "app2", 106.5, 106.6, 107.2, 107.5),   # 1200 ms
        rec(5, "app2", 106.7, 106.8, 107.0, 107.9),   # completes later
    ]
    v = metric("mttr_ms.crash").read(run_of(recs, kills))
    assert v == pytest.approx((350 + 900 + 1200) / 3)
    assert metric("mttr_ms.crash").read(run_of(recs)) is None
    # a probe sent at the kill answers before app2's next request is due
    probe = rec(6, "app2", 106.0, 106.2, 106.4, 106.45)
    probe.probe = True
    v = metric("mttr_ms.crash").read(run_of(recs, kills, probes=[probe]))
    assert v == pytest.approx((350 + 900 + 400) / 3)
    # probes are not the mix's requests
    assert metric("ttft_p90_ms").read(run_of(recs, probes=[probe])) == \
        metric("ttft_p90_ms").read(run_of(recs))


def test_accuracy_drop_follows_the_ports_ladder():
    m = config("qwen2.5-3b")["model"]
    recs = [rec(0, "a", 100, 100, 100.1, 101, variant="x.app0:full"),
            rec(1, "a", 100, 100, 100.1, 101, variant="x.app0:w050"),
            rec(2, "a", 100, 100, 100.1, 101, variant="x.app0:w050-int8")]
    acc = lambda v: ladder.accuracy(m, ladder.tag_of(v))  # noqa: E731
    v = metric("accuracy_drop_pct.crash").read(run_of(recs, accuracy=acc))
    want = 100 * ((1 - acc("a:w050")) + (1 - acc("a:w050-int8"))) / 3
    assert v == pytest.approx(want)
    assert 0.5 < v < 1.5


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_ladder_equals_the_ports(name):
    from repro_torch.core.variants import build_ladder
    c = config(name)
    port = build_ladder(harness.model_config(c))
    for v in port:
        tag = ladder.tag_of(v.name)
        assert ladder.accuracy(c["model"], tag) == pytest.approx(
            v.accuracy, abs=1e-12)
        dims = ladder.rung_dims(c["model"], tag)
        for key in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                    "d_ff", "head_dim", "vocab_size", "quant_bits"):
            assert dims[key] == getattr(v.config, key), (v.name, key)
        assert ladder.param_count(dims) == v.config.param_count()


@pytest.mark.parametrize("name", CONFIGS)
def test_configuration_file_is_the_ports_configuration(name):
    from repro_torch import configs
    port = configs.get_config(name)
    c = config(name)
    ours = harness.model_config(c)
    assert ours == port.replace(remat=ours.remat)
    assert c["reduced"] == []


def test_recovery_phase_readers():
    R = SimpleNamespace
    recs = [R(mode="warm", phases={"detect": 0.04, "route": 0.01}),
            R(mode="cold-progressive", phases={"detect": 0.06, "plan": 0.2,
                                               "queue": 0.1, "fetch": 0.0,
                                               "warmup": 0.5}),
            R(mode="cold", phases={"detect": 0.05, "plan": 0.1,
                                   "queue": 0.0, "fetch": 0.0,
                                   "warmup": 0.3})]
    run = run_of([], recoveries=recs)
    assert metric("detect_ms").read(run) == pytest.approx(50.0)
    assert metric("plan_ms").read(run) == pytest.approx(150.0)
    assert metric("load_ms").read(run) == pytest.approx(450.0)
    assert metric("setup_s").read(run) == 12.5
    assert metric("detect_ms").read(run_of([])) is None


# PERF.md's kernel table: (shape, bound ms as printed)
K1_ROWS = [((1, 256, 256, 16, 2, 128), 0.00070),
           ((1, 256, 256, 64, 8, 128), 0.00282),
           ((1, 256, 256, 20, 20, 128), 0.00157)]
K4_ROWS = [((1, 256, 40, 64), 0.00313)]


@pytest.mark.parametrize("shape,ms", K1_ROWS)
def test_k1_bound_matches_the_kernel_table(shape, ms):
    assert flops.k1_bound_s(*shape, causal=True) * 1e3 == pytest.approx(
        ms, abs=5e-6)


@pytest.mark.parametrize("shape,ms", K4_ROWS)
def test_k4_bound_matches_the_kernel_table(shape, ms):
    assert flops.k4_bound_s(*shape) * 1e3 == pytest.approx(ms, abs=5e-6)


def test_model_flops_count_each_token_once():
    m = config("qwen2.5-3b")["model"]
    S = 4096
    dense = 2 * (ladder.param_count(m) - m["vocab_size"] * m["d_model"]
                 - m["d_model"] - 2 * m["d_model"] * m["num_layers"]
                 - m["num_layers"] * (16 * 128 + 2 * 2 * 128)) * S
    attn = 4 * 16 * 128 * S * (S + 1) // 2 * 36
    head = 2 * 2048 * 151936
    assert flops.prefill_flops(m, S) == pytest.approx(dense + attn + head)
    assert flops.decode_flops(m, [S]) == pytest.approx(
        dense / S + 4 * 16 * 128 * S * 36 + head)


def test_sample_holds_the_longest_and_every_rung():
    from bench import check
    done = []
    for i in range(40):
        r = harness.Record(i, "a", 0.0, np.zeros(1000 + 100 * i, np.int32), 3)
        r.tokens = [1, 2, 3, 4]
        r.variant = "m.app0:full" if i % 5 else "m.app0:w025"
        done.append(r)
    s = check.pick_sample(done, 2**31 + 3, 20000)
    assert s == check.pick_sample(done, 2**31 + 3, 20000)
    assert done[39] in s
    assert {r.variant for r in s} == {"m.app0:full", "m.app0:w025"}
    assert sum(len(r.prompt) + 3 for r in s) <= 20000
    assert check.pick_sample([], 1, 100) == []


def test_device_trace_reduction():
    from torch.autograd import DeviceType
    from bench import trace

    def ev(name, a, b):
        return SimpleNamespace(device_type=DeviceType.CUDA, name=name,
                               time_range=SimpleNamespace(start=a, end=b))
    prof = SimpleNamespace(events=lambda: [
        ev("void fa_tc_kernel<1>", 0.0, 100.0),
        ev("gemm", 50.0, 300.0), ev("gemm", 500.0, 700.0),
        ev("wkv_chunk_out_kernel", 900.0, 1200.0)])
    d = trace.device_trace(prof, 10.0, 10.001)
    assert d.busy_s == pytest.approx((300 + 200 + 100) * 1e-6)
    assert d.window_s == pytest.approx(0.001)
    assert d.kernel_s(trace.K1_KERNEL) == pytest.approx(100e-6)
    assert d.kernel_s(trace.K4_CHUNKED_KERNEL) == pytest.approx(100e-6)
    assert [round((b - a) * 1e6) for a, b in d.gaps] == [200, 200]
    br = trace.breakdown(d, None)
    assert br["device_ops"][0] == ["gemm", pytest.approx(450e-6)]
    assert len(br["idle_gaps"]) == 2
    run = run_of([])
    run.device = d
    assert metric("idle_share").read(run) == pytest.approx(40.0)
