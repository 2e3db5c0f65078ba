"""The readers of the program's own records (``bench/progtrace.py`` and
the metrics that use it) on synthetic records, the naming of idle
stretches, and the program's spans against the benchmark's wrappers
(``bench/trace.Spans``): the same calls with the same shapes."""

from __future__ import annotations

import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench import harness, progtrace
from bench.tests.smoke import smoke_tree
from bench.trace import DeviceTrace, Spans
from repro_torch import configs, trace
from repro_torch.device import generator_for
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.models import model as MDL
from repro_torch.serving.engine import InferenceEngine, Request

NEW = ["idle_with_work_pct", "model_lock_wait_ms", "drain_wait_ms",
       "prefill_host_ms", "decode_host_ms"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def unarmed():
    yield
    progtrace._disarm()
    progtrace._A.run = progtrace._A.view = None


def ns(t):
    return round(t * 1e9)


def synthetic_run(traced=True):
    """A run whose window is [100, 110) s, its profiled slice [104, 105)
    with the kernels busy over [104.2, 104.5) (a host clock zero 10 ms
    after the profiler's), and the program's records: two requests, two
    lock waits, a drain wait, a prefill and a decode step."""
    readers = {m: harness.load_metric(m) for m in NEW}   # each arms
    rec = progtrace._A.rec = trace.enable()   # as a profile's start would
    trace.record("request", ns(103.0), ns(104.1), req="a")
    trace.record("request", ns(104.45), ns(104.6), req="b")
    trace.record("engine.lock_wait", ns(101.0), ns(101.004), req="a")
    trace.record("engine.lock_wait", ns(102.0), ns(102.002), step=0)
    trace.record("engine.lock_wait", ns(99.0), ns(99.5), req="warm-up")
    trace.record("engine.first_decode_wait", ns(101.0), ns(101.003),
                 req="a")
    trace.record("engine.prefill.enqueue", ns(101.0), ns(101.006))
    trace.record("engine.decode.enqueue", ns(102.0), ns(102.008))
    progtrace._A.zeros.append((105.02, ns(103.99)))
    dev = DeviceTrace(104.0, 1.0, 0.3, {}, [(104.0, 104.2), (104.5, 105.0)])
    run = SimpleNamespace(t0=100.0, t1=110.0, device=dev if traced else None,
                          spans=Spans() if traced else None)
    return readers, run


def test_the_span_metrics_read_the_window():
    readers, run = synthetic_run()
    got = {m: readers[m].read(run) for m in NEW}
    assert got["model_lock_wait_ms"] == pytest.approx(3.0)
    assert got["drain_wait_ms"] == pytest.approx(3.0)
    assert got["prefill_host_ms"] == pytest.approx(6.0)
    assert got["decode_host_ms"] == pytest.approx(8.0)
    # the gaps, mapped 10 ms earlier: [103.99, 104.19) and [104.49,
    # 104.99); requests cover 104.1 - 103.99 + 104.6 - 104.49 s of them
    assert got["idle_with_work_pct"] == pytest.approx(22.0)
    idle = harness.load_metric("idle_share").read(run)
    assert idle == pytest.approx(70.0) and got["idle_with_work_pct"] <= idle
    v = progtrace.view(run)
    assert v.zero_offset_s == pytest.approx(-0.01)
    # a second load of the readers (the harness's log of every metric)
    # gives the same readings and leaves the tracer off
    again = {m: harness.load_metric(m).read(run) for m in NEW}
    assert again == got and not trace.ON


@pytest.mark.parametrize("case", ["untraced", "no program tracer"])
def test_the_readers_read_nothing_without_records(case, monkeypatch):
    if case == "no program tracer":
        monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
        import repro_torch
        monkeypatch.delattr(repro_torch, "trace")
    readers, run = None, None
    readers = {m: harness.load_metric(m) for m in NEW}
    run = SimpleNamespace(t0=0.0, t1=1.0, device=None,
                          spans=None if case == "untraced" else Spans())
    assert all(readers[m].read(run) is None for m in NEW)
    assert not trace.ON


def test_arming_starts_the_tracer_at_the_first_profile_only():
    """A reader's load hooks the profiler and starts nothing; the first
    profile started starts the tracer, and each stop notes its trace's
    start mapped onto the host clock, between the clock read before the
    profile started and after; the first view undoes all of it."""
    from torch.profiler import ProfilerActivity, profile
    start0, stop0 = profile.start, profile.stop
    reader = harness.load_metric("decode_host_ms")
    assert not trace.ON and profile.start is not start0
    zeros = []
    for _ in range(2):
        before = time.monotonic_ns()
        with profile(activities=[ProfilerActivity.CPU]):
            after = time.monotonic_ns()
            assert trace.ON
            torch.ones(8).add_(1.0)
        zeros.append((before, after))
    rec = progtrace._A.rec
    assert rec is not None and trace.ON
    assert len(progtrace._A.zeros) == 2
    for (before, after), (_, zero) in zip(zeros, progtrace._A.zeros):
        assert before <= zero <= after, (zero - before, after - zero)
    run = SimpleNamespace(t0=0.0, t1=1.0, device=None, spans=None)
    assert reader.read(run) is None
    assert not trace.ON
    assert profile.start is start0 and profile.stop is stop0


def test_an_untraced_run_never_starts_the_tracer(monkeypatch):
    seen = []
    monkeypatch.setattr(trace, "enable", lambda: seen.append(1))
    readers = {m: harness.load_metric(m) for m in NEW}
    run = SimpleNamespace(t0=0.0, t1=1.0, device=None, spans=None)
    assert all(readers[m].read(run) is None for m in NEW)
    assert seen == [] and not trace.ON


def test_idle_with_work_is_at_most_idle_share():
    rng = np.random.default_rng(7)
    for _ in range(20):
        readers, run = synthetic_run()
        edges = np.sort(rng.uniform(104.0, 105.0, 8))
        run.device.gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2])]
        run.device.busy_s = 1.0 - sum(b - a for a, b in run.device.gaps)
        for _ in range(5):
            a = rng.uniform(103.5, 105.5)
            trace.record("request", ns(a), ns(a + rng.uniform(0, 0.5)))
        v = readers["idle_with_work_pct"].read(run)
        idle = harness.load_metric("idle_share").read(run)
        assert 0.0 <= v <= idle + 1e-9


def _span(name, t0, t1, id, parent=None):
    return trace.Span(name, ns(t0), ns(t1), 1, id, parent, {})


def test_gaps_are_named_by_the_innermost_spans_or_no_request():
    spans = [_span("request", 1.0, 2.0, 1),
             _span("engine.decode", 1.1, 1.3, 2),
             _span("engine.decode.enqueue", 1.1, 1.2, 3, parent=2),
             _span("load", 1.0, 3.0, 4),
             _span("load.warmup", 1.5, 2.5, 5, parent=4),
             _span("engine.lock_wait", 1.6, 1.7, 6)]
    assert progtrace.doing(spans, 1.15) == "engine.decode.enqueue+load"
    assert progtrace.doing(spans, 1.25) == "engine.decode+load"
    assert progtrace.doing(spans, 1.65) == "engine.lock_wait+load.warmup"
    assert progtrace.doing(spans, 2.2) == progtrace.NO_REQUEST
    assert progtrace.doing(spans[:1], 1.5) == progtrace.NO_SPAN
    v = progtrace.View(spans, 0.0, 4.0, zero=0.9,
                       gaps=[(1.1, 1.2), (2.1, 2.4), (1.6, 1.65)])
    assert progtrace.name_gaps(v, 2) == [
        [f"{progtrace.NO_REQUEST} at +1.200s", pytest.approx(0.3)],
        ["engine.decode.enqueue+load at +0.200s", pytest.approx(0.1)]]


def _engine(arch):
    cfg = configs.get_smoke(arch)
    params = MDL.init_params(generator_for(CPU, 0), cfg, device=CPU)
    return InferenceEngine(cfg, params, batch_slots=3, max_len=64,
                           device=CPU)


def test_the_program_spans_list_the_calls_the_wrappers_list():
    spans = Spans().install()
    rec = trace.enable()
    try:
        for arch in ("qwen2.5-3b", "rwkv6-3b"):
            eng = _engine(arch)
            reqs = [Request(id=f"{arch}.{i}", max_new_tokens=2 + i,
                            prompt=np.arange(1, 9 + 5 * i, dtype=np.int32))
                    for i in range(3)]
            for r in reqs[:2]:
                assert eng.try_admit(r)
            eng.step()
            assert eng.try_admit(reqs[2])
            while eng.active_count():
                eng.step()
        g = torch.Generator().manual_seed(0)
        for B, Sq, Skv, H, KVH, causal, window in (
                (1, 8, 8, 4, 2, True, 0), (2, 1, 16, 4, 1, False, 0),
                (1, 12, 12, 2, 2, True, 4)):
            q = torch.randn(B, Sq, H, 16, generator=g)
            k, v = (torch.randn(B, Skv, KVH, 16, generator=g)
                    for _ in range(2))
            fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        for B, S in ((1, 1), (2, 40), (1, 70)):
            r, k, v = (torch.randn(B, S, 2, 8, generator=g)
                       for _ in range(3))
            lw = -torch.rand(B, S, 2, 8, generator=g)
            u = torch.randn(2, 8, generator=g)
            wkv_ops.wkv6(r, k, v, lw, u, torch.zeros(B, 2, 8, 8))
    finally:
        spans.remove()
        trace.disable()

    def ours(name):
        return sorted(rec.named(name), key=lambda s: s.t0)

    def theirs(kind):
        return sorted((s for s in spans.spans if s.kind == kind),
                      key=lambda s: s.t0)

    assert [(s.attrs["S"], s.attrs["cfg"]) for s in ours("model.prefill")] \
        == [(s.info["S"], s.info["cfg"]) for s in theirs("prefill")]
    assert len(ours("model.prefill")) == 6
    assert [s.attrs["contexts"] for s in ours("engine.decode")] == \
        [s.info["contexts"] for s in theirs("decode")]
    assert rec.counts["engine.decode_tokens"] == spans.decode_tokens
    assert len(ours("engine.decode")) == spans.decode_steps > 0
    for kind in ("k1", "k4"):
        assert [s.attrs for s in ours(kind)] == [s.info for s in theirs(kind)]
        assert len(ours(kind)) == 3


def test_a_traced_smoke_run_reads_the_program_records(tmp_path, capfd):
    smoke_tree(tmp_path)
    out = harness.run_cell("qwen2.5-3b.longdoc-crash", 2**31 + 11, 4.0, True,
                           device="cpu", root=tmp_path / "bench",
                           bench_json=tmp_path / "BENCHMARK.json")
    assert out["correct"], out["checks"]
    assert not trace.ON
    got = out["metrics"]
    for m in NEW:
        assert got[m]["value"] >= 0.0, m
    assert got["idle_with_work_pct"]["value"] <= got["idle_share"]["value"]
    run = out["_run"]
    v = progtrace.view(run)
    # each of the wrappers' calls, installed as the window opened, holds
    # the program's span of the call (a prefill's with the same length)
    def held(kind, name, same):
        ours = [s for s in v.spans if s.name == name]
        return [w for w in run.spans.spans if w.kind == kind
                and any(w.t0 <= s.t0 * 1e-9 and s.t1 * 1e-9 <= w.t1
                        and same(s, w) for s in ours)]
    wraps = [w for w in run.spans.spans if w.kind == "prefill"]
    assert wraps and wraps == held(
        "prefill", "model.prefill", lambda s, w: s.attrs["S"] == w.info["S"])
    wraps = [w for w in run.spans.spans if w.kind == "decode"]
    assert len(wraps) == run.spans.decode_steps > 0
    assert wraps == held("decode", "engine.decode", lambda s, w: True)
    err = capfd.readouterr().err
    line = next(ln for ln in err.splitlines() if ln.startswith("progtrace "))
    named = json.loads(line[len("progtrace "):])["idle_gaps"]
    assert named and all(" at +" in n for n, _ in named)
    assert not any(n.startswith("no model call") for n, _ in named)
