"""The port's tracer (``repro_torch.trace``) on the CPU: off, the engine's
span sites call nothing of it and read no clock; on, spans nest, one
request's spans share its id, a live testbed records every detection and
the plan rounds of failover and re-protection, and a span's clock holds a
profiler event mapped through the anchor."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, trace  # noqa: E402
from repro_torch.device import generator_for  # noqa: E402
from repro_torch.models import model as MDL  # noqa: E402
from repro_torch.serving.engine import InferenceEngine, Request  # noqa: E402
from repro_torch.serving.server import WorkerServer  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    yield
    trace.disable()


def _engine(arch="qwen2.5-3b", slots=2):
    cfg = configs.get_smoke(arch)
    params = MDL.init_params(generator_for(CPU, 0), cfg, device=CPU)
    return InferenceEngine(cfg, params, batch_slots=slots, max_len=48,
                           device=CPU)


def _serve(eng, n=2, new=3):
    reqs = [Request(id=f"r{i}", prompt=np.arange(1, 6 + i, dtype=np.int32),
                    max_new_tokens=new) for i in range(n)]
    for r in reqs:
        assert eng.try_admit(r)
    while eng.active_count():
        eng.step()
    return reqs


def test_off_the_sites_call_no_clock_and_nothing_of_the_tracer(monkeypatch):
    eng = _engine()
    calls = []
    real = time.monotonic_ns

    def counted():
        calls.append(1)
        return real()

    def refuse(*a, **k):
        raise AssertionError("a site called the tracer while it was off")

    monkeypatch.setattr(time, "monotonic_ns", counted)
    for name in ("span", "record", "count", "now", "ns"):
        monkeypatch.setattr(trace, name, refuse)
    reqs = _serve(eng)
    assert all(len(r.tokens) == 4 and r.admitted_ns == 0 for r in reqs)
    assert calls == []
    assert trace.disable() is None


def test_on_spans_nest_and_a_request_shares_its_id():
    eng = _engine()
    rec = trace.enable()
    reqs = _serve(eng)
    assert trace.disable() is rec
    by_id = {s.id: s for s in rec.spans}
    for r in reqs:
        mine = [s for s in rec.spans if s.attrs.get("req") == r.id]
        names = sorted(s.name for s in mine)
        assert names == ["engine.first_decode_wait", "engine.lock_wait",
                         "engine.prefill", "engine.prefill.upload",
                         "request"]
        req_span = next(s for s in mine if s.name == "request")
        assert req_span.t0 == r.admitted_ns
        assert req_span.t1 == trace.ns(r.done_at)
        pre = next(s for s in mine if s.name == "engine.prefill")
        kids = [s for s in rec.spans if s.parent == pre.id]
        assert sorted(k.name for k in kids) == ["engine.prefill.enqueue",
                                                "engine.prefill.sync"]
        enq = next(k for k in kids if k.name == "engine.prefill.enqueue")
        model = [s for s in rec.spans if s.parent == enq.id]
        assert [m.name for m in model] == ["model.prefill"]
        assert model[0].attrs["S"] == len(r.prompt)
    for s in rec.spans:
        assert s.t0 <= s.t1
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.thread == s.thread and p.t0 <= s.t0 and s.t1 <= p.t1
    steps = rec.named("engine.decode")
    assert len(steps) == eng.steps
    assert rec.counts["engine.decode_tokens"] == sum(
        s.attrs["slots"] for s in steps) == sum(len(r.tokens) - 1
                                                for r in reqs)
    for s in steps:
        kids = sorted((k for k in rec.spans if k.parent == s.id),
                      key=lambda k: k.t0)
        assert [k.name for k in kids] == ["engine.decode.upload",
                                          "engine.decode.enqueue",
                                          "engine.decode.sync"]
        assert kids[0].t1 <= kids[1].t0 and kids[1].t1 <= kids[2].t0
        assert [m.name for m in rec.spans if m.parent == kids[1].id] == \
            ["model.decode_step"]
    assert len(rec.named("model.decode_step")) == eng.steps
    waits = [s for s in rec.named("engine.lock_wait") if "step" in s.attrs]
    assert sorted(s.attrs["step"] for s in waits) == list(range(eng.steps))


def test_the_uploads_stand_outside_the_enqueue_spans():
    """The copies of a prompt and of a step's last tokens to the device
    wait for the work queued before them on the stream; each is a span of
    its own, so the enqueue spans hold only the host's issue."""
    eng = _engine()
    rec = trace.enable()
    reqs = _serve(eng, n=1, new=2)
    trace.disable()
    (up,) = rec.named("engine.prefill.upload")
    (wait,) = [s for s in rec.named("engine.lock_wait") if "req" in s.attrs]
    (pre,) = rec.named("engine.prefill")
    assert up.attrs == {"req": reqs[0].id} and up.parent is None
    assert up.t1 <= wait.t0 <= wait.t1 <= pre.t0
    ups = rec.named("engine.decode.upload")
    assert len(ups) == eng.steps == 2
    for name in ("engine.prefill.enqueue", "engine.decode.enqueue"):
        for enq in rec.named(name):
            assert not [u for u in ups + [up]
                        if enq.t0 < u.t1 and u.t0 < enq.t1]


def test_records_spans_across_threads_and_counts():
    rec = trace.enable()

    def work(i):
        with trace.span("outer", i=i):
            with trace.span("inner"):
                trace.count("n", 2)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads)
    t0 = trace.now()
    trace.record("across", t0 - 5, t0, req="x")
    rec2 = trace.disable()
    assert rec2 is rec and rec.counts == {"n": 16}
    outer = {s.id: s for s in rec.named("outer")}
    inner = rec.named("inner")
    assert len(outer) == len(inner) == 8
    assert {outer[s.parent].thread for s in inner} == \
        {s.thread for s in inner}
    assert all(outer[s.parent].thread == s.thread for s in inner)
    (across,) = rec.named("across")
    assert across.parent is None and across.t1 - across.t0 == 5
    # calls made after the recording ended are dropped
    with trace.span("late"):
        trace.record("late", 0, 1)
        trace.count("late")
    assert trace.disable() is None
    assert not rec.named("late") and "late" not in rec.counts
    # enable() starts afresh
    trace.enable()
    with trace.span("a"):
        pass
    fresh = trace.enable()
    assert trace.disable() is fresh and fresh.spans == []


def test_a_request_waits_for_its_first_decode_step_on_the_serve_thread():
    from repro_torch.core.heartbeat import FailureDetector, WallClock
    w = WorkerServer("w0", FailureDetector(WallClock()), device="cpu")
    w.start()
    try:
        w.install("m", _engine())
        rec = trace.enable()
        req = Request(id="q", prompt=np.arange(1, 7, dtype=np.int32),
                      max_new_tokens=2)
        assert w.submit("m", req)
        deadline = time.monotonic() + 30.0
        while req.done_at is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert req.done_at is not None
        trace.disable()
        (wait,) = rec.named("engine.first_decode_wait")
        assert wait.attrs == {"req": "q"}
        assert wait.t0 == trace.ns(req.first_token_at)
        (pre,) = rec.named("engine.prefill")
        first = min(rec.named("engine.decode"), key=lambda s: s.t0)
        assert pre.t1 <= wait.t0 <= wait.t1 <= first.t0
    finally:
        w.kill()
        w.join()


def test_testbed_records_every_detection_and_both_kinds_of_plan_round():
    from repro_torch.serving.testbed import MiniTestbed
    tb = MiniTestbed(apps_per_arch=1, archs=["qwen2.5-3b", "rwkv6-3b"],
                     seed=0, headroom=0.35, alpha=0.1, device="cpu")
    try:
        tb.deploy()
        rec = trace.enable()
        sweeper = threading.Thread(target=tb._sweeper_loop, daemon=True)
        reprotect = threading.Thread(target=tb._reprotect_loop, args=(0.1,),
                                     daemon=True)
        tb._aux_threads += [sweeper, reprotect]
        sweeper.start()
        reprotect.start()
        crit = next(a for a in tb.apps if a.critical)
        std = next(a for a in tb.apps if not a.critical)
        killed = []
        for app in (crit, std):
            with tb._ctl_lock:
                sid = tb.controller.primaries[app.id]
            if sid in killed:
                continue
            n = len(tb._detections)
            tb._fail_servers([sid])
            killed.append(sid)
            deadline = time.monotonic() + 30.0
            while len(tb._detections) == n and time.monotonic() < deadline:
                time.sleep(0.01)
            assert len(tb._detections) == n + 1
        deadline = time.monotonic() + 30.0
        while (not any(s.thread == reprotect.ident
                       for s in rec.named("controller.plan"))
               and time.monotonic() < deadline):
            time.sleep(0.05)
        time.sleep(0.2)
        trace.disable()
        detects = rec.named("failover.detect")
        assert sorted(s.attrs["server"] for s in detects) == sorted(killed)
        assert [s.attrs["epoch"] for s in detects] == list(range(len(killed)))
        assert len(tb._detections) == len(detects)
        for s, (sid, t_fail, t_verdict) in zip(detects, tb._detections):
            assert s.attrs["server"] == sid
            assert s.t0 == trace.ns(t_fail) and s.t1 == trace.ns(t_verdict)
            assert t_fail == tb._kill_times[sid] < t_verdict
        plans = rec.named("controller.plan")
        on = {s.thread for s in plans}
        assert sweeper.ident in on and reprotect.ident in on
        assert all(s.attrs["backend"] == "torch" and s.attrs["apps"] >= 1
                   for s in plans)
        assert any(s.name.startswith("load") for s in rec.spans)
    finally:
        trace.disable()
        tb.shutdown()


def test_a_span_holds_its_profiler_event_on_the_mapped_clock():
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(4096)
    rec = trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with trace.span("op"):
                time.sleep(2e-4)
                x.add_(1.0)
                time.sleep(2e-4)
    trace.disable()
    start = prof.profiler.kineto_results.trace_start_ns()
    events = [e for e in prof.events() if e.name == "aten::add_"]
    spans = rec.named("op")
    assert len(events) == len(spans) == 5
    for e, s in zip(sorted(events, key=lambda e: e.time_range.start),
                    sorted(spans, key=lambda s: s.t0)):
        a = rec.to_monotonic_ns(start + round(e.time_range.start * 1e3))
        b = rec.to_monotonic_ns(start + round(e.time_range.end * 1e3))
        assert s.t0 <= a <= b <= s.t1, (s.t0 - a, s.t1 - b)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUPTI's kernel times are the card's")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_intervals_fall_inside_their_spans_on_the_card(cuda):
    """A span around a launch and ``torch.cuda.synchronize()`` holds the
    kernel's interval that the profiler (CUDA activity alone, as the
    benchmark's traced slice) reports, mapped through ``trace_start_ns``
    and the anchor: the spans and the device trace share a clock. Prints
    the worst excursion over 100 spans and how far the host clock read
    after the profiler started sits from the profile's mapped zero."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(2048, 2048, device=cuda, dtype=torch.bfloat16)
    for _ in range(3):
        a @ a
    torch.cuda.synchronize(cuda)
    rec = trace.enable()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    host_zero = time.monotonic()
    for _ in range(100):
        with trace.span("launch"):
            a @ a
            torch.cuda.synchronize(cuda)
    prof.__exit__(None, None, None)
    trace.disable()
    start = prof.profiler.kineto_results.trace_start_ns()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    spans = sorted(rec.named("launch"), key=lambda s: s.t0)
    assert len(kernels) == len(spans) == 100
    worst, slack = 0, []
    for e, s in zip(kernels, spans):
        k0 = rec.to_monotonic_ns(start + round(e.time_range.start * 1e3))
        k1 = rec.to_monotonic_ns(start + round(e.time_range.end * 1e3))
        worst = max(worst, s.t0 - k0, k1 - s.t1)
        slack.append((k0 - s.t0, s.t1 - k1))
    zero = rec.to_monotonic_ns(start) * 1e-9
    print(f"\nworst excursion {worst} ns over 100 spans; least slack before "
          f"{min(b for b, _ in slack)} ns, after {min(a for _, a in slack)} "
          f"ns; host zero - mapped zero {1e3 * (host_zero - zero):.3f} ms")
    assert worst <= 0
