"""The traced run: the benchmark's spans around calls into the program, and
the reduction of a device trace to busy time, kernel time and a breakdown.

``Spans`` wraps, for one traced run only, the calls the per-layer metrics
read: the model's ``prefill`` and ``decode_step``, K1's and K4's entry
points, the engine's ``step`` and a worker's ``load``. Each wrapper notes
its call's shape and its start and end on the host clock; the model calls
end in a host read of their tokens, so their work lies inside their span.
The untraced runs leave the program as it is.

``device_trace`` reduces ``torch.profiler``'s kernel events over a fixed
slice of the window (CUPTI records every thread's kernels): the union of
kernel intervals (busy time), each kernel's time by name, and the longest
stretches with no kernel running, named by the model call the host was in
then.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

K1_KERNEL = re.compile(r"\bfa_(tc_)?kernel\b")
K4_CHUNKED_KERNEL = re.compile(r"\bwkv_chunk_(state|scan|out)_kernel\b")


@dataclass
class Span:
    kind: str
    t0: float
    t1: float
    info: Dict = field(default_factory=dict)


class Spans:
    """Wrappers installed into the program for one traced run."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: List[Span] = []
        self.decode_steps = 0
        self.decode_tokens = 0
        self._undo: List[Tuple[object, str, object]] = []

    def _add(self, span: Span):
        with self.lock:
            self.spans.append(span)

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def install(self):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
        from repro_torch.models import model as MDL
        from repro_torch.serving.engine import InferenceEngine
        from repro_torch.serving.server import WorkerServer

        def prefill(orig):
            def f(params, cfg, tokens, cache, prefix_embeds=None):
                t0 = time.monotonic()
                out = orig(params, cfg, tokens, cache, prefix_embeds)
                self._add(Span("prefill", t0, time.monotonic(),
                               {"S": int(tokens.shape[1]), "cfg": cfg}))
                return out
            return f

        def step(orig):
            def f(eng):
                with eng._lock:
                    ctx = [len(r.prompt) + len(r.tokens) for r in eng.slots
                           if r is not None and r.tokens]
                before = eng.steps
                t0 = time.monotonic()
                out = orig(eng)
                if eng.steps > before:
                    self._add(Span("decode", t0, time.monotonic(),
                                   {"contexts": ctx, "cfg": eng.cfg}))
                    with self.lock:
                        self.decode_steps += 1
                        self.decode_tokens += len(ctx)
                return out
            return f

        def k1(orig):
            def f(q, k, v, *, causal=True, window=0):
                t0 = time.monotonic()
                out = orig(q, k, v, causal=causal, window=window)
                B, Sq, H, hd = q.shape
                self._add(Span("k1", t0, time.monotonic(), {
                    "B": B, "Sq": Sq, "Skv": k.shape[1], "H": H,
                    "KVH": k.shape[2], "hd": hd, "causal": causal,
                    "window": window, "elt": q.element_size()}))
                return out
            return f

        def k4(orig):
            def f(r, k, v, lw, u, s0, *, s_out=None):
                t0 = time.monotonic()
                out = orig(r, k, v, lw, u, s0, s_out=s_out)
                B, S, nh, hs = r.shape
                self._add(Span("k4", t0, time.monotonic(), {
                    "B": B, "S": S, "NH": nh, "hs": hs,
                    "chunked": wkv_ops.chunked_route(S),
                    "elt": r.element_size()}))
                return out
            return f

        def load(orig):
            def f(worker, app, variant, warm=True):
                t0 = time.monotonic()
                try:
                    return orig(worker, app, variant, warm)
                finally:
                    self._add(Span("load", t0, time.monotonic()))
            return f

        self._patch(MDL, "prefill", prefill)
        self._patch(InferenceEngine, "step", step)
        self._patch(fa_ops, "flash_attention", k1)
        self._patch(wkv_ops, "wkv6", k4)
        self._patch(WorkerServer, "load", load)
        return self

    def remove(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()

    def within(self, kind: str, a: float, b: float) -> List[Span]:
        """Spans of ``kind`` that started in [a, b)."""
        with self.lock:
            return [s for s in self.spans if s.kind == kind and a <= s.t0 < b]

    def overlapping(self, kind: str, a: float, b: float
                    ) -> List[Tuple[Span, float]]:
        """(span, share of it inside [a, b]) for spans of ``kind``."""
        out = []
        with self.lock:
            spans = [s for s in self.spans if s.kind == kind]
        for s in spans:
            lo, hi = max(a, s.t0), min(b, s.t1)
            if hi > lo:
                out.append((s, (hi - lo) / max(s.t1 - s.t0, 1e-9)))
        return out


@dataclass
class DeviceTrace:
    t0: float                      # host clock at the slice's start
    window_s: float
    busy_s: float
    by_name: Dict[str, float]      # kernel name -> seconds in the slice
    gaps: List[Tuple[float, float]]  # idle stretches, host clock

    def kernel_s(self, pattern: re.Pattern) -> float:
        return sum(t for n, t in self.by_name.items() if pattern.search(n))


def device_trace(prof, t0: float, t1: float) -> DeviceTrace:
    """Reduce a profile taken over the host interval [t0, t1]."""
    from torch.autograd import DeviceType

    span_us = (t1 - t0) * 1e6
    intervals = []
    by_name: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        a, b = max(a, 0.0), min(b, span_us)
        if b <= a:
            continue
        intervals.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) * 1e-6
    intervals.sort()
    busy = 0.0
    gaps = []
    cur_a = cur_b = None
    last_end = 0.0
    for a, b in intervals:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            if a > last_end:
                gaps.append((last_end, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        last_end = cur_b
    if cur_b is not None:
        busy += cur_b - cur_a
    if span_us > last_end:
        gaps.append((last_end, span_us))
    return DeviceTrace(t0, t1 - t0, busy * 1e-6, by_name,
                       [(t0 + a * 1e-6, t0 + b * 1e-6) for a, b in gaps])


def host_activity(spans: Spans, t: float) -> str:
    """What the host was doing at ``t``: the model calls in flight."""
    kinds = sorted({s.kind for s in spans.spans
                    if s.t0 <= t < s.t1 and s.kind in
                    ("prefill", "decode", "load")})
    return "+".join(kinds) if kinds else "no model call"


def breakdown(dev: DeviceTrace, spans: Optional[Spans]) -> Dict:
    ops = sorted(dev.by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(dev.gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        what = host_activity(spans, (a + b) / 2) if spans else "unknown"
        named.append([f"{what} at +{a - dev.t0:.3f}s", b - a])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}
