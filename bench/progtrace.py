"""The program's own records (``repro_torch.trace``) in a traced run: its
spans over the window, the profiled slice's idle stretches mapped onto
their clock, and those stretches named by what the program was doing.

The harness keeps no handle on the program's tracer, so its readers arm
it: a metric file that reads the program's records calls ``arm()`` as it
is loaded, which hooks ``torch.profiler.profile``'s start and stop and
starts nothing else. The first profile started after that starts the
tracer: in a traced run the harness starts one after the warm-up, before
the window, so the recording holds the window and the drain, and an
untraced run never starts the tracer. Each profile that stops notes its
trace's start (``kineto_results.trace_start_ns()``, on CLOCK_REALTIME)
mapped onto the host clock through a (monotonic, realtime) pair read as
it stops. The profiler counts its events from that start;
``bench/trace.device_trace`` counts them from the host clock read after
the profiler started (``DeviceTrace.t0``), so the two zeros differ by
``View.zero_offset_s``.

The first ``view(run)`` of a run ends the recording and undoes the hooks,
and logs the slice's longest idle stretches, named, and the window's
spans by name to standard error; later calls give the same view. Each
call leaves the tracer off and torch's profiler as it was. Where the
program has no tracer (a commit before it) or the run was untraced,
``view`` gives None.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

NO_REQUEST = "no request in flight"
NO_SPAN = "request in flight, no span open"


class _Arming:
    def __init__(self):
        self.tracer = None          # repro_torch.trace, once armed
        self.hooked = None          # profile's (start, stop), unpatched
        self.rec = None             # the recording the first start began
        self.zeros: List[Tuple[float, int]] = []  # (stopped at, zero ns)
        self.run = None
        self.view: Optional["View"] = None


_A = _Arming()


def _clocks() -> Tuple[int, int]:
    """A (monotonic ns, realtime ns) pair read together."""
    a = time.monotonic_ns()
    real = time.time_ns()
    return (a + time.monotonic_ns()) // 2, real


def arm() -> None:
    """Hook each profile's start (the first starts the program's tracer)
    and stop (its trace's start, mapped, is noted)."""
    _disarm()
    _A.tracer = None
    try:
        from repro_torch import trace
    except ImportError:
        return
    import torch.profiler

    _A.tracer = trace
    _A.zeros = []
    prof_cls = torch.profiler.profile
    _A.hooked = start0, stop0 = prof_cls.start, prof_cls.stop

    def start(prof):
        if _A.rec is None:
            _A.rec = trace.enable()
        start0(prof)

    def stop(prof):
        stop0(prof)
        mono, real = _clocks()
        try:
            t = prof.profiler.kineto_results.trace_start_ns()
        except AttributeError:
            return
        _A.zeros.append((time.monotonic(), int(t) - (real - mono)))

    prof_cls.start, prof_cls.stop = start, stop


def _disarm():
    """Undo the hooks and end the recording; its records, or None."""
    if _A.hooked is not None:
        import torch.profiler
        torch.profiler.profile.start, torch.profiler.profile.stop = _A.hooked
        _A.hooked = None
    rec, _A.rec = _A.rec, None
    if rec is not None:
        _A.tracer.disable()
    return rec


@dataclass
class View:
    """One run's program records, in seconds on the host clock."""
    spans: List                     # repro_torch.trace.Span
    t0: float                       # the window
    t1: float
    zero: Optional[float] = None    # the profile's zero, mapped
    zero_offset_s: Optional[float] = None   # zero - DeviceTrace.t0
    gaps: Optional[List[Tuple[float, float]]] = None  # mapped idle stretches

    def durations(self, name: str) -> List[float]:
        """Seconds of each span ``name`` that started in the window."""
        a, b = round(self.t0 * 1e9), round(self.t1 * 1e9)
        return [(s.t1 - s.t0) * 1e-9 for s in self.spans
                if s.name == name and a <= s.t0 < b]


def view(run) -> Optional[View]:
    if _A.run is run:
        _disarm()
        return _A.view
    rec = _disarm()
    _A.run, _A.view = run, None
    if rec is None or run.spans is None:
        return None
    v = View(rec.spans, run.t0, run.t1)
    dev = run.device
    if dev is not None:
        stop = dev.t0 + dev.window_s
        after = [(t, z) for t, z in _A.zeros if t >= stop]
        if after:
            v.zero = min(after)[1] * 1e-9
            v.zero_offset_s = v.zero - dev.t0
            v.gaps = [(a + v.zero_offset_s, b + v.zero_offset_s)
                      for a, b in dev.gaps]
            print("progtrace " + json.dumps({
                "zero_offset_ms": 1e3 * v.zero_offset_s,
                "idle_gaps": name_gaps(v), "spans": by_name(v)}),
                file=sys.stderr, flush=True)
    _A.view = v
    return v


def by_name(v: View) -> dict:
    """Each span name's count and mean milliseconds over the window."""
    out = {}
    for name in sorted({s.name for s in v.spans}):
        d = v.durations(name)
        if d:
            out[name] = [len(d), round(1e3 * sum(d) / len(d), 3)]
    return out


def intervals(spans, name: str) -> List[Tuple[float, float]]:
    """The union of the spans ``name``, in seconds, sorted."""
    out: List[List[float]] = []
    for a, b in sorted((s.t0 * 1e-9, s.t1 * 1e-9) for s in spans
                       if s.name == name):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(gaps, busy) -> float:
    """Seconds of ``gaps`` covered by the sorted, disjoint ``busy``."""
    total = 0.0
    for a, b in gaps:
        for c, d in busy:
            if c >= b:
                break
            total += max(0.0, min(b, d) - max(a, c))
    return total


def doing(spans, t: float) -> str:
    """What the program was doing at ``t``: the innermost spans open then
    (those no open span names as parent), ``request`` aside; or that no
    request was in flight."""
    tn = round(t * 1e9)
    open_ = [s for s in spans if s.t0 <= tn < s.t1]
    if not any(s.name == "request" for s in open_):
        return NO_REQUEST
    work = [s for s in open_ if s.name != "request"]
    parents = {s.parent for s in work}
    names = sorted({s.name for s in work if s.id not in parents})
    return "+".join(names) if names else NO_SPAN


def name_gaps(v: View, n: int = 10) -> List:
    """The ``n`` longest idle stretches of the slice, as ``breakdown``
    lists them (``<what> at +<t>s``, seconds), named by ``doing``."""
    gaps = sorted(v.gaps, key=lambda g: g[0] - g[1])[:n]
    return [[f"{doing(v.spans, (a + b) / 2)} at +{a - v.zero:.3f}s", b - a]
            for a, b in gaps]
