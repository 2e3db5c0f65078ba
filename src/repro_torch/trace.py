"""The port's tracer: spans and counters at its layer boundaries, held in
memory for one recording.

Off by default. ``enable()`` starts a recording and ``disable()`` ends it
and returns its ``Records``; there is no exporter, file or thread. A site
reads ``ON`` before it calls in, so that, off, it costs one module-global
read: no clock call, no allocation, no lock. A span with attributes::

    with trace.span("engine.decode", slots=n) if trace.ON else trace.OFF:
        ...

and a span opened on one thread and closed on another, from the two
timestamps the program already keeps::

    if trace.ON:
        trace.record("request", t_admit_ns, t_done_ns, req=req.id)

A span's times are ``time.monotonic_ns()``, the clock of ``time.
monotonic()`` (``seconds * 1e9``, see ``ns``). Its parent is the span open
on the same thread when it opened (when it was recorded, for ``record``).
Spans of one request carry ``req``, spans of one failover its ``epoch``.

``Records.anchor`` pairs a monotonic and a wall-clock (``time.time_ns``)
reading taken together at ``enable()``; ``Records.to_monotonic_ns`` maps a
CLOCK_REALTIME time, such as a ``torch.profiler`` trace's start
(``kineto_results.trace_start_ns()``), onto the spans' clock.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

ON = False
_rec: Optional["Records"] = None
_ids = itertools.count(1)
_open = threading.local()           # .stack: ids of this thread's open spans


class Span(NamedTuple):
    name: str
    t0: int                         # monotonic ns
    t1: int
    thread: int                     # threading.get_ident()
    id: int
    parent: Optional[int]           # id of the span that caused it
    attrs: Dict


@dataclass
class Records:
    """What one recording holds."""
    anchor: Tuple[int, int]         # (monotonic ns, time.time_ns) together
    spans: List[Span] = field(default_factory=list)
    counts: Dict[str, int] = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def to_monotonic_ns(self, realtime_ns: int) -> int:
        mono, real = self.anchor
        return realtime_ns - (real - mono)


class _Off:
    """The span a site opens while the tracer is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _stack() -> List[int]:
    st = getattr(_open, "stack", None)
    if st is None:
        st = _open.stack = []
    return st


class _Span:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "t0")

    def __init__(self, rec: Records, name: str, attrs: Dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else None
        self.id = next(_ids)
        st.append(self.id)
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        st = _stack()
        if st and st[-1] == self.id:
            st.pop()
        self.rec.spans.append(Span(self.name, self.t0, t1,
                                   threading.get_ident(), self.id,
                                   self.parent, self.attrs))
        return False


def now() -> int:
    """The spans' clock."""
    return time.monotonic_ns()


def ns(t: float) -> int:
    """A ``time.monotonic()`` reading on the spans' clock."""
    return round(t * 1e9)


def enable() -> Records:
    """Start a recording (a recording in progress is dropped)."""
    global ON, _rec
    a = time.monotonic_ns()
    real = time.time_ns()
    b = time.monotonic_ns()
    _rec = Records(anchor=((a + b) // 2, real))
    ON = True
    return _rec


def disable() -> Optional[Records]:
    """End the recording; its records, or None if none was in progress."""
    global ON, _rec
    rec, _rec, ON = _rec, None, False
    return rec


def span(name: str, **attrs):
    """A span over a ``with`` block; call only while ``ON``."""
    rec = _rec
    return OFF if rec is None else _Span(rec, name, attrs)


def record(name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
    """A span whose two ends the caller timed; call only while ``ON``."""
    rec = _rec
    if rec is None:
        return
    st = _stack()
    rec.spans.append(Span(name, t0_ns, t1_ns, threading.get_ident(),
                          next(_ids), st[-1] if st else None, attrs))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter; call only while ``ON``."""
    rec = _rec
    if rec is None:
        return
    with rec.lock:
        rec.counts[name] = rec.counts.get(name, 0) + n
