"""Heartbeat failure detection, copied from ``repro/core/heartbeat.py``
(the port imports nothing from ``repro``). Original docstring:

Heartbeat failure detection (paper §4: push-alive every T=20ms, two
consecutive misses => failure; controller sweep every 100ms).

A Clock abstraction lets the same detector run against the discrete-event
simulator (SimClock) and the real thread-based mini-testbed (WallClock).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Set


class Clock:
    def now(self) -> float:
        raise NotImplementedError


class WallClock(Clock):
    def now(self) -> float:
        return time.monotonic()


class SimClock(Clock):
    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


@dataclass
class FailureDetector:
    """Declares a server failed after `miss_count` missed heartbeats."""
    clock: Clock
    interval: float = 0.020          # T (s)
    miss_count: int = 2
    last_seen: Dict[str, float] = field(default_factory=dict)
    failed: Set[str] = field(default_factory=set)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def beat(self, server_id: str):
        with self._lock:
            self.last_seen[server_id] = self.clock.now()
            self.failed.discard(server_id)

    def deregister(self, server_id: str):
        with self._lock:
            self.last_seen.pop(server_id, None)
            self.failed.discard(server_id)

    def mark_failed(self, server_id: str):
        """External confirmation (e.g. scenario injection) that a node is
        down; keeps sweep() from re-reporting it."""
        with self._lock:
            self.failed.add(server_id)

    def revive(self, server_id: str):
        """A node rejoined: treat its first heartbeat as just received so
        it is no longer considered failed."""
        with self._lock:
            self.last_seen[server_id] = self.clock.now()
            self.failed.discard(server_id)

    def sweep(self) -> List[str]:
        """Returns servers that newly crossed the failure threshold."""
        now = self.clock.now()
        newly = []
        with self._lock:
            for sid, seen in self.last_seen.items():
                if sid in self.failed:
                    continue
                if now - seen > self.miss_count * self.interval:
                    self.failed.add(sid)
                    newly.append(sid)
        return newly

    def detection_latency_bound(self) -> float:
        return self.miss_count * self.interval
