"""Request router: epoch-versioned routing table + client notification.

A copy of ``repro/serving/router.py`` (the port imports nothing from
``repro``); ``tests/test_torch_control.py`` holds it against the original.

The controller bumps the routing epoch on every failover (the paper's
websocket push, §4); clients observe the new (server, variant) on their
next request — plus explicit notify callbacks for push semantics.

Concurrency contract (relied on by the mini-testbed and asserted by
tests/test_router.py):

  * epochs are strictly monotonic: every successful `set_route` returns
    a unique epoch, and concurrent calls never reuse or skip one;
  * subscribers see every route change **exactly once and in epoch
    order** — notification happens while the (reentrant) lock is held,
    so two concurrent `set_route` calls cannot interleave their
    callbacks or deliver out of order;
  * `snapshot()` returns an (epoch, routes) pair that is internally
    consistent: the routes are exactly the table contents at that epoch.

Subscribers must not block: they run inside the router's critical
section. The lock is reentrant, so a subscriber may read the router
(`lookup`, `epoch`, `snapshot`) but should not call `set_route`.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple


class Router:
    def __init__(self):
        self._routes: Dict[str, Tuple[str, str]] = {}
        self._backups: Dict[str, Tuple[str, str]] = {}
        self._epoch = 0
        self._lock = threading.RLock()
        self._subscribers: List[Callable[[str, str, str], None]] = []
        self._versioned: List[Callable[[int, str, str, str], None]] = []

    def set_route(self, app_id: str, server_id: str,
                  variant: str) -> int:
        """Install a route, bump the epoch, push to subscribers.

        Returns the epoch assigned to this change (strictly monotonic
        across threads).
        """
        with self._lock:
            self._routes[app_id] = (server_id, variant)
            self._epoch += 1
            epoch = self._epoch
            for fn in list(self._subscribers):
                fn(app_id, server_id, variant)       # push notification
            for fn in list(self._versioned):
                fn(epoch, app_id, server_id, variant)
        return epoch

    def drop_route(self, app_id: str) -> Optional[int]:
        """Remove a route (app departure); returns the epoch of the
        change, or None if the app had no route.

        Drops are pushed like sets — subscribers receive server=None,
        variant=None — so the exactly-once/no-gaps epoch contract holds
        across every route change, not just installs.
        """
        with self._lock:
            if self._routes.pop(app_id, None) is None:
                return None
            self._epoch += 1
            epoch = self._epoch
            for fn in list(self._subscribers):
                fn(app_id, None, None)
            for fn in list(self._versioned):
                fn(epoch, app_id, None, None)
        return epoch

    def lookup(self, app_id: str) -> Optional[Tuple[str, str]]:
        with self._lock:
            return self._routes.get(app_id)

    # -- backup routes (resilience layer) -----------------------------------
    # Hedged requests and breaker fail-fast need the app's warm-backup
    # (server, variant) next to the primary route. Backups do not bump
    # the epoch: they are advisory (the hedge target), not the serving
    # route — the epoch contract above stays exactly as documented.
    def set_backup(self, app_id: str, server_id: str, variant: str):
        with self._lock:
            self._backups[app_id] = (server_id, variant)

    def drop_backup(self, app_id: str):
        with self._lock:
            self._backups.pop(app_id, None)

    def lookup_backup(self, app_id: str) -> Optional[Tuple[str, str]]:
        with self._lock:
            return self._backups.get(app_id)

    def sync_backups(self, table: Dict[str, Tuple[str, str]]):
        """Replace the whole backup table (controller warm-set sync)."""
        with self._lock:
            self._backups = dict(table)

    def snapshot(self) -> Tuple[int, Dict[str, Tuple[str, str]]]:
        """Consistent (epoch, routes-copy) pair."""
        with self._lock:
            return self._epoch, dict(self._routes)

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def subscribe(self, fn: Callable[[str, str, str], None]):
        with self._lock:
            self._subscribers.append(fn)

    def subscribe_versioned(self, fn: Callable[[int, str, str, str],
                                               None]):
        """Like subscribe, but the callback also receives the epoch the
        change was assigned — lets clients detect missed pushes."""
        with self._lock:
            self._versioned.append(fn)
