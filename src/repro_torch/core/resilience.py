"""Request-plane resilience toolkit: hedging, circuit breakers,
bulkheads, retry budgets, and drain-gated admission control.

FailLite's contribution is fast *recovery* (175.5 ms MTTR); this layer
shapes the request plane *while* the controller recovers, so failover
storms cannot erase the MTTR win:

  * **hedged requests** — after a configurable delay a pending request
    is re-issued to the app's warm backup and the first success wins
    (the loser is cancelled). Clients of warm-protected apps bridge the
    detection gap instead of timing out against a dead primary.
  * **circuit breakers** — per-app closed/open/half-open state machines
    over a rolling failure window. An open breaker fails fast to the
    degraded (warm backup) variant instead of queueing on a dead
    primary; half-open probes detect recovery.
  * **bulkheads** — per-server bounded in-flight slots, so one app's
    failover storm cannot starve co-located apps of worker capacity.
  * **retry-with-budget** — retries are paid from a token budget that
    accrues per fresh request, bounding retry amplification.
  * **drain-gated admission** — while the `RecoveryScheduler` is
    draining recovery loads, offered load above ``admit_util`` is
    rate-limited (deterministic token-bucket thinning): draining
    servers shed excess load instead of absorbing it into a
    metastable queueing collapse.

Both execution backends enforce the same config: the mini-testbed
(serving/testbed.py) applies the primitives live on real worker
threads, while the simulator applies the equivalent *vectorized*
outcome shaping (`shape_app_log`) to the classified request arrays —
a pure function of the recorded timelines and the config, with **no
new RNG draws**, so runs stay bit-deterministic and the off-path
(``enabled=False`` or no config at all) is bit-exact with the
pre-resilience behavior (pinned by tests/test_resilience.py).

New outcome classes (core/metrics.py): hedged-win, fast-failed, shed,
retried — every request is still classified exactly once
(tests/test_properties.py pins the conservation invariant).
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import asdict, dataclass, fields
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.metrics import UP, AppLog, DowntimeWindow


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ResilienceConfig:
    """Knobs of the request-plane resilience layer.

    ``enabled=False`` (the default) keeps every request path
    bit-exactly on the historical behavior; a spec/SimConfig carries
    the config as a plain dict (JSON round-trip), coerced here.
    """
    enabled: bool = False
    # hedging: delay before the backup is engaged; the testbed scales a
    # live latency percentile, the simulator the backup's service time
    hedge_delay_factor: float = 2.0
    hedge_min_delay_s: float = 0.02
    # circuit breaker: rolling outcome window + failure-rate trip rule
    breaker_window: int = 8
    breaker_failure_rate: float = 0.5
    breaker_min_failures: int = 4
    breaker_open_s: float = 0.5
    breaker_probes: int = 1
    # bulkhead: bounded in-flight submissions per server
    bulkhead_slots: int = 4
    # retry budget: tokens accrued per fresh request / spent per retry
    retry_budget: float = 0.2
    retry_backoff_s: float = 0.02
    # admission during recovery drain: offered utilization ceiling
    admit_util: float = 0.75

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ResilienceConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ResilienceConfig fields: "
                             f"{sorted(unknown)}")
        return cls(**d)

    @classmethod
    def coerce(cls, value) -> Optional["ResilienceConfig"]:
        """None | dict | ResilienceConfig -> config or None.

        A dict without an explicit ``enabled`` key means "turn it on"
        (passing a config at all expresses intent); ``None`` and
        ``enabled=False`` both mean the off-path.
        """
        if value is None:
            return None
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            d = dict(value)
            d.setdefault("enabled", True)
            return cls.from_dict(d)
        raise TypeError(f"cannot coerce {type(value).__name__} "
                        f"to ResilienceConfig")


def active(value) -> Optional[ResilienceConfig]:
    """Coerce + gate: the config when enabled, else None."""
    cfg = ResilienceConfig.coerce(value)
    return cfg if (cfg is not None and cfg.enabled) else None


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


class CircuitBreaker:
    """Per-app failure-rate breaker (closed -> open -> half-open).

    Closed: outcomes fold into a rolling window; the breaker trips when
    the window holds at least ``breaker_min_failures`` failures AND the
    window failure rate reaches ``breaker_failure_rate``. Open: every
    request fails fast (to the degraded variant, if the caller has one)
    until ``breaker_open_s`` elapses, then half-open grants
    ``breaker_probes`` probe requests — one success closes the breaker,
    one failure re-opens it. Thread-safe; the clock is injectable so
    the state machine is unit-testable without sleeping.
    """

    def __init__(self, cfg: ResilienceConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self._window: List[bool] = []       # True = failure
        self._opened_at = 0.0
        self._probes_left = 0

    def allow(self) -> bool:
        """May the next request go to the primary?"""
        with self._lock:
            if self.state == OPEN:
                if self.clock() - self._opened_at >= self.cfg.breaker_open_s:
                    self.state = HALF_OPEN
                    self._probes_left = self.cfg.breaker_probes
                else:
                    return False
            if self.state == HALF_OPEN:
                if self._probes_left <= 0:
                    return False
                self._probes_left -= 1
                return True
            return True

    def record(self, ok: bool):
        with self._lock:
            if self.state == HALF_OPEN:
                if ok:
                    self.state = CLOSED
                    self._window = []
                else:
                    self._trip()
                return
            if self.state == OPEN:
                return
            self._window.append(not ok)
            if len(self._window) > self.cfg.breaker_window:
                self._window.pop(0)
            fails = sum(self._window)
            if (fails >= self.cfg.breaker_min_failures
                    and fails >= self.cfg.breaker_failure_rate
                    * len(self._window)):
                self._trip()

    def _trip(self):
        self.state = OPEN
        self._opened_at = self.clock()
        self._window = []


# ---------------------------------------------------------------------------
# bulkhead
# ---------------------------------------------------------------------------

class Bulkhead:
    """Bounded in-flight slots (per server): acquire-or-reject."""

    def __init__(self, slots: int):
        self.slots = max(1, int(slots))
        self._lock = threading.Lock()
        self._in_flight = 0

    def try_acquire(self) -> bool:
        with self._lock:
            if self._in_flight >= self.slots:
                return False
            self._in_flight += 1
            return True

    def release(self):
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight


# ---------------------------------------------------------------------------
# retry budget
# ---------------------------------------------------------------------------

class RetryBudget:
    """Token bucket bounding retry amplification: each fresh request
    accrues ``retry_budget`` tokens (capped), each retry spends one —
    so the retry rate can never exceed ``retry_budget`` times the
    offered rate, no matter how long the outage lasts."""

    def __init__(self, cfg: ResilienceConfig, cap: float = 8.0):
        self.rate = cfg.retry_budget
        self.cap = cap
        self._lock = threading.Lock()
        self._tokens = 0.0

    def on_request(self):
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.rate)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            return True

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


# ---------------------------------------------------------------------------
# hedged call (testbed live path)
# ---------------------------------------------------------------------------

def hedged_call(primary: Callable[[threading.Event], object],
                backup: Optional[Callable[[threading.Event], object]],
                delay_s: float,
                timeout_s: float = 10.0) -> Tuple[object, Optional[str]]:
    """First-success-wins hedge between two attempts.

    ``primary`` starts immediately; ``backup`` starts after ``delay_s``
    — or as soon as the primary *fails* (returns None / raises), since
    waiting out the hedge delay against a known-dead primary is wasted
    time. Each callable receives a cancel `threading.Event`; when the
    other side wins, the loser's event is set (cooperative
    cancellation) and its eventual result is discarded.

    Returns ``(value, winner)`` with winner in {"primary", "backup"},
    or ``(None, None)`` when both fail (or the timeout expires).
    """
    settled = threading.Event()
    state = {"failed": 0}
    state_lock = threading.Lock()
    cancels = {"primary": threading.Event(), "backup": threading.Event()}
    n_arms = 1 if backup is None else 2

    def arm(name, fn):
        try:
            out = fn(cancels[name])
        except Exception:                  # noqa: BLE001
            out = None
        with state_lock:
            if out is not None and "winner" not in state:
                state["winner"] = name
                state["value"] = out
                for other, ev in cancels.items():
                    if other != name:
                        ev.set()
                settled.set()
            elif out is None:
                state["failed"] += 1
                if state["failed"] >= n_arms:
                    settled.set()

    t_primary = threading.Thread(target=arm, args=("primary", primary),
                                 daemon=True)
    t_primary.start()
    if backup is not None:
        # wake early on primary success OR failure; fall through to the
        # hedge on the delay either way
        deadline = time.monotonic() + max(0.0, delay_s)
        while not settled.is_set() and time.monotonic() < deadline:
            if not t_primary.is_alive():
                break
            settled.wait(min(0.005, max(0.0,
                                        deadline - time.monotonic())))
        with state_lock:
            won = "winner" in state
        if not won:
            threading.Thread(target=arm, args=("backup", backup),
                             daemon=True).start()
    settled.wait(timeout_s)
    with state_lock:
        return state.get("value"), state.get("winner")


# ---------------------------------------------------------------------------
# vectorized outcome shaping (simulator path)
# ---------------------------------------------------------------------------

def admit_mask(p: np.ndarray) -> np.ndarray:
    """Deterministic token-bucket thinning: keep request i iff the
    cumulative admission credit crosses an integer at i. Admits a
    ``mean(p)`` fraction with maximal spacing — no RNG draws."""
    c = np.cumsum(p)
    return np.floor(c) > np.floor(c - p)


def shape_app_log(log: AppLog, rates: np.ndarray, *,
                  times: np.ndarray, states: np.ndarray,
                  accs: np.ndarray, svcs: np.ndarray,
                  windows: Sequence[DowntimeWindow],
                  drains: Sequence[Tuple[float, float]],
                  full_accuracy: float, slo: float,
                  util_k: float, util_cap: float,
                  rcfg: ResilienceConfig) -> AppLog:
    """Apply the resilience policies to one app's classified arrays.

    A pure, vectorized function of the recorded serving timeline, the
    downtime windows (with their warm-backup annotations), and the
    recovery-drain intervals — deterministic, no RNG:

      * dropped arrivals inside a window whose ``backup`` is known
        become **hedged** wins: served by the backup variant after the
        hedge delay (first-success-wins against a dead primary);
      * in windows with no backup, failures beyond the breaker's trip
        threshold become **fast-failed** (the open breaker answers
        immediately instead of queueing on the dead primary);
      * the last ``retry_budget`` fraction of a recovered window's
        failures are **retried** successfully once the route is
        restored (latency honestly spans the remaining outage);
      * while a recovery drain is active, served load whose offered
        utilization exceeds ``admit_util`` is thinned: rejected
        requests are **shed**, admitted ones see queueing latency
        capped at the admission ceiling.
    """
    n = log.arrivals.size
    hedged = np.zeros(n, bool)
    fast_failed = np.zeros(n, bool)
    shed = np.zeros(n, bool)
    retried = np.zeros(n, bool)
    if n == 0:
        return AppLog(log.app_id, log.arrivals, log.served, log.dropped,
                      log.offered, log.degraded, log.slo_violated,
                      log.accuracy, log.latency, hedged=hedged,
                      fast_failed=fast_failed, shed=shed, retried=retried)

    arrivals = log.arrivals
    served = log.served.copy()
    dropped = log.dropped.copy()
    degraded = log.degraded.copy()
    slo_v = log.slo_violated.copy()
    accuracy = log.accuracy.copy()
    latency = log.latency.copy()
    # per-request service time from the timeline (what classify_app saw)
    tl_idx = np.clip(np.searchsorted(times, arrivals, side="right") - 1,
                     0, len(times) - 1)
    svc_req = svcs[tl_idx]

    for w in windows:
        if w.app_id != log.app_id:
            continue
        lo = np.searchsorted(arrivals, w.t_start, side="left")
        hi = (np.searchsorted(arrivals, w.t_end, side="left")
              if w.recovered else n)
        idx = lo + np.nonzero(dropped[lo:hi])[0]
        if idx.size == 0:
            continue
        if w.backup is not None:
            # hedge: the warm backup answers after the hedge delay
            b_acc, b_svc = w.backup
            delay = max(rcfg.hedge_min_delay_s,
                        rcfg.hedge_delay_factor * b_svc)
            util_b = np.clip(rates[idx] * b_svc * util_k, 0.0, util_cap)
            lat = delay + b_svc / (1.0 - util_b)
            served[idx] = True
            dropped[idx] = False
            hedged[idx] = True
            accuracy[idx] = b_acc
            latency[idx] = lat
            degraded[idx] = b_acc < full_accuracy - 1e-12
            slo_v[idx] = lat > slo
            continue
        # no backup: retry the budgeted tail once the route restores...
        n_retry = 0
        if w.recovered:
            j = int(np.searchsorted(times, w.t_end, side="right")) - 1
            if 0 <= j < len(times) and states[j] == UP:
                n_retry = int(rcfg.retry_budget * idx.size)
            if n_retry:
                rid = idx[-n_retry:]
                lat_r = (w.t_end + rcfg.retry_backoff_s) - arrivals[rid]
                served[rid] = True
                dropped[rid] = False
                retried[rid] = True
                accuracy[rid] = accs[j]
                latency[rid] = lat_r
                degraded[rid] = accs[j] < full_accuracy - 1e-12
                slo_v[rid] = lat_r > slo
        # ...and fail the rest fast once the breaker trips
        rest = idx[:idx.size - n_retry]
        if rest.size > rcfg.breaker_min_failures:
            ff = rest[rcfg.breaker_min_failures:]
            dropped[ff] = False
            fast_failed[ff] = True

    # admission control while a recovery drain is active
    for t0, t1 in drains:
        lo = np.searchsorted(arrivals, t0, side="left")
        hi = np.searchsorted(arrivals, t1, side="left")
        if hi <= lo:
            continue
        raw = rates[lo:hi] * svc_req[lo:hi] * util_k
        over = (served[lo:hi] & ~hedged[lo:hi] & ~retried[lo:hi]
                & (raw > rcfg.admit_util))
        oidx = lo + np.nonzero(over)[0]
        if oidx.size == 0:
            continue
        raw_o = raw[oidx - lo]
        keep = admit_mask(rcfg.admit_util / raw_o)
        rej = oidx[~keep]
        adm = oidx[keep]
        if rej.size:
            served[rej] = False
            shed[rej] = True
            degraded[rej] = False
            slo_v[rej] = False
            accuracy[rej] = math.nan
            latency[rej] = math.nan
        if adm.size:
            # thinned to the ceiling: queueing factor re-priced from
            # the original utilization down to admit_util
            util_o = np.clip(raw_o[keep], 0.0, util_cap)
            latency[adm] *= (1.0 - util_o) / (1.0 - rcfg.admit_util)
            slo_v[adm] = latency[adm] > slo

    return AppLog(log.app_id, arrivals, served, dropped, log.offered,
                  degraded, slo_v, accuracy, latency, hedged=hedged,
                  fast_failed=fast_failed, shed=shed, retried=retried)
