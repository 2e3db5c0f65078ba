"""Request-level outcome metrics — the aggregation half of the traffic
plane (paper §5.7: client-observed MTTR and accuracy loss).

Every generated request is classified, vectorized with numpy, against
its application's serving timeline (recorded by `core/traffic.py` from
routing-table epoch bumps and crash instants) into one of:

  * **served** — a live replica answered; carries that replica variant's
    accuracy and a latency proxy,
  * **served-degraded** — served, but by a smaller-than-full variant
    (progressive failover in flight, or a heterogeneous warm backup),
  * **SLO-violated** — served, but the latency proxy exceeded the app's
    ``latency_slo`` (queueing blow-up under a LoadSpike, for example),
  * **dropped** — arrived inside a downtime window: the serving replica
    was dead and no re-route had reached the client yet.

The latency proxy is ``service_time / (1 - utilization)`` with lognormal
jitter — an M/M/1-shaped stand-in that responds to the variant size
(smaller variants are faster) and to the instantaneous request rate
(spikes push p99 and SLO violations), without simulating queues
per-request.

Aggregates reported per run and per failure epoch:

  * **availability** — served / offered (departed-app residue excluded),
  * **accuracy-weighted goodput** — Σ accuracy over requests served
    within SLO, / offered: one number folding drops, degradation, and
    SLO misses together (1.0 = every request answered at full quality),
  * **latency p50/p99** of the proxy over served requests,
  * **downtime windows** — per (app, failure-epoch) blackout intervals,
    with the number of requests they swallowed, and
  * **client-observed MTTR** — per window, first *served* request after
    the route was restored minus the crash instant. This is the
    request-level analogue of the paper's 175.5 ms: it upper-bounds the
    controller's own MTTR (detection + load + notify) because clients
    also pay route propagation and arrival discretization.

Determinism guarantees: classification is a pure function of the
recorded timelines, the arrival arrays, and a PCG64 jitter stream seeded
from (simulation seed, stable app index) — same seed ⇒ identical
per-request trace and identical summary, regardless of wall clock or
dict iteration order (apps are processed in sorted-id order).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# serving-timeline states (core/traffic.py appends transitions)
UP, DOWN, GONE = 0, 1, 2


@dataclass
class DowntimeWindow:
    """One client-visible blackout: [crash instant, route restored)."""
    app_id: str
    epoch: int                     # failure epoch that opened the window
    t_start: float                 # the serving replica's crash instant
    t_end: float = math.inf        # route restored (+notify); inf = never
    n_dropped: int = 0             # requests that arrived inside
    t_first_served: float = math.inf   # first served request after t_end
    # warm backup serving this app during the window, as
    # (accuracy, service_time) — set only when the resilience layer is
    # on; hedged requests inside the window are served by it
    backup: Optional[Tuple[float, float]] = None

    @property
    def recovered(self) -> bool:
        return math.isfinite(self.t_end)

    @property
    def duration(self) -> float:
        """Control-plane view: route-outage length."""
        return self.t_end - self.t_start

    @property
    def client_downtime(self) -> float:
        """Request-level view: gap until a request actually succeeded."""
        if not self.recovered:
            return math.inf
        if math.isfinite(self.t_first_served):
            return self.t_first_served - self.t_start
        return self.duration          # no arrivals after restore


@dataclass
class AppLog:
    """Classified per-request arrays for one application."""
    app_id: str
    arrivals: np.ndarray           # sorted arrival times
    served: np.ndarray             # bool
    dropped: np.ndarray            # bool (downtime)
    offered: np.ndarray            # bool (False = pre-deploy / departed)
    degraded: np.ndarray           # bool (served below full accuracy)
    slo_violated: np.ndarray       # bool (served but proxy > SLO)
    accuracy: np.ndarray           # serving accuracy (nan if not served)
    latency: np.ndarray            # latency proxy (nan if not served)
    # resilience-layer outcomes (core/resilience.py); None on the
    # historical off-path. hedged/retried are subsets of served;
    # fast_failed/shed are terminal non-served classes disjoint from
    # dropped — every offered request lands in exactly one of
    # {served&~hedged&~retried, hedged, retried, dropped, fast_failed,
    # shed} (pinned by tests/test_properties.py)
    hedged: Optional[np.ndarray] = None       # served via warm backup
    fast_failed: Optional[np.ndarray] = None  # breaker answered instantly
    shed: Optional[np.ndarray] = None         # admission/bulkhead reject
    retried: Optional[np.ndarray] = None      # served on post-restore retry


def classify_app(app_id: str, arrivals: np.ndarray, rates: np.ndarray,
                 times: np.ndarray, states: np.ndarray,
                 accs: np.ndarray, svcs: np.ndarray, *,
                 full_accuracy: float, slo: float,
                 jitter_rng: np.random.Generator,
                 jitter_sigma: float = 0.25,
                 util_k: float = 2.0, util_cap: float = 0.9) -> AppLog:
    """Vectorized request classification against one app's timeline.

    ``times/states/accs/svcs`` are the app's serving transitions;
    ``rates`` holds the logical request rate q_i in effect when each
    request was generated (so spikes raise utilization → latency).
    """
    n = arrivals.size
    idx = np.searchsorted(times, arrivals, side="right") - 1
    pre = idx < 0                          # before first deploy
    idx = np.clip(idx, 0, len(times) - 1)
    state = states[idx]
    served = (~pre) & (state == UP)
    dropped = (~pre) & (state == DOWN)
    offered = ~(pre | (state == GONE))

    accuracy = np.where(served, accs[idx], np.nan)
    svc = np.where(served, svcs[idx], np.nan)
    util = np.clip(rates * svc * util_k, 0.0, util_cap) if n else svc
    jitter = (np.exp(jitter_rng.normal(-0.5 * jitter_sigma ** 2,
                                       jitter_sigma, n))
              if n else np.empty(0))
    with np.errstate(invalid="ignore"):
        latency = svc / (1.0 - util) * jitter
        degraded = served & (accuracy < full_accuracy - 1e-12)
        slo_violated = served & (latency > slo)
    return AppLog(app_id, arrivals, served, dropped, offered,
                  degraded, slo_violated, accuracy, latency)


def classify_apps(items: List[tuple], *, jitter_sigma: float = 0.25,
                  util_k: float = 2.0,
                  util_cap: float = 0.9) -> List["AppLog"]:
    """Batched `classify_app` over many apps in one vectorized pass
    (epoch-mode summarize; see docs/SCALE.md).

    ``items`` is a list of ``(app_id, arrivals, rates, times, states,
    accs, svcs, full_accuracy, slo, jitter_rng)`` tuples — the exact
    arguments `classify_app` takes, one tuple per app.

    Bit-exact with calling `classify_app` per item:

    * the timeline interval lookup is reformulated per app as an
      integer ``np.repeat`` over ``searchsorted(arrivals, times,
      "left")`` boundaries — provably equal to
      ``searchsorted(times, arrivals, "right") - 1`` for sorted inputs
      (duplicate timeline times collapse to zero-length intervals in
      both forms), with no float offset tricks that could flip
      near-tie comparisons;
    * jitter is drawn from each app's own generator, with the same
      single ``normal(mu, sigma, n)`` call per app;
    * every remaining operation is elementwise, so grouping apps into
      one flat array changes no float result.
    """
    if not items:
        return []
    ns = np.array([it[1].size for it in items], np.int64)
    ms = np.array([it[3].size for it in items], np.int64)
    offs = np.zeros(len(items) + 1, np.int64)
    np.cumsum(ns, out=offs[1:])
    toffs = np.zeros(len(items) + 1, np.int64)
    np.cumsum(ms, out=toffs[1:])
    total = int(offs[-1])
    g_idx = np.zeros(total, np.int64)       # per-request timeline row
    pre = np.zeros(total, bool)             # before the app's first deploy
    gnorm = np.empty(total, np.float64)     # per-request jitter draws
    mu = -0.5 * jitter_sigma ** 2
    for k, it in enumerate(items):
        arrivals, times, jitter_rng = it[1], it[3], it[9]
        n = arrivals.size
        if n == 0:
            continue
        m = times.size
        lo, hi = int(offs[k]), int(offs[k + 1])
        # method calls + direct integer subtraction: same values as
        # np.searchsorted / np.diff(np.concatenate(...)) / np.clip with
        # ~3 fewer dispatch wrappers per app (hot at 100k apps)
        bb = np.empty(m + 2, np.int64)
        bb[0] = 0
        bb[1:-1] = arrivals.searchsorted(times, side="left")
        bb[-1] = n
        il = np.repeat(np.arange(-1, m), bb[1:] - bb[:-1])
        pre[lo:hi] = il < 0
        g_idx[lo:hi] = il.clip(0, m - 1) + toffs[k]
        gnorm[lo:hi] = jitter_rng.normal(mu, jitter_sigma, n)
    t_states = np.concatenate([it[4] for it in items])
    t_accs = np.concatenate([it[5] for it in items])
    t_svcs = np.concatenate([it[6] for it in items])
    rates = (np.concatenate([it[2] for it in items]) if total
             else np.empty(0, np.float64))
    state = t_states[g_idx]
    served = (~pre) & (state == UP)
    dropped = (~pre) & (state == DOWN)
    offered = ~(pre | (state == GONE))
    accuracy = np.where(served, t_accs[g_idx], np.nan)
    svc = np.where(served, t_svcs[g_idx], np.nan)
    util = np.clip(rates * svc * util_k, 0.0, util_cap)
    jitter = np.exp(gnorm)
    full_acc = np.repeat(np.array([it[7] for it in items], np.float64), ns)
    slo = np.repeat(np.array([it[8] for it in items], np.float64), ns)
    with np.errstate(invalid="ignore"):
        latency = svc / (1.0 - util) * jitter
        degraded = served & (accuracy < full_acc - 1e-12)
        slo_violated = served & (latency > slo)
    out: List[AppLog] = []
    for k, it in enumerate(items):
        lo, hi = int(offs[k]), int(offs[k + 1])
        out.append(AppLog(it[0], it[1], served[lo:hi], dropped[lo:hi],
                          offered[lo:hi], degraded[lo:hi],
                          slo_violated[lo:hi], accuracy[lo:hi],
                          latency[lo:hi]))
    return out


@dataclass
class TrafficSummary:
    """Run-level fold of every request outcome + downtime window."""
    n_offered: int = 0
    n_served: int = 0
    n_dropped: int = 0
    n_degraded: int = 0
    n_slo_violated: int = 0
    availability: float = 1.0
    goodput: float = 1.0           # accuracy-weighted, SLO-gated
    latency_p50: float = 0.0
    latency_p99: float = 0.0
    # mean client_downtime over recovered windows; inf when windows
    # exist but none recovered (permanent blackout ≠ zero downtime);
    # 0.0 only when there were no downtime windows at all
    client_mttr_avg: float = 0.0
    # Σ route-outage durations; unrecovered windows are censored at the
    # run horizon (they count as dark from crash to end of run)
    downtime_total_s: float = 0.0
    n_windows: int = 0
    n_unrecovered_windows: int = 0
    # resilience-layer outcome counters (all zero on the off-path)
    n_hedged_win: int = 0
    n_fast_failed: int = 0
    n_shed: int = 0
    n_retried: int = 0
    per_epoch: List[dict] = field(default_factory=list)
    windows: List[DowntimeWindow] = field(default_factory=list)

    def to_dict(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in (
            "n_offered", "n_served", "n_dropped", "n_degraded",
            "n_slo_violated", "availability", "goodput", "latency_p50",
            "latency_p99", "client_mttr_avg", "downtime_total_s",
            "n_windows", "n_unrecovered_windows", "n_hedged_win",
            "n_fast_failed", "n_shed", "n_retried")}

    def fingerprint(self) -> tuple:
        """Deterministic digest for same-seed replay tests."""
        def r(x):
            return -1.0 if not math.isfinite(x) else round(float(x), 9)
        base = (self.n_offered, self.n_served, self.n_dropped,
                self.n_degraded, self.n_slo_violated,
                r(self.availability), r(self.goodput),
                r(self.latency_p50), r(self.latency_p99),
                r(self.client_mttr_avg), r(self.downtime_total_s),
                self.n_windows, self.n_unrecovered_windows,
                tuple(tuple(sorted(e.items())) for e in self.per_epoch))
        res = (self.n_hedged_win, self.n_fast_failed, self.n_shed,
               self.n_retried)
        # resilience-off runs keep the historical fingerprint shape
        # bit-exact (golden pinning in tests/test_modelstate.py)
        return base if res == (0, 0, 0, 0) else base + (res,)

    def epoch_row(self, epoch: int) -> dict:
        for e in self.per_epoch:
            if e["epoch"] == epoch:
                return e
        return {"epoch": epoch, "n_windows": 0, "n_dropped": 0,
                "client_mttr_avg": 0.0, "n_unrecovered": 0}


def aggregate(logs: List[AppLog], windows: List[DowntimeWindow],
              t_end: float) -> TrafficSummary:
    """Fold per-app logs + downtime windows into one summary.

    Also back-fills each window's ``n_dropped`` and ``t_first_served``
    from the request arrays (the windows themselves only carry the
    control-plane interval).
    """
    by_app: Dict[str, AppLog] = {l.app_id: l for l in logs}
    for w in windows:
        log = by_app.get(w.app_id)
        if log is None or log.arrivals.size == 0:
            continue
        lo = np.searchsorted(log.arrivals, w.t_start, side="left")
        hi = (np.searchsorted(log.arrivals, w.t_end, side="left")
              if w.recovered else log.arrivals.size)
        w.n_dropped = int(np.count_nonzero(log.dropped[lo:hi]))
        if w.recovered:
            cand: List[float] = []
            after = np.nonzero(log.served & (log.arrivals >= w.t_end))[0]
            if after.size:
                cand.append(float(log.arrivals[after[0]]))
            # resilience wins *inside* the window (hedged to the warm
            # backup, or retried at restore) end the client-visible
            # blackout at their completion instant, not at the first
            # organic post-restore arrival
            for name in ("hedged", "retried"):
                mask = getattr(log, name)
                if mask is None:
                    continue
                in_w = np.nonzero(mask[lo:hi])[0]
                if in_w.size:
                    i = lo + in_w
                    cand.append(float(np.min(log.arrivals[i]
                                             + log.latency[i])))
            if cand:
                w.t_first_served = min(cand)

    # integer counts are order-free — concatenate once and count in C
    # instead of a 5x per-app Python genexpr sweep (hot at 100k apps)
    def _cat_count(name: str) -> int:
        arrs = [a for l in logs
                if (a := getattr(l, name)) is not None and a.size]
        return int(np.count_nonzero(np.concatenate(arrs))) if arrs else 0

    n_offered = _cat_count("offered")
    n_served = _cat_count("served")
    n_dropped = _cat_count("dropped")
    n_degraded = _cat_count("degraded")
    n_slo = _cat_count("slo_violated")
    _count = _cat_count

    n_hedged = _count("hedged")
    n_fast_failed = _count("fast_failed")
    n_shed = _count("shed")
    n_retried = _count("retried")

    good = 0.0
    lat_all: List[np.ndarray] = []
    for l in logs:
        ok = l.served & ~l.slo_violated
        if ok.any():
            # np.sum is bitwise nansum when no NaN is present (same
            # pairwise reduce), and NaN always propagates through it —
            # so sum first and fall back to the (much slower) masking
            # nansum only on an actual NaN (testbed in-flight requests)
            s = float(np.sum(l.accuracy[ok]))
            good += float(np.nansum(l.accuracy[ok])) if math.isnan(s) \
                else s
        if l.served.any():
            lat_all.append(l.latency[l.served])
    lats = np.concatenate(lat_all) if lat_all else np.empty(0)
    # the testbed leaves nan latencies on requests still in flight at
    # run end; the sim path never produces them (no-op there)
    lats = lats[np.isfinite(lats)]

    recovered = [w for w in windows if w.recovered]
    client_downs = [w.client_downtime for w in recovered]
    summary = TrafficSummary(
        n_offered=n_offered, n_served=n_served, n_dropped=n_dropped,
        n_degraded=n_degraded, n_slo_violated=n_slo,
        availability=(n_served / n_offered if n_offered else 1.0),
        goodput=(good / n_offered if n_offered else 1.0),
        latency_p50=float(np.percentile(lats, 50)) if lats.size else 0.0,
        latency_p99=float(np.percentile(lats, 99)) if lats.size else 0.0,
        client_mttr_avg=(sum(client_downs) / len(client_downs)
                         if client_downs
                         else (math.inf if windows else 0.0)),
        downtime_total_s=(sum(w.duration for w in recovered)
                          + sum(t_end - w.t_start for w in windows
                                if not w.recovered)),
        n_windows=len(windows),
        n_unrecovered_windows=sum(1 for w in windows if not w.recovered),
        n_hedged_win=n_hedged, n_fast_failed=n_fast_failed,
        n_shed=n_shed, n_retried=n_retried,
        windows=sorted(windows, key=lambda w: (w.epoch, w.t_start,
                                               w.app_id)))

    epochs = sorted({w.epoch for w in windows})
    for ep in epochs:
        ws = [w for w in windows if w.epoch == ep]
        downs = [w.client_downtime for w in ws if w.recovered]
        summary.per_epoch.append({
            "epoch": ep,
            "n_windows": len(ws),
            "n_dropped": sum(w.n_dropped for w in ws),
            "client_mttr_avg": (sum(downs) / len(downs)
                                if downs else math.inf),
            "n_unrecovered": sum(1 for w in ws if not w.recovered)})
    return summary
