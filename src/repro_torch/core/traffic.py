"""Vectorized request workload layer — the traffic half of the
request-level traffic plane (paper §5.7: client-observed metrics).

The paper's headline numbers (175.5 ms MTTR, 0.6 % accuracy loss) are
measured at the *request* level: what clients experienced, not what the
controller recorded. This module generates per-app request streams and
tracks, for every application, the piecewise-constant serving timeline
(which variant was serving when, and when the app was blacked out), so
`core/metrics.py` can classify millions of requests after the fact.

Design for scale ("millions of users"): arrivals are generated
**per-epoch in bulk**, not per-request. A homogeneous Poisson process on
a window [t0, t1) is sampled as one `N ~ Poisson(rate * dt)` draw plus
`N` uniform order statistics — a single numpy call instead of `N`
sequential exponentials — so requests never enter the discrete-event
heap individually. The simulator schedules one *chunk* event per
`chunk_s` of sim time; each chunk reads the apps' request rates at that
instant (so `LoadSpike` multipliers and diurnal modulation are honored)
and appends one numpy array per app.

Serving timelines come from the control plane, not from the workload:
`RoutingTable` epoch bumps (observed via its `observer`/`drop_observer`
hooks) mark when a client-visible route changed, and the simulator marks
apps down at the instant their serving primary's host crashed. The
interval between those two is exactly the window a failure blacks out.

Determinism guarantee: all draws come from one `numpy` PCG64 generator
seeded from the simulation seed, and chunk events fire in deterministic
event-queue order — same seed ⇒ byte-identical per-request trace,
which `tests/test_traffic.py` asserts.

`serving/workload.py` shares this layer: its `poisson_arrivals` is a
thin wrapper over `poisson_arrival_times` for the thread-based testbed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# the same notify constant the controller folds into its MTTR: the two
# metric planes must agree on it or client windows would close before
# (or after) the controller claims recovery
from repro_torch.core.controller import NOTIFY_OVERHEAD_S
from repro_torch.core.metrics import (AppLog, DowntimeWindow, TrafficSummary,
                                UP, DOWN, GONE, aggregate, classify_app,
                                classify_apps)
from repro_torch.core.resilience import ResilienceConfig, shape_app_log


# ---------------------------------------------------------------------------
# vectorized arrival generation (shared with serving/workload.py)
# ---------------------------------------------------------------------------

def poisson_arrival_times(rng: np.random.Generator, rate_hz: float,
                          t0: float, t1: float) -> np.ndarray:
    """Exact homogeneous Poisson process on [t0, t1), batched.

    Draws ``N ~ Poisson(rate * (t1 - t0))`` then ``N`` uniform order
    statistics — distributionally identical to summing exponential gaps,
    but one vectorized call regardless of N.
    """
    dt = t1 - t0
    if dt <= 0.0 or rate_hz <= 0.0:
        return np.empty(0, np.float64)
    n = int(rng.poisson(rate_hz * dt))
    if n == 0:
        return np.empty(0, np.float64)
    return np.sort(rng.uniform(t0, t1, n))


def diurnal_factor(t: float, *, period: float = 240.0,
                   amplitude: float = 0.5, phase: float = 0.0) -> float:
    """Sinusoidal day/night rate modulation, >= 0."""
    return max(0.0, 1.0 + amplitude
               * math.sin(2.0 * math.pi * t / period + phase))


def diurnal_arrival_times(rng: np.random.Generator, base_rate: float,
                          t0: float, t1: float, *, period: float = 240.0,
                          amplitude: float = 0.5, phase: float = 0.0,
                          bin_s: float = 1.0) -> np.ndarray:
    """Non-homogeneous Poisson arrivals via piecewise-constant bins.

    Each bin uses the diurnal rate at its midpoint; bins are generated
    with the same batched order-statistics trick as the homogeneous case.
    """
    out: List[np.ndarray] = []
    t = t0
    while t < t1:
        te = min(t + bin_s, t1)
        rate = base_rate * diurnal_factor(0.5 * (t + te), period=period,
                                          amplitude=amplitude, phase=phase)
        out.append(poisson_arrival_times(rng, rate, t, te))
        t = te
    if not out:
        return np.empty(0, np.float64)
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# traffic plane
# ---------------------------------------------------------------------------

# Registered-app count above which epoch-mode generation abandons
# per-pair RNG-stream parity for one-call bulk draws (generate_chunks).
BULK_STREAM_MIN_APPS = 4096


@dataclass(frozen=True)
class TrafficConfig:
    """Knobs of the request plane.

    ``rate_scale`` converts the paper's abstract per-app rate q_i into
    requests/s of actual traffic (sampling density); utilization and
    latency use the *logical* q_i, so scaling traffic up for tighter
    confidence intervals does not change the physics.
    """
    rate_scale: float = 20.0      # requests/s generated per unit q_i
    chunk_s: float = 0.5          # bulk-generation window (sim seconds)
    util_k: float = 2.0           # q_i * service_time -> utilization
    util_cap: float = 0.9         # clamp for the M/M/1-style factor
    jitter_sigma: float = 0.25    # lognormal service jitter
    diurnal_amplitude: float = 0.0  # 0 = plain Poisson
    diurnal_period: float = 240.0


class TrafficPlane:
    """Per-app request streams + serving timelines for one simulation.

    The simulator owns the chunk schedule and the crash hooks; the
    controller's `RoutingTable` observers feed route transitions. At the
    end of a run `summarize()` classifies every generated request
    against the recorded timelines (vectorized, in `core/metrics.py`).
    """

    def __init__(self, seed: int = 0,
                 cfg: Optional[TrafficConfig] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 batch: bool = False):
        self.cfg = cfg or TrafficConfig()
        self.resilience = resilience
        self.batch = batch
        self.rng = np.random.default_rng([0x7AFF1C, seed])
        self._jitter_seed = seed
        self.n_generated = 0            # total requests drawn (bench metric)
        # epoch mode switches from the RNG-stream-exact scalar loop to
        # bulk vectorized draws above this many registered apps (see
        # generate_chunks / docs/SCALE.md); golden + parity configs are
        # far below it
        self.bulk_min_apps = BULK_STREAM_MIN_APPS
        # epoch-mode eligibility snapshot cache: bumped by the
        # simulation on app arrival/departure/spike (generate_chunks)
        self.snapshot_gen = 0
        self._snap: Optional[tuple] = None
        # per-app chunked arrival buffers + the logical rate per chunk
        # (per-event compat mode — `batch=False`)
        self._arrivals: Dict[str, List[np.ndarray]] = {}
        self._chunk_rates: Dict[str, List[Tuple[int, float]]] = {}
        # epoch mode (`batch=True`) stores requests columnar instead:
        # one (app_row, count, rate, sorted_times) quadruple per chunk,
        # where app_row indexes the registration-ordered `_reg_ids`.
        # Per-app python-list appends are the per-event path's second
        # hot loop (after RNG draws); this layout kills them.
        self._reg_ids: List[str] = []
        self._reg_idx: Dict[str, int] = {}
        self._chunks: List[Tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]] = []
        self._last_q = np.empty(0, np.float64)   # latest rate per reg row
        self._has_q = np.empty(0, bool)
        self._ubuf = np.empty(1 << 16, np.float64)   # raw-uniform scratch
        # per-app serving timeline: (t, state, accuracy, service_time)
        self._timeline: Dict[str, List[Tuple[float, int, float, float]]] = {}
        self._full_acc: Dict[str, float] = {}
        self._slo: Dict[str, float] = {}
        self.windows: List[DowntimeWindow] = []
        self._open: Dict[str, DowntimeWindow] = {}
        # recovery-drain intervals (RecoveryScheduler.drain_observer):
        # closed [t0, t1] pairs + the currently-open drain start
        self._drains: List[Tuple[float, float]] = []
        self._drain_open: Optional[float] = None
        self._drain_depth = 0

    # -- timeline recording (control-plane hooks) ---------------------------
    def _last_t(self, app_id: str) -> float:
        tl = self._timeline.get(app_id)
        return tl[-1][0] if tl else 0.0

    def mark_up(self, app_id: str, t: float, *, accuracy: float,
                service_time: float, full_accuracy: float,
                slo: float = math.inf):
        """Route now points at a live replica serving `accuracy`.

        The first sighting registers the app (its deploy); later calls
        are failovers or progressive upgrades. Route pushes after the
        first are delayed by the client-notify overhead.
        """
        first = app_id not in self._timeline
        if first:
            self._timeline[app_id] = []
            self._arrivals[app_id] = []
            self._chunk_rates[app_id] = []
            self._full_acc[app_id] = full_accuracy
            self._slo[app_id] = slo
            self._reg_idx[app_id] = len(self._reg_ids)
            self._reg_ids.append(app_id)
        else:
            t += NOTIFY_OVERHEAD_S
        t = max(t, self._last_t(app_id))
        self._timeline[app_id].append((t, UP, accuracy, service_time))
        w = self._open.pop(app_id, None)
        if w is not None:
            w.t_end = t
            self.windows.append(w)

    def mark_down(self, app_id: str, t: float, epoch: int,
                  backup: Optional[Tuple[float, float]] = None):
        """The app's serving replica just died (crash instant, *before*
        detection): requests fail from here until the next route push.

        ``backup`` is the app's warm backup (accuracy, service_time) at
        the crash instant, when one exists and the resilience layer is
        on — hedged requests inside the window are served by it.
        """
        tl = self._timeline.get(app_id)
        if tl is None or tl[-1][1] != UP:
            return                      # unknown or already down
        t = max(t, self._last_t(app_id))
        tl.append((t, DOWN, math.nan, math.nan))
        self._open[app_id] = DowntimeWindow(app_id=app_id, epoch=epoch,
                                            t_start=t, backup=backup)

    def record_drain(self, kind: str, t: float):
        """RecoveryScheduler drain-activity hook ("start"/"end").

        Folds possibly-nested start/end pairs into flat non-overlapping
        [t0, t1] intervals; admission control thins served load inside
        them (see core/resilience.py).
        """
        if kind == "start":
            if self._drain_depth == 0:
                self._drain_open = t
            self._drain_depth += 1
        elif kind == "end":
            self._drain_depth = max(0, self._drain_depth - 1)
            if self._drain_depth == 0 and self._drain_open is not None:
                if t > self._drain_open:
                    self._drains.append((self._drain_open, t))
                self._drain_open = None

    def mark_gone(self, app_id: str, t: float):
        """App departed: requests after this instant are not offered."""
        tl = self._timeline.get(app_id)
        if tl is None or tl[-1][1] == GONE:
            return
        t = max(t, self._last_t(app_id))
        tl.append((t, GONE, math.nan, math.nan))
        w = self._open.pop(app_id, None)
        if w is not None:
            self.windows.append(w)      # never recovered (censored)

    # -- bulk generation ----------------------------------------------------
    def generate_chunk(self, apps: Iterable, t0: float, t1: float):
        """Generate [t0, t1) arrivals for every live app in one pass.

        Reads each app's *current* request_rate, so LoadSpike windows
        (which multiply the rate in place) are honored at chunk
        granularity.
        """
        cfg = self.cfg
        for app in apps:
            if app.id not in self._timeline:
                continue                # not deployed (or not routed) yet
            q = app.request_rate
            if cfg.diurnal_amplitude > 0.0:
                q *= diurnal_factor(0.5 * (t0 + t1),
                                    period=cfg.diurnal_period,
                                    amplitude=cfg.diurnal_amplitude)
            arr = poisson_arrival_times(self.rng, q * cfg.rate_scale,
                                        t0, t1)
            if arr.size:
                self._arrivals[app.id].append(arr)
                self._chunk_rates[app.id].append((arr.size, q))
                self.n_generated += arr.size

    def generate_chunks(self, apps: Iterable, spans: List[Tuple[float, float]]):
        """Epoch-mode bulk generation: fold several consecutive chunk
        windows (an event-free span between two heap events) into one
        vectorized pass. Bit-exact with calling `generate_chunk` once
        per span, proven by `tests/test_scale.py`.

        RNG-stream parity is the whole trick. The per-event path draws,
        per (chunk, app) pair, one scalar Poisson count followed
        immediately by that many uniforms — an interleaved consumption
        pattern on ONE generator that a batched poisson-array /
        uniform-array rewrite would not reproduce. The loop below keeps
        the exact per-pair draw order (scalar ``poisson``, then ``n``
        raw doubles written straight into a scratch buffer:
        ``Generator.random(out=view)`` consumes the stream identically
        to ``uniform(t0, t1, n)`` because
        ``uniform(a, b, n) == a + (b - a) * random(n)`` bitwise), and
        defers the affine [t0, t1) scaling and the per-pair sort to two
        vectorized passes per chunk — sorted values do not depend on
        which sort produced them, so one segment-keyed ``lexsort``
        replaces per-app ``np.sort`` calls.

        Rates and eligibility only change through heap events, which by
        construction never fire inside a fold, so one snapshot per call
        is safe.

        Above ``bulk_min_apps`` registered apps the per-pair scalar
        loop itself becomes the hot spot (~1 µs of mandatory Generator
        calls per (chunk, app) pair), so the plane switches to a
        bulk-stream draw: ONE vectorized ``poisson(lam_vector)`` plus
        ONE uniform block per chunk. That consumes the RNG stream in a
        different order — still the exact same Poisson-process law,
        still fully deterministic per seed, but not bitwise
        stream-compatible with the per-event drain. The control plane
        never reads the traffic plane (resilience off), so recovery
        records are unaffected either way; golden/parity configs sit
        far below the threshold and keep bit-exactness
        (docs/SCALE.md).
        """
        cfg = self.cfg
        # (rows, base) only change when an app arrives/departs/respikes
        # (simulation bumps snapshot_gen) or a new app is first routed
        # (timeline gains a key) — cache the snapshot across epochs
        key = (self.snapshot_gen, len(self._timeline))
        if self._snap is not None and self._snap[0] == key:
            rows, base = self._snap[1], self._snap[2]
        else:
            elig = [a for a in apps if a.id in self._timeline]
            rows = np.array([self._reg_idx[a.id] for a in elig], np.int64)
            base = np.array([a.request_rate for a in elig], np.float64)
            self._snap = (key, rows, base)
        if not rows.size:
            return
        m = len(self._reg_ids)
        if self._last_q.shape[0] < m:
            grow = max(m, 2 * self._last_q.shape[0])
            nq = np.zeros(grow, np.float64)
            nq[:self._last_q.shape[0]] = self._last_q
            nh = np.zeros(grow, bool)
            nh[:self._has_q.shape[0]] = self._has_q
            self._last_q, self._has_q = nq, nh
        poisson = self.rng.poisson
        draw = self.rng.random
        for t0, t1 in spans:
            dt = t1 - t0
            if dt <= 0.0:
                continue                # per-app early return: no draws
            q = base
            if cfg.diurnal_amplitude > 0.0:
                q = base * diurnal_factor(0.5 * (t0 + t1),
                                          period=cfg.diurnal_period,
                                          amplitude=cfg.diurnal_amplitude)
            # same association order as the scalar path:
            # (q * rate_scale) first, then * dt
            rate_hz = q * cfg.rate_scale
            lam = rate_hz * dt
            if rows.shape[0] >= self.bulk_min_apps:
                lam = np.where(rate_hz > 0.0, lam, 0.0)
                ns_all = poisson(lam)
                sel_a = np.flatnonzero(ns_all)
                if not sel_a.size:
                    continue
                ns = ns_all[sel_a]
                total = int(ns.sum())
                times = t0 + (t1 - t0) * draw(total)
                seg = np.repeat(np.arange(sel_a.shape[0]), ns)
                times = times[np.lexsort((times, seg))]
                kk = rows[sel_a]
                qs = q[sel_a]
                self._chunks.append((kk, ns, qs, times))
                self._last_q[kk] = qs
                self._has_q[kk] = True
                self.n_generated += total
                continue
            lam_l = lam.tolist()
            rh_l = rate_hz.tolist()
            buf = self._ubuf
            cap = buf.shape[0]
            pos = 0
            sel: List[int] = []
            cnt: List[int] = []
            for i, l in enumerate(lam_l):
                if rh_l[i] <= 0.0:
                    continue            # rate<=0: no poisson draw at all
                n = int(poisson(l))
                if n == 0:
                    continue
                end = pos + n
                if end > cap:
                    cap = max(2 * cap, end)
                    nb = np.empty(cap, np.float64)
                    nb[:pos] = buf[:pos]
                    self._ubuf = buf = nb
                draw(out=buf[pos:end])
                pos = end
                sel.append(i)
                cnt.append(n)
            if not sel:
                continue
            sel_a = np.array(sel, np.int64)
            ns = np.array(cnt, np.int64)
            times = t0 + (t1 - t0) * buf[:pos]
            seg = np.repeat(np.arange(sel_a.shape[0]), ns)
            times = times[np.lexsort((times, seg))]
            kk = rows[sel_a]
            qs = q[sel_a]
            self._chunks.append((kk, ns, qs, times))
            self._last_q[kk] = qs
            self._has_q[kk] = True
            self.n_generated += pos

    # -- live introspection (autopilot feed) --------------------------------
    def current_rates(self) -> Dict[str, float]:
        """Latest observed logical rate q_i per app (the rate the most
        recent chunk was generated at, diurnal/spike modulation
        included) — the autopilot's arrival-rate signal. Apps whose
        last chunk drew zero arrivals keep their previous observation."""
        if self.batch:
            # _reg_ids is registration order == _chunk_rates insertion
            # order, so the dict iterates identically to the dict path
            return {self._reg_ids[i]: float(self._last_q[i])
                    for i in np.flatnonzero(self._has_q[:len(self._reg_ids)])}
        return {app_id: chunks[-1][1]
                for app_id, chunks in self._chunk_rates.items() if chunks}

    def downtime_since(self, t0: float, now: float) -> Dict[str, float]:
        """Per-app client-observed downtime seconds overlapping
        [t0, now] — closed windows clipped to the horizon plus any
        still-open blackout."""
        out: Dict[str, float] = {}
        for w in self.windows:
            end = w.t_end if math.isfinite(w.t_end) else now
            overlap = min(end, now) - max(w.t_start, t0)
            if overlap > 0:
                out[w.app_id] = out.get(w.app_id, 0.0) + overlap
        for app_id, w in self._open.items():
            overlap = now - max(w.t_start, t0)
            if overlap > 0:
                out[app_id] = out.get(app_id, 0.0) + overlap
        return out

    # -- aggregation --------------------------------------------------------
    def _assemble_columnar(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Epoch-mode request store -> (reg-row, arrival, rate) triples
        sorted stably by reg-row: one concatenation plus one stable
        argsort instead of per-app list-of-chunks bookkeeping. Stability
        preserves chunk order inside each app, so the per-app slices are
        bit-identical to the per-event path's concatenations."""
        if not self._chunks:
            z = np.empty(0, np.float64)
            return np.empty(0, np.int64), z, z
        seg = np.concatenate(
            [np.repeat(kk, ns) for kk, ns, _, _ in self._chunks])
        tt = np.concatenate([t for _, _, _, t in self._chunks])
        qq = np.concatenate(
            [np.repeat(qs, ns) for _, ns, qs, _ in self._chunks])
        order = np.argsort(seg, kind="stable")
        return seg[order], tt[order], qq[order]

    def _summarize_batched(self, t_end: float,
                           windows: List[DowntimeWindow]) -> TrafficSummary:
        """Epoch-mode summarize: single vectorized classification pass
        (`classify_apps`) over all apps instead of one `classify_app`
        call per app. Per-app jitter generators and iteration order are
        identical to the per-event path, so outcomes are bit-exact."""
        seg, tt, qq = self._assemble_columnar()
        bounds = np.searchsorted(seg, np.arange(len(self._reg_ids) + 1))
        items = []
        for idx, app_id in enumerate(sorted(self._timeline)):
            k = self._reg_idx[app_id]
            lo, hi = bounds[k], bounds[k + 1]
            tl = self._timeline[app_id]
            # one (m, 4) conversion instead of four per-app listcomps;
            # states round-trip float64 exactly (small ints)
            ta = np.array(tl, np.float64)
            items.append((
                app_id, tt[lo:hi], qq[lo:hi],
                ta[:, 0], ta[:, 1].astype(np.int8), ta[:, 2], ta[:, 3],
                self._full_acc[app_id], self._slo[app_id],
                np.random.default_rng([0x1A7E, self._jitter_seed, idx])))
        logs = classify_apps(items, jitter_sigma=self.cfg.jitter_sigma,
                             util_k=self.cfg.util_k,
                             util_cap=self.cfg.util_cap)
        if self.resilience is not None:
            drains = list(self._drains)
            if self._drain_open is not None and t_end > self._drain_open:
                drains.append((self._drain_open, t_end))
            logs = [shape_app_log(
                        log, it[2], times=it[3], states=it[4], accs=it[5],
                        svcs=it[6], windows=windows, drains=drains,
                        full_accuracy=it[7], slo=it[8],
                        util_k=self.cfg.util_k, util_cap=self.cfg.util_cap,
                        rcfg=self.resilience)
                    for log, it in zip(logs, items)]
        return aggregate(logs, windows, t_end)

    def summarize(self, t_end: float) -> TrafficSummary:
        """Classify every request against its app's timeline and fold
        the outcomes into a `TrafficSummary` (see core/metrics.py)."""
        logs: List[AppLog] = []
        windows = list(self.windows) + list(self._open.values())
        if self.batch:
            return self._summarize_batched(t_end, windows)
        for idx, app_id in enumerate(sorted(self._timeline)):
            chunks = self._arrivals[app_id]
            arrivals = (np.concatenate(chunks) if chunks
                        else np.empty(0, np.float64))
            rates = (np.concatenate(
                [np.full(n, q) for n, q in self._chunk_rates[app_id]])
                if chunks else np.empty(0, np.float64))
            tl = self._timeline[app_id]
            times = np.array([e[0] for e in tl])
            states = np.array([e[1] for e in tl], np.int8)
            accs = np.array([e[2] for e in tl])
            svcs = np.array([e[3] for e in tl])
            jitter_rng = np.random.default_rng(
                [0x1A7E, self._jitter_seed, idx])
            log = classify_app(
                app_id, arrivals, rates, times, states, accs, svcs,
                full_accuracy=self._full_acc[app_id],
                slo=self._slo[app_id],
                jitter_rng=jitter_rng,
                jitter_sigma=self.cfg.jitter_sigma,
                util_k=self.cfg.util_k, util_cap=self.cfg.util_cap)
            if self.resilience is not None:
                drains = list(self._drains)
                if self._drain_open is not None and t_end > self._drain_open:
                    drains.append((self._drain_open, t_end))
                log = shape_app_log(
                    log, rates, times=times, states=states, accs=accs,
                    svcs=svcs, windows=windows, drains=drains,
                    full_accuracy=self._full_acc[app_id],
                    slo=self._slo[app_id], util_k=self.cfg.util_k,
                    util_cap=self.cfg.util_cap, rcfg=self.resilience)
            logs.append(log)
        return aggregate(logs, windows, t_end)
