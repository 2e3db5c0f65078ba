"""SLO autopilot — adaptive protection from the live metrics plane.

The controller's protection knobs (which apps hold a warm backup, the
checkpoint replication factor, the recovery-drain order) are static per
run: `_warm_candidates()` reads the apps' `critical` flags and nothing
else. Real edge deployments must adapt them to what the deployment
actually observes — EdgeSight's argument (PAPERS.md): spend the minimum
headroom that meets the SLO, and move it to where the traffic is.

`AutopilotPolicy` closes that loop. Once per re-protection sweep the
controller hands it an `AutopilotView` of the live metrics plane —
per-app observed arrival rates and SLO margins from the traffic plane,
the empirical failure-hazard from the run's own epoch history, and the
diurnal phase — and gets back an `AutopilotDecisions`:

  * **warm set** — protect the top-K apps by *observed* request rate
    (EWMA-smoothed), where K never exceeds the static policy's budget
    (the number of critical apps), so autopilot headroom is equal or
    lower by construction. A hysteresis margin + per-sweep move cap
    prevent protection flip-flop on noisy rates.
  * **predictive pre-warming** — in a diurnal trough with no recent
    failures the budget shrinks to `calm_frac`; as the modeled peak
    approaches (`lead_s` ahead) the budget snaps back and the normal
    re-protection sweep pre-warms the set *before* the rates climb.
  * **replication retune** — recent failure epochs raise the
    checkpoint replication target above the storage preset's base (the
    PR 5 `executor.replicate()` path then fans copies out), so the
    next failure finds a nearby copy instead of paying the uplink.
  * **drain boosts** — per-app priority boosts handed to the
    `RecoveryScheduler` so criticality-mode drains follow observed
    rates, not the static configured ones.

Everything is pure data-in/data-out and deterministic (sorted
iteration, no wall clock, no RNG): the same view stream yields the
same decisions, preserving the simulator's same-seed reproducibility.
The default off-path (no `AutopilotPolicy` attached) is untouched —
the six named-scenario golden fingerprints stay bit-exact.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from repro_torch.core.traffic import diurnal_factor
from repro_torch.core.variants import Application


@dataclass(frozen=True)
class AutopilotConfig:
    """Knobs of the adaptive-protection loop."""
    rate_ewma: float = 0.4        # weight of the newest rate observation
    swap_margin: float = 1.15     # challenger must beat incumbent by 15%
    max_moves: int = 2            # protection swaps per sweep (anti-thrash)
    lookback_s: float = 30.0      # failure-hazard estimation window
    hazard_hi: int = 3            # epochs in window -> max replication bump
    lead_s: float = 10.0          # predictive pre-warm lead before a peak
    calm_frac: float = 0.5        # warm-budget fraction in a calm trough
    trough_eps: float = 0.05      # diurnal factor below 1-eps = trough
    # diurnal model shared with the traffic plane (0 amplitude = none)
    diurnal_amplitude: float = 0.0
    diurnal_period: float = 240.0


@dataclass(frozen=True)
class AppSignal:
    """One app's slice of the live metrics plane at sweep time."""
    rate: float                   # observed logical request rate q_i
    slo_margin: float = math.inf  # SLO minus modeled latency (s)
    down: bool = False            # currently awaiting recovery
    recent_downtime_s: float = 0.0


@dataclass(frozen=True)
class AutopilotView:
    """What the controller shows the policy each sweep."""
    now: float
    apps: Dict[str, Application]
    warm_ids: Set[str]            # apps currently holding a warm backup
    signals: Dict[str, AppSignal]
    fail_times: List[float]       # t_fail of every epoch so far
    base_replication: int = 2
    unrecovered: Set[str] = field(default_factory=set)


@dataclass
class AutopilotDecisions:
    """One sweep's protection decisions."""
    protected: List[str]          # the full warm-eligible set, ranked
    promote: List[str]            # newly protected this sweep
    demote: List[str]             # lost protection this sweep
    replication: Optional[int]    # checkpoint residency target (or None)
    boosts: Dict[str, float]      # recovery-drain priority boosts
    budget: int                   # warm slots this sweep (<= static K)
    hazard: int                   # failure epochs inside the lookback


class AutopilotPolicy:
    """Stateful decision engine; one instance per controller."""

    def __init__(self, cfg: Optional[AutopilotConfig] = None):
        self.cfg = cfg or AutopilotConfig()
        # None until the first decide(): the controller's static
        # criticality rule applies at setup time, so deploy-time warm
        # planning is identical with and without the autopilot
        self.protected: Optional[Set[str]] = None
        self.last: Optional[AutopilotDecisions] = None
        self._rate: Dict[str, float] = {}
        self._base_repl: Optional[int] = None

    # -- diurnal model ------------------------------------------------------
    def _factor(self, t: float) -> float:
        cfg = self.cfg
        if cfg.diurnal_amplitude <= 0.0:
            return 1.0
        return diurnal_factor(t, period=cfg.diurnal_period,
                              amplitude=cfg.diurnal_amplitude)

    def in_trough(self, now: float) -> bool:
        """Below-average traffic now AND `lead_s` ahead — i.e. the next
        peak is not imminent, so shrinking the warm budget is safe and
        the restore path has time to pre-warm before rates climb."""
        cfg = self.cfg
        if cfg.diurnal_amplitude <= 0.0:
            return False
        lo = 1.0 - cfg.trough_eps
        return (self._factor(now) < lo
                and self._factor(now + cfg.lead_s) < lo)

    # -- main loop ----------------------------------------------------------
    def hazard(self, view: AutopilotView) -> int:
        return sum(1 for t in view.fail_times
                   if view.now - t <= self.cfg.lookback_s)

    def _observe(self, view: AutopilotView) -> Dict[str, float]:
        """EWMA-smoothed observed rates (configured rate as the prior)."""
        a = self.cfg.rate_ewma
        for aid in sorted(view.apps):
            sig = view.signals.get(aid)
            obs = sig.rate if sig is not None \
                else view.apps[aid].request_rate
            prev = self._rate.get(aid)
            self._rate[aid] = obs if prev is None \
                else (1.0 - a) * prev + a * obs
        self._rate = {aid: r for aid, r in self._rate.items()
                      if aid in view.apps}
        return dict(self._rate)

    def decide(self, view: AutopilotView) -> AutopilotDecisions:
        cfg = self.cfg
        score = self._observe(view)
        n_hazard = self.hazard(view)

        # warm budget: the static policy's slot count, shrunk in a calm
        # diurnal trough (predictive pre-warm = the budget snapping back
        # lead_s before the peak, refilled by the re-protection sweep)
        k_static = sum(1 for a in view.apps.values() if a.critical)
        budget = k_static
        if n_hazard == 0 and self.in_trough(view.now):
            budget = int(math.ceil(k_static * cfg.calm_frac))

        incumbents = (set(self.protected) if self.protected is not None
                      else {aid for aid, a in view.apps.items()
                            if a.critical}) & set(view.apps)
        ranked = sorted(view.apps, key=lambda aid: (-score[aid], aid))
        inc = [aid for aid in ranked if aid in incumbents]
        new = [aid for aid in ranked if aid not in incumbents]

        # merge: incumbents keep their slot unless a challenger beats
        # them by the hysteresis margin, at most max_moves swaps/sweep
        sel: List[str] = []
        moves = i = j = 0
        while len(sel) < budget and (i < len(inc) or j < len(new)):
            challenger_wins = (
                j < len(new) and moves < cfg.max_moves
                and (i >= len(inc)
                     or score[new[j]] > score[inc[i]] * cfg.swap_margin))
            if challenger_wins:
                sel.append(new[j])
                j += 1
                moves += 1
            elif i < len(inc):
                sel.append(inc[i])
                i += 1
            else:
                break            # move cap hit and no incumbents left
        prot = set(sel)

        # replication retune: hazard in the lookback raises the
        # checkpoint residency target above the preset's base
        if self._base_repl is None:
            self._base_repl = view.base_replication
        bump = 0 if n_hazard == 0 else (1 if n_hazard < cfg.hazard_hi
                                        else 2)
        replication = self._base_repl + bump

        dec = AutopilotDecisions(
            protected=[aid for aid in ranked if aid in prot],
            promote=sorted(prot - incumbents),
            demote=sorted(incumbents - prot),
            replication=replication,
            boosts=score,
            budget=budget,
            hazard=n_hazard)
        self.protected = prot
        self.last = dec
        return dec
