"""RunResult — the unified outcome schema of both execution backends.

Whatever engine ran the spec, the caller gets the same shape back:

  * control plane: the controller's per-epoch `RecoveryRecord`s plus the
    per-epoch / overall summaries (`recovery_rate`, `mttr_avg`,
    `accuracy_reduction`, `n`) and end-of-run warm coverage;
  * request plane: one `core.metrics.TrafficSummary` — on the sim it is
    classified from the vectorized request streams, on the testbed it is
    aggregated by the SAME `core.metrics.aggregate` code from real
    request outcomes measured by live clients;
  * planner cost: cumulative planner wall time across every planning
    round of the run;
  * provenance: the spec that produced it and the run's wall-clock cost.

The sim path additionally keeps the raw `ScenarioResult` so the
deterministic `fingerprint()` (bit-identical replay digest, unchanged
from before this API existed) remains available; the testbed runs on a
wall clock and is inherently non-reproducible bit-for-bit, so
`fingerprint()` raises there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.metrics import TrafficSummary


def _json_num(x):
    """JSON-safe float: inf/nan become the repo-wide -1.0 sentinel."""
    if isinstance(x, float) and not math.isfinite(x):
        return -1.0
    return x


@dataclass
class RunResult:
    backend: str
    scenario: str
    policy: str
    seed: int
    # control plane
    n_epochs: int
    per_epoch: List[dict]
    overall: dict
    warm_coverage: float
    records: List[object]              # flat per-epoch RecoveryRecords
    unplaced_arrivals: int = 0
    n_apps_final: int = 0
    # request plane
    traffic: Optional[TrafficSummary] = None
    # planner + run cost
    plan_wall_s: float = 0.0
    wall_s: float = 0.0
    # testbed-only: heartbeat-detection latency of the first injection
    detect_latency_s: float = math.nan
    # sim-only: the raw deterministic scenario outcome
    sim_result: Optional[object] = None
    # free-form backend extras (e.g. testbed per-app client stats)
    extras: dict = field(default_factory=dict)

    def fingerprint(self) -> tuple:
        """Deterministic replay digest (sim backend only)."""
        if self.sim_result is None:
            raise ValueError(
                f"fingerprint() needs a deterministic backend; "
                f"{self.backend!r} runs on a wall clock")
        return self.sim_result.fingerprint()

    def recovery_by_app(self) -> dict:
        """app_id -> (recovered, mode, final variant) over the run's
        LATEST record per app — the cross-backend parity view: backends
        may differ in wall-clock MTTR but not in failover choices."""
        out = {}
        for r in self.records:          # flat records are in epoch order
            out[r.app_id] = (r.recovered, r.mode,
                             r.upgraded_to or r.variant)
        return out

    def to_row(self) -> dict:
        """Flat CSV-friendly summary row (same keys on every backend)."""
        t = self.traffic
        return {
            "backend": self.backend,
            "scenario": self.scenario,
            "policy": self.policy,
            "seed": self.seed,
            "n_epochs": self.n_epochs,
            "n": self.overall.get("n", 0),
            "recovery_rate": self.overall.get("recovery_rate", 1.0),
            "ctl_mttr_ms": ms_sentinel(self.overall.get("mttr_avg", 0.0)),
            "acc_red_pct": 100.0
            * self.overall.get("accuracy_reduction", 0.0),
            "warm_coverage": self.warm_coverage,
            "unplaced": self.unplaced_arrivals,
            "n_offered": t.n_offered if t else 0,
            "availability": t.availability if t else 1.0,
            "client_mttr_ms": (ms_sentinel(t.client_mttr_avg)
                               if t else 0.0),
            "goodput": t.goodput if t else 1.0,
            "plan_wall_ms": self.plan_wall_s * 1e3,
            "wall_s": self.wall_s,
        }

    def to_json_dict(self) -> dict:
        """The full result as JSON-serializable plain data — what
        ``repro run --out result.json`` writes for CI trend tracking.
        Covers the flat summary row, per-epoch summaries, every
        recovery record (with MTTR phase breakdown), and the traffic
        summary; backend extras are included when they are plain data
        (e.g. the testbed's load calibration)."""
        t = self.traffic
        doc = {
            "row": self.to_row(),
            "per_epoch": [{k: _json_num(v) for k, v in e.items()}
                          for e in self.per_epoch],
            "overall": {k: _json_num(v) for k, v in self.overall.items()},
            "records": [record_to_dict(r) for r in self.records],
            "traffic": ({k: _json_num(v) for k, v in t.to_dict().items()}
                        if t is not None else None),
            "traffic_per_epoch": ([{k: _json_num(v) for k, v in e.items()}
                                   for e in t.per_epoch]
                                  if t is not None else []),
            "detect_latency_s": _json_num(self.detect_latency_s),
        }
        cal = self.extras.get("load_calibration")
        if cal:
            doc["load_calibration"] = {k: _json_num(v)
                                       for k, v in cal.items()}
        prot = self.extras.get("protection")
        if prot:
            # warm-replica headroom actually spent (sim backend): the
            # soak trend's equal-or-lower-headroom evidence
            doc["protection"] = {k: _json_num(v)
                                 for k, v in prot.items()}
        planner = self.extras.get("planner")
        if planner:
            # planner configuration + counters (backend routing, dense
            # fallbacks) — gates the backend-parity CI trend specs
            doc["planner"] = {k: (v if isinstance(v, str)
                                  else _json_num(v))
                              for k, v in planner.items()}
        shard = self.extras.get("shard")
        if shard:
            # shard plane report (tp_degree >= 2): group states, ladder
            # actions, per-action MTTRs, testbed reshard measurements
            doc["shard"] = {k: ({kk: _json_num(vv)
                                 for kk, vv in v.items()}
                                if isinstance(v, dict) else _json_num(v))
                            for k, v in shard.items()}
        return doc


def record_to_dict(r) -> dict:
    """One RecoveryRecord as JSON-safe plain data."""
    return {
        "app_id": r.app_id, "recovered": r.recovered,
        "mttr_ms": ms_sentinel(r.mttr), "variant": r.variant,
        "accuracy": r.accuracy, "mode": r.mode,
        "upgraded_to": r.upgraded_to, "epoch": r.epoch,
        "t_fail": r.t_fail, "source": getattr(r, "source", None),
        "phases": {k: _json_num(v)
                   for k, v in getattr(r, "phases", {}).items()},
    }


def ms_sentinel(seconds: float) -> float:
    """ms with the repo-wide -1.0 sentinel for inf (nothing recovered);
    the one converter behind every CSV column that prints MTTRs."""
    return seconds * 1e3 if math.isfinite(seconds) else -1.0
