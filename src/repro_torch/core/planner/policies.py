"""Registered placement policies of the port.

    greedy         vectorized Algorithm 1 (the paper's heuristic), on
                   device tensors (backend="torch", the default) or on
                   the numpy backend
    legacy-greedy  the original loop implementation (oracle/baseline)
    ilp            exact B&B over Eq. 1-7 (proactive-only: realtime=False)
    load-aware     worst-fit ranked by rate-weighted compute headroom
    locality       worst-fit with checkpoint-locality tie-breaking
                   (model-state plane: prefer servers that can fetch
                   the failover variant fastest — local ≫ peer ≫ cloud)
    sharded        site-sharded worst-fit selection (planner/sharded.py):
                   bit-identical to greedy, on device tensors by default

legacy-greedy, ilp, load-aware and locality are numpy planners, as in
the JAX package: their custom rank and tie-break hooks exist only on
numpy `plan_greedy` (the JAX package's device backend refuses them
too), so they take no backend.

Select by name: `get_planner("greedy")`, or through the controller /
simulator via `FailLiteController(planner="load-aware")` /
`SimConfig(planner="load-aware")`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.cluster import RESOURCES
from repro_torch.core.planner.base import (PlanRequest, PlanResult, Planner,
                                           register_planner)
from repro_torch.core.planner.ilp import solve_warm_placement
from repro_torch.core.planner.kernels import resolve_backend
from repro_torch.core.planner.legacy import faillite_heuristic_legacy
from repro_torch.core.planner.torch_backend import (TorchPlanContext,
                                                    plan_greedy_torch)
from repro_torch.core.planner.vectorized import plan_greedy
from repro_torch.device import DeviceLike


@register_planner("greedy")
class GreedyPlanner(Planner):
    """Algorithm 1, vectorized — the MTTR-critical default.

    ``backend="torch"`` (the default) routes rounds through the device
    functions of planner/torch_backend.py, whose worst-fit reduction is
    the K5 kernel on the card: bit-identical assignments and objective.
    ``device`` is where it runs: ``cuda`` unless the caller asks for
    ``cpu`` (raises when there is no card). ``backend="numpy"`` is the
    parity oracle on the host; it ignores ``device``. A request carrying
    a `latency_fn` plans on either backend: on torch, its (variant,
    server) mask gates the round kernel's placements and upgrades.
    """

    realtime = True

    def __init__(self, backend: str = "torch", device: DeviceLike = None):
        self.backend = resolve_backend(backend)
        self.stats = {"backend": self.backend, "torch_rounds": 0,
                      "numpy_rounds": 0}
        self._ctx = (TorchPlanContext(device) if self.backend == "torch"
                     else None)

    def plan(self, req: PlanRequest) -> PlanResult:
        exclude, site_exclude = req.exclusions()
        if self.backend == "torch":
            self.stats["torch_rounds"] += 1
            return plan_greedy_torch(req.apps, req.cluster,
                                     state=req.state, exclude=exclude,
                                     site_exclude=site_exclude,
                                     alpha=req.alpha,
                                     latency_fn=req.latency_fn,
                                     ctx=self._ctx)
        self.stats["numpy_rounds"] += 1
        return plan_greedy(req.apps, req.cluster, state=req.state,
                           exclude=exclude, site_exclude=site_exclude,
                           alpha=req.alpha, latency_fn=req.latency_fn)


@register_planner("legacy-greedy")
class LegacyGreedyPlanner(Planner):
    """Algorithm 1, original pure-Python loops (parity oracle); a host
    planner by definition, with no device path."""

    realtime = True

    def plan(self, req: PlanRequest) -> PlanResult:
        exclude, site_exclude = req.exclusions()
        return faillite_heuristic_legacy(
            req.apps, req.cluster, exclude=exclude,
            site_exclude=site_exclude, alpha=req.alpha,
            latency_fn=req.latency_fn)


@register_planner("ilp")
class IlpPlanner(Planner):
    """Eq. 1-7 exact B&B; proactive planning only (the controller uses a
    realtime planner on the failover hot path, as the paper does). A
    numpy planner (scipy's HiGHS LP relaxation), as in the JAX package;
    its incumbent is numpy `plan_greedy`."""

    realtime = False

    def __init__(self, node_limit: int = 500, time_limit_s: float = 10.0):
        self.node_limit = node_limit
        self.time_limit_s = time_limit_s

    def plan(self, req: PlanRequest) -> PlanResult:
        return solve_warm_placement(
            req.apps, req.cluster, req.primaries, alpha=req.alpha,
            site_independence=req.site_independence,
            latency_fn=req.latency_fn, state=req.state,
            node_limit=self.node_limit, time_limit_s=self.time_limit_s)


@register_planner("load-aware")
class LoadAwarePlanner(Planner):
    """Worst-fit ranked by *projected* headroom under traffic load.

    The paper's rule ranks servers by current normalized free fraction;
    this policy instead ranks by the headroom REMAINING after placement,
    with the candidate's compute demand amplified by the app's request
    rate (`core/traffic.py` rates, optionally modulated by the diurnal
    profile at plan time) — so high-traffic apps land on compute-rich
    servers and low-traffic apps soak up memory-rich ones. Feasibility
    (Eq. 2/3/4/6) is unchanged; only the ranking differs. A numpy
    planner, as in the JAX package: the custom rank (`score_fn`) exists
    only on numpy `plan_greedy`.
    """

    realtime = True

    def __init__(self, diurnal: bool = False):
        self.diurnal = diurnal

    def plan(self, req: PlanRequest) -> PlanResult:
        # lazy import: traffic -> controller -> planner would otherwise
        # cycle at module-import time
        from repro_torch.core.traffic import diurnal_factor
        mod = diurnal_factor(req.now) if self.diurnal else 1.0
        ci = RESOURCES.index("compute")

        def score(free, cap, d, app):
            eff = d.copy()
            eff[ci] *= 1.0 + mod * max(app.request_rate, 0.0)
            return ((free - eff[None, :]) / cap).min(axis=1)

        exclude, site_exclude = req.exclusions()
        return plan_greedy(req.apps, req.cluster, state=req.state,
                           exclude=exclude, site_exclude=site_exclude,
                           alpha=req.alpha, latency_fn=req.latency_fn,
                           score_fn=score)


@register_planner("locality")
class LocalityPlanner(Planner):
    """Worst-fit with checkpoint-locality tie-breaking (model-state
    plane, `core/modelstate.py`).

    Algorithm 1's worst-fit ranks servers by normalized free fraction;
    under a constrained storage topology that rule happily places a
    failover onto a server that must stream the checkpoint over the
    shared cloud uplink while an equally-roomy server holds the bytes
    on local disk. This policy quantizes the headroom rank into bands
    of `band` (so "equally roomy" means within one band, not bit-equal
    floats) and, inside a band, prefers the server with the SMALLEST
    uncontended fetch time for the candidate variant — local hit ≫
    same-site peer ≫ cloud. Feasibility (Eq. 2/3/4/6) is unchanged.

    Needs a `ModelRegistry` attached to the planner state
    (`PlannerState.attach_registry`); without one it degrades to plain
    vectorized Algorithm 1 (numpy). A numpy planner, as in the JAX
    package: the tie-break hook (`tiebreak_fn`) exists only on numpy
    `plan_greedy`.
    """

    realtime = True

    def __init__(self, band: float = 0.05):
        self.band = band

    def plan(self, req: PlanRequest) -> PlanResult:
        exclude, site_exclude = req.exclusions()
        registry = getattr(req.state, "registry", None) \
            if req.state is not None else None
        if registry is None:
            return plan_greedy(req.apps, req.cluster, state=req.state,
                               exclude=exclude, site_exclude=site_exclude,
                               alpha=req.alpha, latency_fn=req.latency_fn)
        band = self.band

        def score(free, cap, d, app):
            return np.floor((free / cap).min(axis=1) / band)

        def tiebreak(app, variant, server_ids):
            return [registry.fetch_seconds(variant, sid)
                    for sid in server_ids]

        return plan_greedy(req.apps, req.cluster, state=req.state,
                           exclude=exclude, site_exclude=site_exclude,
                           alpha=req.alpha, latency_fn=req.latency_fn,
                           score_fn=score, tiebreak_fn=tiebreak)


__all__ = ["GreedyPlanner", "LegacyGreedyPlanner", "IlpPlanner",
           "LoadAwarePlanner", "LocalityPlanner"]
