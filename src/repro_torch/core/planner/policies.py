"""Registered placement policies of the port.

    greedy         vectorized Algorithm 1 (the paper's heuristic), on
                   device tensors (backend="torch", the default) or on
                   the numpy backend

The other policies of the JAX package (legacy-greedy, ilp, load-aware,
locality, sharded) are not ported yet; `get_planner` names the ROADMAP
item that brings each one.

Select by name: `get_planner("greedy")`, or through the controller /
simulator via `FailLiteController(planner="greedy")` /
`SimConfig(planner="greedy")`.
"""

from __future__ import annotations

from repro_torch.core.planner.base import (PlanRequest, PlanResult, Planner,
                                           register_planner)
from repro_torch.core.planner.kernels import resolve_backend
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
    a `latency_fn` (which the legacy-greedy and ilp planners set) plans
    on numpy only: the torch backend raises NotImplementedError for it.
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
            if req.latency_fn is not None:
                raise NotImplementedError(
                    "latency_fn on the torch planner backend is not "
                    "ported yet; see ROADMAP.md Queue 1, other planners")
            self.stats["torch_rounds"] += 1
            return plan_greedy_torch(req.apps, req.cluster,
                                     state=req.state, exclude=exclude,
                                     site_exclude=site_exclude,
                                     alpha=req.alpha, ctx=self._ctx)
        self.stats["numpy_rounds"] += 1
        return plan_greedy(req.apps, req.cluster, state=req.state,
                           exclude=exclude, site_exclude=site_exclude,
                           alpha=req.alpha, latency_fn=req.latency_fn)


__all__ = ["GreedyPlanner"]
