"""The port's planner subsystem — array-backed placement core.

Public surface:

  * `PlannerState` / `ScratchView` — persistent S x R capacity arrays,
    incrementally synced from `Cluster` change notifications (copies);
  * `Planner` / `PlanRequest` / registry (`get_planner`,
    `register_planner`, `available_planners`) — policy selection by
    name; "greedy" is the one policy ported so far;
  * `faillite_heuristic` / `plan_greedy` (vectorized Algorithm 1, the
    numpy backend and the parity oracle) and `plan_greedy_torch` (the
    same algorithm on device tensors, K5 as its worst-fit reduction).
"""

from repro_torch.core.planner import base as _base
from repro_torch.core.planner.base import (HeuristicResult, PlanRequest,
                                           PlanResult, Planner,
                                           available_planners,
                                           eq1_objective, register_planner)
from repro_torch.core.planner.kernels import resolve_backend
from repro_torch.core.planner.policies import GreedyPlanner
from repro_torch.core.planner.state import PlannerState, ScratchView
from repro_torch.core.planner.torch_backend import (TorchPlanContext,
                                                    plan_greedy_torch)
from repro_torch.core.planner.vectorized import (faillite_heuristic,
                                                 plan_greedy)

# planners of the JAX package that the port does not have yet
_PENDING = {
    "legacy-greedy": "Queue 1, other planners",
    "ilp": "Queue 1, other planners",
    "load-aware": "Queue 1, other planners",
    "locality": "Queue 1, other planners",
    "sharded": "Queue 1, other planners",
}


def get_planner(name: str, **kwargs) -> Planner:
    """Instantiate a registered planner by name; a planner of the JAX
    package that is not ported yet raises KeyError naming its ROADMAP
    item."""
    if name in _PENDING:
        raise KeyError(f"planner {name!r} is not ported yet; see "
                       f"ROADMAP.md {_PENDING[name]}")
    return _base.get_planner(name, **kwargs)


__all__ = [
    "GreedyPlanner", "HeuristicResult", "PlanRequest", "PlanResult",
    "Planner", "PlannerState", "ScratchView", "TorchPlanContext",
    "available_planners", "eq1_objective", "faillite_heuristic",
    "get_planner", "plan_greedy", "plan_greedy_torch", "register_planner",
    "resolve_backend",
]
