"""The port's planner subsystem — array-backed placement core.

Public surface:

  * `PlannerState` / `ScratchView` — persistent S x R capacity arrays,
    incrementally synced from `Cluster` change notifications (copies);
  * `Planner` / `PlanRequest` / registry (`get_planner`,
    `register_planner`, `available_planners`) — policy selection by
    name: "greedy", "legacy-greedy", "ilp", "load-aware", "locality",
    "sharded" (the JAX package's set);
  * `faillite_heuristic` / `plan_greedy` (vectorized Algorithm 1, the
    numpy backend and the parity oracle), `plan_greedy_torch` (the same
    algorithm on device tensors, one launch of K5's round kernel a
    round), `solve_warm_placement` (Eq. 1-7 B&B), and the legacy oracle.
"""

from repro_torch.core.planner.base import (HeuristicResult, PlanRequest,
                                           PlanResult, Planner,
                                           available_planners,
                                           eq1_objective, get_planner,
                                           register_planner)
from repro_torch.core.planner.ilp import (PlacementResult, build_constraints,
                                          enumerate_vars,
                                          solve_warm_placement)
from repro_torch.core.planner.legacy import (faillite_heuristic_legacy,
                                             match, worst_fit)
from repro_torch.core.planner.kernels import resolve_backend
from repro_torch.core.planner.state import PlannerState, ScratchView
from repro_torch.core.planner.torch_backend import (TorchPlanContext,
                                                    plan_greedy_torch)
from repro_torch.core.planner.vectorized import (faillite_heuristic,
                                                 plan_greedy)
from repro_torch.core.planner.sharded import CoordinatedSiteIndex, SiteIndex
from repro_torch.core.planner import policies as _policies  # noqa: F401  (registers planners)
from repro_torch.core.planner import sharded as _sharded  # noqa: F401  (registers "sharded")
from repro_torch.core.planner.policies import GreedyPlanner

__all__ = [
    "CoordinatedSiteIndex", "GreedyPlanner", "HeuristicResult",
    "PlacementResult", "PlanRequest", "PlanResult", "Planner",
    "PlannerState", "ScratchView", "SiteIndex", "TorchPlanContext",
    "available_planners", "build_constraints", "enumerate_vars",
    "eq1_objective", "faillite_heuristic", "faillite_heuristic_legacy",
    "get_planner", "match", "plan_greedy", "plan_greedy_torch",
    "register_planner", "resolve_backend", "solve_warm_placement",
    "worst_fit",
]
