"""Planner subsystem primitives: result types, Eq. 1 objective, protocol
and registry.

Every placement policy in the repo — the paper's Algorithm 1 (greedy),
the warm-backup ILP (Eq. 1-7), and beyond-paper policies — implements
the same `Planner` interface and is selected by *name* through the
registry, so the controller never imports planner internals.

The shared objective is the paper's Eq. 1:

    max  Σ_{i} Σ_j Σ_k  a_ij · q_i · x_ijk

i.e. accuracy weighted by request rate. Both the heuristic and the ILP
report it, so `benchmarks/ilp_vs_heuristic.py` compares like with like.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple, TYPE_CHECKING

if TYPE_CHECKING:                                   # pragma: no cover
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.planner.state import PlannerState
    from repro_torch.core.variants import Application, Variant


def eq1_objective(assignment: Dict[str, Tuple["Variant", str]],
                  apps: List["Application"]) -> float:
    """Paper Eq. 1: Σ accuracy · request_rate over the assignment.

    Summed in assignment insertion order so that two behavior-equivalent
    planners producing the same assignment report the *bit-identical*
    float (the parity tests rely on this).
    """
    rate = {a.id: a.request_rate for a in apps}
    return sum(v.accuracy * rate[app_id]
               for app_id, (v, _) in assignment.items())


@dataclass
class HeuristicResult:
    """Outcome of a greedy-family planner run.

    `objective` is the Eq. 1 value of `assignment` (NOT the raw accuracy
    sum an earlier revision used) so heuristic and ILP results are
    directly comparable.
    """
    assignment: Dict[str, Tuple["Variant", str]]
    unplaced: List[str] = field(default_factory=list)
    wall_s: float = 0.0
    objective: float = 0.0


# alias: the registry-facing name for "whatever a planner returns";
# duck-typed — the ILP returns its own PlacementResult which also has
# .assignment / .objective / .wall_s
PlanResult = HeuristicResult


@dataclass
class PlanRequest:
    """Everything a planner may need for one placement round.

    `state` is the persistent array-backed view (see
    planner/state.py); planners fall back to building a throwaway one
    from `cluster` when it is None. `exclude`/`site_exclude` override
    the anti-affinity sets derived from `primaries` (Eq. 4 / §3.4).
    """
    apps: List["Application"]
    cluster: "Cluster"
    state: Optional["PlannerState"] = None
    primaries: Dict[str, str] = field(default_factory=dict)
    alpha: float = 0.0
    site_independence: bool = False
    latency_fn: Optional[Callable] = None
    exclude: Optional[Dict[str, Set[str]]] = None
    site_exclude: Optional[Dict[str, Set[str]]] = None
    now: float = 0.0               # sim time, for load/diurnal-aware policies

    def exclusions(self):
        """(exclude, site_exclude) honoring Eq. 4 and §3.4 defaults."""
        excl = self.exclude
        if excl is None:
            excl = {a.id: {self.primaries.get(a.id)} for a in self.apps}
        site_excl = self.site_exclude
        if site_excl is None:
            site_excl = {}
            if self.site_independence:
                for a in self.apps:
                    p = self.primaries.get(a.id)
                    site_excl[a.id] = ({self.cluster.servers[p].site}
                                       if p else set())
        return excl, site_excl


class Planner:
    """Base class every placement policy implements.

    `realtime` marks policies cheap enough for the MTTR-critical
    failover path; the controller falls back to a realtime planner for
    `handle_failures`/`reprotect` when the configured one is not
    (the paper runs the ILP proactively only, §3.3).
    """

    name: str = "?"
    realtime: bool = True

    def plan(self, req: PlanRequest) -> PlanResult:
        raise NotImplementedError


_REGISTRY: Dict[str, Callable[..., Planner]] = {}


def register_planner(name: str):
    """Class decorator: `@register_planner("greedy")`."""
    def deco(factory):
        factory.name = name
        _REGISTRY[name] = factory
        return factory
    return deco


def get_planner(name: str, **kwargs) -> Planner:
    """Instantiate a registered planner by name."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown planner {name!r}; available: "
                       f"{', '.join(sorted(_REGISTRY))}") from None
    return factory(**kwargs)


def available_planners() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
