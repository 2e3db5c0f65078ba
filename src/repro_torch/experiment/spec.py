"""ExperimentSpec — the declarative entry point of the port (a copy of
``repro/experiment/spec.py`` with two changes: the ``device`` field, and
``planner_backend`` defaulting to ``"torch"``).

One spec describes a complete resilience experiment independently of the
engine that executes it: cluster shape, application mix, the failure
scenario to replay, the protection policy and planner, the traffic
configuration, and the seed. The `backend` field selects the execution
engine — `"sim"` (discrete-event simulator, core/simulation.py) or
`"testbed"` (live worker threads with PyTorch engines on a wall clock,
serving/testbed.py) — and the SAME spec runs on either: both backends
replay the same `ScenarioEvent` stream and return the same `RunResult`
schema (see experiment/result.py).

App mixes:
  * ``synthetic`` — profile-only variant ladders sized by the paper's
    Small/Medium/Large family spread classes (simulator default; not
    servable on the testbed because the variants carry no ModelConfig);
  * ``arch`` — reduced smoke configs of real architectures
    (`serving.testbed.TESTBED_ARCHS`): servable on the testbed AND
    runnable in the simulator, which is what makes cross-backend parity
    experiments possible (same apps, same cluster sizing rule, same
    planner inputs on both engines).

Specs are plain data: `to_dict()`/`from_dict()` round-trip every
CLI-reachable field, so experiments can be stored/replayed as JSON. Two
escape hatches exist for programmatic use only (both excluded from the
dict form): `apps` pins an explicit Application list, and
`scenario_builder` supplies a custom Scenario factory where the named
library does not fit (e.g. "kill the server hosting app0's primary").
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Callable, List, Optional, Sequence

from repro_torch.core.variants import LOAD_BW, WARMUP_S

APP_MIXES = ("synthetic", "arch")


@dataclass
class ExperimentSpec:
    # what to run
    scenario: str = "single-server"     # named scenario (core/scenario.py)
    backend: str = "sim"                # "sim" | "testbed"
    policy: str = "faillite"
    planner: Optional[str] = None       # registry name; None = policy default
    alpha: float = 0.1
    site_independence: bool = False
    seed: int = 0
    # cluster shape
    n_sites: int = 4
    servers_per_site: int = 5
    server_mem: float = 16e9            # synthetic mix only (arch mix sizes
                                        # capacity from the app set)
    headroom: float = 0.2
    critical_frac: float = 0.5
    # app mix
    app_mix: str = "synthetic"
    archs: Optional[List[str]] = None   # arch mix: None = TESTBED_ARCHS
    apps_per_arch: int = 1
    # traffic plane
    traffic_rate_scale: float = 20.0    # sim: requests/s per unit rate q_i
    traffic_chunk_s: float = 0.5
    traffic_diurnal_amplitude: float = 0.0   # sim: 0 = plain Poisson
    traffic_diurnal_period: float = 240.0
    client_hz: float = 10.0             # testbed: per-app client rate
    # model-state plane (core/modelstate.py): where checkpoint bytes
    # live and what moving them costs. "local" reduces bit-exactly to
    # the historical flat load model; "edge" is the paper-faithful
    # constrained topology (peer NICs + one shared cloud uplink).
    storage: str = "local"              # storage preset name
    scheduler: str = "fifo"             # recovery drain: fifo|criticality
    # adaptive protection (core/autopilot.py): sim-only closed loop from
    # observed traffic back into the warm set / replication / drain order
    autopilot: bool = False
    # request-plane resilience toolkit (core/resilience.py): a
    # ResilienceConfig as a plain dict ({"enabled": True} turns the
    # defaults on); None = historical request plane, bit-exact
    resilience: Optional[dict] = None
    # planet-scale engine knobs (docs/SCALE.md): event-loop drain
    # strategy ("epoch" = vectorized folds, bit-exact; "per-event" =
    # historical compat/baseline) and planner array dtype ("float32"
    # halves PlannerState memory; scale runs only, not bit-exact)
    event_mode: str = "epoch"
    planner_dtype: str = "float64"
    # planner compute backend: "torch" (the default: device tensors with
    # K5's round kernel, bit-identical to numpy) or "numpy" (the host
    # oracle); planner_coordinators >= 2 runs sharded numpy rounds with
    # that many concurrent site-slice coordinators
    planner_backend: str = "torch"
    planner_coordinators: int = 0
    # where the port runs its engines and its torch planner: None = the
    # CUDA card (raises without one), "cpu" only when asked for
    device: Optional[str] = None
    # shard plane (core/shardgroup.py): tp_degree >= 2 deploys every
    # app as a tensor-parallel group of that many servers; shard_policy
    # picks the recovery ladder rung on a member loss ("auto" =
    # critical -> degrade, rest -> reshard; or force "degrade" /
    # "reshard" / "monolith"). tp_degree=1 keeps the monolith path
    # bit-exact on both backends.
    tp_degree: int = 1
    shard_policy: str = "auto"
    load_bw: float = LOAD_BW            # bytes/s disk->HBM (Fig. 2b)
    warmup_s: float = WARMUP_S          # per-instance warmup seconds
    nic_bw: Optional[float] = None      # preset overrides (None = keep)
    cloud_bw: Optional[float] = None
    replication: Optional[int] = None
    # time control
    settle_s: Optional[float] = None    # post-horizon settle; None = default
    time_scale: float = 1.0             # testbed: event-time compression
    # programmatic escape hatches (not serialized)
    apps: Optional[Sequence] = field(default=None, repr=False)
    scenario_builder: Optional[Callable] = field(default=None, repr=False)

    _SKIP = ("apps", "scenario_builder")

    def __post_init__(self):
        if self.app_mix not in APP_MIXES:
            raise ValueError(f"unknown app_mix {self.app_mix!r}; "
                             f"have {APP_MIXES}")
        if self.backend == "testbed" and self.app_mix == "synthetic" \
                and self.apps is None:
            # synthetic ladders carry no ModelConfig -> nothing to serve
            self.app_mix = "arch"

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if f.name not in self._SKIP}

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        known = {f.name for f in fields(cls)} - set(cls._SKIP)
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ExperimentSpec fields: "
                             f"{sorted(unknown)}")
        return cls(**d)

    def with_(self, **kw) -> "ExperimentSpec":
        return replace(self, **kw)

    # -- presets ------------------------------------------------------------
    @classmethod
    def smoke(cls, backend: str = "sim") -> "ExperimentSpec":
        """CI smoke preset: smallest config that still exercises a full
        deploy -> crash -> detect -> failover -> recover cycle."""
        if backend == "testbed":
            return cls(backend="testbed", scenario="single-server",
                       app_mix="arch", archs=["qwen2.5-3b", "rwkv6-3b"],
                       apps_per_arch=1, n_sites=2, servers_per_site=1,
                       headroom=0.35, client_hz=20.0, time_scale=0.25,
                       settle_s=12.0, seed=3)
        return cls(backend=backend, scenario="single-server",
                   n_sites=2, servers_per_site=2, headroom=0.3,
                   traffic_rate_scale=5.0, settle_s=10.0, seed=0)
