"""repro_torch.experiment — the port's experiment API (port of
``repro.experiment``).

    from repro_torch.experiment import ExperimentSpec, run_experiment

    res = run_experiment(ExperimentSpec(scenario="cascade", seed=1))
    live = run_experiment(ExperimentSpec.smoke("testbed"))

One declarative `ExperimentSpec` runs on either registered `Backend`
("sim" = deterministic discrete-event simulator, "testbed" = live
worker threads with PyTorch engines on the card) and always returns the
unified `RunResult` schema. Both run on the CUDA card unless
`ExperimentSpec(device="cpu")` asks for the CPU.
"""

from repro_torch.experiment.backends import (BACKENDS, Backend, SimBackend,
                                             TestbedBackend, get_backend,
                                             primary_kill_scenario,
                                             register_backend,
                                             resolve_scenario,
                                             run_experiment)
from repro_torch.experiment.result import RunResult
from repro_torch.experiment.spec import ExperimentSpec
from repro_torch.experiment.workload import (TESTBED_ARCHS, arch_mem_cap,
                                             build_arch_apps, testbed_ladder)

__all__ = [
    "BACKENDS", "Backend", "ExperimentSpec", "RunResult", "SimBackend",
    "TESTBED_ARCHS", "TestbedBackend", "arch_mem_cap", "build_arch_apps",
    "get_backend", "primary_kill_scenario", "register_backend",
    "resolve_scenario", "run_experiment", "testbed_ladder",
]
