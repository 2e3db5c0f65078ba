"""Quickstart on the PyTorch port: examples/quickstart.py's experiment
through ``repro_torch.experiment``.

One declarative `ExperimentSpec` describes the whole experiment: a
20-server / 4-site edge cluster, a mixed app workload with heterogeneous
variant ladders, and a crash of the server hosting the first app's
primary. `run_experiment` executes it on the discrete-event simulator,
whose greedy planner plans each failover round on the CUDA card (or on
the CPU with ``--device cpu``), and returns the unified `RunResult`.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

from repro_torch.experiment import (ExperimentSpec, primary_kill_scenario,
                                    run_experiment)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the planner runs (default: the CUDA card)")
    args = ap.parse_args(argv)
    spec = ExperimentSpec(n_sites=4, servers_per_site=5, headroom=0.2,
                          critical_frac=0.5, policy="faillite", seed=0,
                          scenario="primary-kill",
                          scenario_builder=primary_kill_scenario(),
                          device=args.device)
    res = run_experiment(spec)

    o = res.overall
    print(f"[{res.backend}] scenario={res.scenario} "
          f"policy={res.policy}")
    print(f"recovery rate: {o['recovery_rate']:.0%}   "
          f"mean controller MTTR: {o['mttr_avg']*1e3:.0f} ms   "
          f"accuracy cost: {o['accuracy_reduction']:.2%}")
    for rec in sorted(res.records, key=lambda r: r.app_id):
        if rec.recovered:
            extra = (f" -> upgraded to {rec.upgraded_to}"
                     if rec.upgraded_to else "")
            print(f"  {rec.app_id:8s} {rec.mode:17s} "
                  f"{rec.mttr*1e3:7.1f} ms  {rec.variant}{extra}")
        else:
            print(f"  {rec.app_id:8s} NOT RECOVERED")

    # what the CLIENTS saw (request-level traffic plane, paper §5.7)
    t = res.traffic
    if t is not None:
        print(f"\nclient view over {t.n_offered} requests:")
        print(f"  availability: {t.availability:.4%}   "
              f"dropped: {t.n_dropped}   "
              f"degraded: {t.n_degraded}   "
              f"SLO-violated: {t.n_slo_violated}")
        print(f"  client-observed MTTR: {t.client_mttr_avg*1e3:.0f} ms   "
              f"accuracy-weighted goodput: {t.goodput:.4f}")
        print(f"  latency proxy p50/p99: {t.latency_p50*1e3:.1f}/"
              f"{t.latency_p99*1e3:.1f} ms")


if __name__ == "__main__":
    main()
