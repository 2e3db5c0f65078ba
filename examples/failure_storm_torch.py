"""Failure storm on the PyTorch port: examples/failure_storm.py's
scenario runs through ``repro_torch.experiment``.

Replays a rolling outage with rejoins, then a correlated cascade under
workload churn, on the same 20-server cluster — showing per-epoch
recovery, nodes rejoining empty and being re-filled, and the continuous
re-protection loop restoring warm coverage between failure waves. Each
run is one `ExperimentSpec`, planned on the CUDA card (or on the CPU
with ``--device cpu``).

    PYTHONPATH=src python examples/failure_storm_torch.py [--device cpu]
"""

import argparse

from repro_torch.experiment import ExperimentSpec, run_experiment


def show(res):
    print(f"  epochs: {res.n_epochs}")
    for ep, s in enumerate(res.per_epoch):
        mttr = (f"{s['mttr_avg']*1e3:6.0f} ms"
                if s["mttr_avg"] != float("inf") else "   inf")
        print(f"    epoch {ep}: {s['n']:3d} affected  "
              f"recovered {s['recovery_rate']:6.1%}  MTTR {mttr}  "
              f"accuracy cost {s['accuracy_reduction']:.2%}")
    print(f"  overall: {res.overall['recovery_rate']:.1%} of "
          f"{res.overall['n']} recoveries, warm coverage at end "
          f"{res.warm_coverage:.0%}, {res.n_apps_final} apps serving")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the planner runs (default: the CUDA card)")
    args = ap.parse_args(argv)
    for name in ("rolling-with-rejoin", "cascade", "churn-under-failure"):
        spec = ExperimentSpec(scenario=name, n_sites=4,
                              servers_per_site=5, headroom=0.2,
                              critical_frac=0.5, policy="faillite",
                              seed=0, device=args.device)
        print(f"\n=== {name} ===")
        show(run_experiment(spec))


if __name__ == "__main__":
    main()
