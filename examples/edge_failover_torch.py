"""End-to-end serving driver on the PyTorch port: REAL failure injection
on the mini-testbed (examples/edge_failover.py through
``repro_torch.experiment``).

Worker threads host the port's inference engines (reduced configs of the
assigned architectures) on the CUDA card, or on the CPU with ``--device
cpu``, behind the FailLite controller. Clients issue batched requests;
one server is crashed mid-flight; the heartbeat detector fires, the
two-step failover re-homes the affected app, and client-observed
downtime is reported next to the controller's MTTR accounting — all
through the same `ExperimentSpec` API the simulator uses (`--backend
sim` runs the identical experiment there).

    PYTHONPATH=src python examples/edge_failover_torch.py [--policy full-cold] [--device cpu]
"""

import argparse
import math


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="faillite",
                    choices=["faillite", "full-warm", "full-cold",
                             "full-warm-k"])
    ap.add_argument("--backend", default="testbed",
                    choices=["sim", "testbed"])
    ap.add_argument("--settle", type=float, default=20.0)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the engines and the planner run (default: "
                         "the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.experiment import (ExperimentSpec,
                                        primary_kill_scenario,
                                        run_experiment)
    spec = ExperimentSpec(
        backend=args.backend, policy=args.policy, app_mix="arch",
        archs=["qwen2.5-3b", "rwkv6-3b", "recurrentgemma-2b"],
        n_sites=3, servers_per_site=2, headroom=0.3, seed=1,
        client_hz=10.0, time_scale=0.25, settle_s=args.settle,
        scenario="primary-kill",
        scenario_builder=primary_kill_scenario(), device=args.device)
    if args.backend == "testbed":
        print(f"deploying mini-testbed (policy={args.policy}) — real "
              f"model loads on {args.device or 'cuda'}...")
    res = run_experiment(spec)

    if math.isfinite(res.detect_latency_s):
        print(f"\ndetected in {res.detect_latency_s*1e3:.0f} ms")
    s = res.overall
    print(f"recovery: {s['recovery_rate']:.0%}  "
          f"MTTR {s['mttr_avg']*1e3:.0f} ms  "
          f"accuracy cost {s['accuracy_reduction']:.2%}")
    for rec in sorted(res.records, key=lambda r: r.app_id):
        print(f"  {rec.app_id:28s} {rec.mode:17s} "
              f"{rec.mttr*1e3 if rec.recovered else float('nan'):8.0f} ms "
              f"-> {rec.upgraded_to or rec.variant}")

    print("\nclient view:")
    t = res.traffic
    print(f"  {t.n_offered} requests, availability {t.availability:.2%},"
          f" dropped {t.n_dropped}, degraded {t.n_degraded}")
    cli = (f"{t.client_mttr_avg*1e3:.0f} ms"
           if math.isfinite(t.client_mttr_avg) else "inf")
    print(f"  client-observed MTTR: {cli}   "
          f"goodput {t.goodput:.4f}")
    for app_id, st in sorted(res.extras.get("client_stats", {}).items()):
        down = f"{st.downtime*1e3:.0f} ms" if st.downtime else "none"
        print(f"  {app_id:28s} ok={st.ok:4d} failed={st.failed:4d} "
              f"downtime={down}")


if __name__ == "__main__":
    main()
