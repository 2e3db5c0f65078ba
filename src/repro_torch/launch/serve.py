"""End-to-end serving entry point (port of ``repro/launch/serve.py``):
FailLite-managed cluster on this host.

Spins up worker cells hosting PyTorch engines for the selected
architectures on the CUDA card (or the CPU with ``--device cpu``),
serves batched client traffic, injects a crash, and reports the two-step
failover — controller MTTR next to client-observed downtime. Without a
card and without ``--device cpu`` it raises. It exits 1 when a load, a
decode step or a client raised other than for a dead server (the
testbed's ``errors``), which the JAX version does not check.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve \
      [--archs qwen2.5-3b,rwkv6-3b] [--policy faillite] [--observe 30] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="qwen2.5-3b,rwkv6-3b,"
                                       "recurrentgemma-2b")
    ap.add_argument("--policy", default="faillite",
                    choices=["faillite", "full-warm", "full-cold",
                             "full-warm-k"])
    ap.add_argument("--sites", type=int, default=3)
    ap.add_argument("--servers-per-site", type=int, default=2)
    ap.add_argument("--headroom", type=float, default=0.3)
    ap.add_argument("--observe", type=float, default=30.0)
    ap.add_argument("--client-hz", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the engines and the planner run "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.serving.testbed import MiniTestbed
    archs = [a.strip() for a in args.archs.split(",") if a.strip()]
    print(f"deploying {len(archs)} applications under policy="
          f"{args.policy} on {args.sites}x{args.servers_per_site} cells "
          f"(PyTorch engines on {args.device or 'cuda'})...")
    tb = MiniTestbed(apps_per_arch=1, archs=archs, seed=args.seed,
                     headroom=args.headroom, policy=args.policy,
                     n_sites=args.sites,
                     servers_per_site=args.servers_per_site,
                     device=args.device)
    try:
        tb.deploy()
        for app in tb.apps:
            route = tb.router.lookup(app.id)
            warm = tb.controller.warm.get(app.id)
            where = "%s@%s" % (warm[0].name, warm[1]) if warm else "-"
            print(f"  {app.id:28s} primary={route[0]} warm={where}"
                  f"{' [critical]' if app.critical else ''}")

        res = tb.run_failure_experiment(observe_s=args.observe,
                                        client_hz=args.client_hz)
        print(f"\ncrashed {res['victim']}; detected in "
              f"{res['detect_latency_s']*1e3:.0f} ms")
        s = res["summary"]
        print(f"recovery {s['recovery_rate']:.0%}  "
              f"MTTR {s['mttr_avg']*1e3:.0f} ms  "
              f"accuracy cost {s['accuracy_reduction']:.2%}")
        for app_id, rec in res["records"].items():
            mttr = "%.0f ms" % (rec.mttr * 1e3) if rec.recovered else "LOST"
            print(f"  {app_id:28s} {rec.mode:17s} {mttr:>9s} "
                  f"-> {rec.variant}")
        print("client view:")
        for app_id, st in res["client_stats"].items():
            down = f"{st.downtime*1e3:.0f} ms" if st.downtime else "none"
            print(f"  {app_id:28s} ok={st.ok:4d} "
                  f"failed={st.failed:4d} downtime={down}")
    finally:
        tb.shutdown()
    if tb.errors:
        print(f"errors other than a dead server: {tb.errors}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
