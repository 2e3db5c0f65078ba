"""Geo-correlated failures at scale on the PyTorch port: 100 servers, 10
sites, kill half (examples/site_failure_sim.py through
``repro_torch.core.simulation``).

Reproduces the paper's §5.6 scenario with the site-independence
constraint and FailLite's warm-backup reclamation (beyond-paper): the
controller evicts stranded warm replicas of unaffected apps to make room
for progressive failover of the ~50% of applications that lost their
primaries. The greedy planner plans on the CUDA card (or on the CPU with
``--device cpu``).

    PYTHONPATH=src python examples/site_failure_sim_torch.py [--device cpu]
"""

import argparse

from repro_torch.core.simulation import SimConfig, Simulation


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the planner runs (default: the CUDA card)")
    args = ap.parse_args(argv)
    for policy in ("faillite", "full-cold"):
        cfg = SimConfig(n_sites=10, servers_per_site=10, headroom=0.2,
                        policy=policy, site_independence=True, seed=0,
                        planner_device=args.device)
        sim = Simulation(cfg).setup()
        sites = list(sim.cluster.sites)[:5]
        print(f"\n[{policy}] {len(sim.apps)} apps on "
              f"{len(sim.cluster.servers)} servers; "
              f"failing sites: {sites}")
        res = sim.inject_failure(sites=sites)
        print(f"  affected: {res.n_affected}  "
              f"recovered: {res.recovery_rate:.1%}  "
              f"MTTR: {res.mttr_avg*1e3:.0f} ms  "
              f"accuracy cost: {res.accuracy_reduction:.2%}")
        modes = {}
        for r in res.records.values():
            modes[r.mode] = modes.get(r.mode, 0) + 1
        print(f"  recovery modes: {modes}")


if __name__ == "__main__":
    main()
