"""`python -m repro_torch` — the port's experiment CLI (port of
``repro/experiment/cli.py``).

    python -m repro_torch run [--backend {sim,testbed}] [--scenario NAME]
              [--policy P] [--seed N] [--device cpu] [--smoke] [--json]
              [...cluster/traffic knobs]
    python -m repro_torch list

Both backends run on the CUDA card unless `--device cpu` is given: the
testbed's engines and the torch planner backend. Without a card and
without `--device cpu` a run raises.

`run` builds an `ExperimentSpec` from the flags and executes it on the
selected backend; `--smoke` loads the reduced CI preset for that backend
(2x2 sim cluster / 2-server 2-app testbed) before applying explicit
overrides. `list` prints the available scenarios, backends, policies,
and planners.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import List, Optional


def _build_parser() -> argparse.ArgumentParser:
    from repro_torch.core.controller import POLICIES

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="FailLite on PyTorch/CUDA — one experiment API, "
                    "two backends")
    sub = ap.add_subparsers(dest="cmd", required=True)

    from repro_torch.experiment.backends import BACKENDS

    run = sub.add_parser("run", help="run one experiment spec")
    run.add_argument("--backend", default=None,
                     choices=sorted(BACKENDS),
                     help="execution engine (default: sim)")
    run.add_argument("--scenario", default=None,
                     help="named scenario (see `python -m repro_torch list`)")
    run.add_argument("--policy", default=None, choices=POLICIES)
    run.add_argument("--planner", default=None)
    run.add_argument("--seed", type=int, default=None)
    run.add_argument("--sites", type=int, default=None, dest="n_sites")
    run.add_argument("--servers-per-site", type=int, default=None)
    run.add_argument("--headroom", type=float, default=None)
    run.add_argument("--critical-frac", type=float, default=None)
    run.add_argument("--app-mix", default=None,
                     choices=["synthetic", "arch"])
    run.add_argument("--archs", default=None,
                     help="comma-separated arch list (arch mix)")
    run.add_argument("--apps-per-arch", type=int, default=None)
    run.add_argument("--traffic-rate-scale", type=float, default=None)
    run.add_argument("--diurnal-amplitude", type=float, default=None,
                     dest="traffic_diurnal_amplitude",
                     help="sinusoidal rate modulation depth (0 = plain "
                          "Poisson)")
    run.add_argument("--diurnal-period", type=float, default=None,
                     dest="traffic_diurnal_period")
    run.add_argument("--autopilot", action="store_true", default=None,
                     help="adaptive protection from the live metrics "
                          "plane (core/autopilot.py; sim only)")
    run.add_argument("--resilience", action="store_true", default=None,
                     help="request-plane resilience toolkit with default "
                          "knobs: hedging, breakers, bulkheads, "
                          "admission (core/resilience.py, both backends)")
    run.add_argument("--event-mode", default=None, dest="event_mode",
                     choices=["epoch", "per-event"],
                     help="sim event-loop drain: vectorized epoch folds "
                          "(bit-exact default) or the historical "
                          "per-event path (docs/SCALE.md)")
    run.add_argument("--planner-dtype", default=None, dest="planner_dtype",
                     choices=["float64", "float32"],
                     help="planner array dtype; float32 halves planner "
                          "memory for planet-scale runs (not bit-exact)")
    run.add_argument("--planner-backend", default=None,
                     dest="planner_backend", choices=["torch", "numpy"],
                     help="planner compute backend: torch on the device "
                          "(default) or the numpy host oracle — "
                          "bit-identical plans")
    run.add_argument("--planner-coordinators", type=int, default=None,
                     dest="planner_coordinators", metavar="N",
                     help="sharded planner: plan with N concurrent "
                          "site-slice coordinators (numpy backend)")
    run.add_argument("--device", default=None, choices=["cuda", "cpu"],
                     help="where engines and the torch planner run "
                          "(default: the CUDA card; raises without one)")
    run.add_argument("--client-hz", type=float, default=None)
    run.add_argument("--settle", type=float, default=None,
                     dest="settle_s")
    run.add_argument("--time-scale", type=float, default=None)
    run.add_argument("--storage", default=None,
                     help="storage preset: local | edge "
                          "(model-state plane, docs/ARCHITECTURE.md)")
    run.add_argument("--scheduler", default=None,
                     choices=["fifo", "criticality"],
                     help="recovery drain-queue order")
    run.add_argument("--tp-degree", type=int, default=None,
                     dest="tp_degree",
                     help="deploy every app as a tensor-parallel group "
                          "spanning this many servers (shard plane); "
                          "1 = monoliths")
    run.add_argument("--shard-policy", default=None, dest="shard_policy",
                     choices=["auto", "degrade", "reshard", "monolith"],
                     help="shard recovery ladder on a member loss "
                          "(auto = critical->degrade, rest->reshard)")
    run.add_argument("--load-bw", type=float, default=None,
                     dest="load_bw",
                     help="disk->HBM bytes/s (Fig. 2b load model)")
    run.add_argument("--warmup-s", type=float, default=None,
                     dest="warmup_s")
    run.add_argument("--smoke", action="store_true",
                     help="reduced CI config for the chosen backend")
    run.add_argument("--json", action="store_true", dest="as_json",
                     help="emit the summary row as JSON")
    run.add_argument("--out", default=None, metavar="FILE",
                     help="dump the full RunResult as JSON to FILE "
                          "(CI trend tracking)")

    sub.add_parser("list", help="show scenarios/backends/policies/planners")
    return ap


def _spec_from_args(args) -> "ExperimentSpec":
    from repro_torch.experiment.spec import ExperimentSpec

    backend = args.backend or "sim"
    spec = (ExperimentSpec.smoke(backend) if args.smoke
            else ExperimentSpec(backend=backend))
    overrides = {}
    for attr in ("backend", "scenario", "policy", "planner", "seed",
                 "n_sites", "servers_per_site", "headroom",
                 "critical_frac", "app_mix", "apps_per_arch",
                 "traffic_rate_scale", "traffic_diurnal_amplitude",
                 "traffic_diurnal_period", "autopilot", "client_hz",
                 "settle_s", "time_scale", "storage", "scheduler",
                 "load_bw", "warmup_s", "event_mode", "planner_dtype",
                 "planner_backend", "planner_coordinators",
                 "tp_degree", "shard_policy", "device"):
        val = getattr(args, attr, None)
        if val is not None:
            overrides[attr] = val
    if args.archs is not None:
        overrides["archs"] = [a.strip() for a in args.archs.split(",")
                              if a.strip()]
        overrides.setdefault("app_mix", "arch")
    if getattr(args, "resilience", None):
        overrides["resilience"] = {"enabled": True}
    return spec.with_(**overrides)


def _print_result(res, as_json: bool):
    row = res.to_row()
    if as_json:
        print(json.dumps(row, indent=1))
        return
    print(f"\n[{res.backend}] scenario={res.scenario} "
          f"policy={res.policy} seed={res.seed}")
    o = res.overall
    mttr = (f"{o['mttr_avg']*1e3:.1f} ms"
            if math.isfinite(o.get("mttr_avg", 0.0)) else "inf")
    print(f"  control plane: {o['n']} affected over {res.n_epochs} "
          f"epoch(s), recovery {o['recovery_rate']:.1%}, "
          f"MTTR {mttr}, accuracy cost "
          f"{o['accuracy_reduction']:.2%}")
    if math.isfinite(res.detect_latency_s):
        print(f"  detection latency: {res.detect_latency_s*1e3:.0f} ms")
    t = res.traffic
    if t is not None:
        cli_mttr = (f"{t.client_mttr_avg*1e3:.1f} ms"
                    if math.isfinite(t.client_mttr_avg) else "inf")
        print(f"  request plane: {t.n_offered} offered, availability "
              f"{t.availability:.4%}, client MTTR {cli_mttr}, "
              f"goodput {t.goodput:.4f}, dropped {t.n_dropped}")
    errors = res.extras.get("load_errors", [])
    if errors:
        print(f"  {len(errors)} error(s) other than a dead server:")
        for line in errors:
            print(f"    {line}")
    print(f"  warm coverage {res.warm_coverage:.0%}, planner "
          f"{res.plan_wall_s*1e3:.1f} ms, run wall {res.wall_s:.1f} s")
    for r in sorted(res.records, key=lambda r: (r.epoch, r.app_id)):
        mt = f"{r.mttr*1e3:8.1f}" if math.isfinite(r.mttr) else "     inf"
        print(f"    e{r.epoch} {r.app_id:24s} "
              f"{'ok ' if r.recovered else 'DOWN'} {r.mode:17s} "
              f"{mt} ms -> {r.upgraded_to or r.variant}")


def _cmd_list():
    from repro_torch.core.controller import POLICIES
    from repro_torch.core.planner import available_planners
    from repro_torch.core.scenario import SCENARIOS
    from repro_torch.experiment.backends import BACKENDS

    print("backends: ", ", ".join(sorted(BACKENDS)))
    print("policies: ", ", ".join(POLICIES))
    print("planners: ", ", ".join(sorted(available_planners())))
    print("scenarios:")
    for name in sorted(SCENARIOS):
        print(f"  {name}")


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "list":
        _cmd_list()
        return 0
    from repro_torch.experiment.backends import run_experiment

    spec = _spec_from_args(args)
    res = run_experiment(spec)
    _print_result(res, args.as_json)
    if args.out:
        from pathlib import Path

        doc = {"spec": spec.to_dict(), **res.to_json_dict()}
        Path(args.out).write_text(json.dumps(doc, indent=1) + "\n")
        print(f"wrote {args.out}")
    # a testbed run whose loads, decode steps or clients raised failed
    return 1 if res.extras.get("load_errors") else 0


if __name__ == "__main__":
    sys.exit(main())
