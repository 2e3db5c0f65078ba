"""Run one cell of the port's benchmark on this machine's card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as its last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; then ``checks``, each number
compared beside its limit, which also close standard error. Exits non-zero
without a result when there is no CUDA card, fewer cards than the cell
asks for, or when JAX or the JAX package was loaded.

``--control 1`` runs the check's control: at every position of the sampled
requests, the token that the plain reference computed with fp8 linear
layers puts first stands in place of the program's, and the same checks
decide ``correct``, which has to come out false. The benchmark's own runs
leave it at 0. Each sampled request's gaps, the program's and the
control's, go to standard error as ``sample`` lines.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden():
    """Top-level names of loaded modules that belong to JAX or the JAX
    package (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "nv_compute"))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda",
                           t_start=T_START, control=bool(args.control))
    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    out.pop("_run")
    for row in out.pop("_sample"):
        print("sample " + json.dumps(row), file=sys.stderr)
    for err in out.pop("_errors"):
        print("program error: " + err, file=sys.stderr)
    checks = out["checks"]
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
