"""A copy of the benchmark's tree at CPU sizes, for the tests.

``smoke_tree`` copies ``bench/`` and ``BENCHMARK.json`` into a directory
and rewrites each configuration to the port's SMOKE sizes of its model
(fp32, four layers) and each mix to prompts of 8-48 tokens, so that a whole
run of a cell, the reference included, takes seconds on the CPU.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SMOKE = {
    "qwen2.5-3b": dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                       head_dim=16, d_ff=128, vocab_size=503),
    "rwkv6-3b": dict(num_layers=4, d_model=64, d_ff=128, vocab_size=503,
                     rwkv_head_size=16),
}


def smoke_tree(dest: Path, rate_rps: float = 6.0,
               dtype: str = "float32") -> Path:
    """``dest/bench`` and ``dest/BENCHMARK.json``, the models served in
    ``dtype``; returns ``dest/bench``."""
    bench = dest / "bench"
    shutil.copytree(REPO / "bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (bench / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["model"].update(SMOKE[c["name"]], param_dtype=dtype,
                          activation_dtype=dtype)
        path.write_text(json.dumps(c))
    for path in (bench / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(rate_rps=rate_rps, max_len=64, warmup_prompts=[48, 8],
                 check_positions=400)
        t["prompt"].update(min=8, max=48)
        path.write_text(json.dumps(t))
    return bench
