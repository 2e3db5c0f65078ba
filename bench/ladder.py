"""The variant ladder's sizes and accuracy rule, frozen for the benchmark.

A copy of the arithmetic of the port's ``core/variants.py`` and of
``ModelConfig.param_count`` (dense attention and RWKV layers), kept here so
that the yardstick does not move when the program does:

* ``rung_dims`` gives a rung's widths and depth from the published sizes
  (``_scaled_config``), which the plain reference needs to draw the
  rung's weights again;
* ``accuracy`` is the rung's accuracy relative to ``:full``: the active
  parameter ratio to the power ``ACC_EXP``, less ``INT8_PENALTY`` for an
  int8 rung (the paper's Fig. 2a calibration);
* ``demand`` is the rung's (memory, compute) demand on a server, which the
  plain planner (``bench/reference/planner.py``) places by.

``bench/tests/test_bench_metrics.py`` holds both against the port's ladder.
"""

from __future__ import annotations

from typing import Dict, Tuple

ACC_EXP = 0.012
INT8_PENALTY = 0.003
RUNTIME_BUFFERS = 1.15          # memory demand over the weights' bytes
CELL_FLOPS = 197e12             # a cell's FLOP/s, for the compute demand

# tag -> (width, depth, bits), as LADDER_STEPS
STEPS = {
    "full": (1.0, 1.0, 16),
    "w075": (0.75, 1.0, 16),
    "w050": (0.5, 1.0, 16),
    "d050": (1.0, 0.5, 16),
    "int8": (1.0, 1.0, 8),
    "w050-int8": (0.5, 1.0, 8),
    "w025": (0.25, 1.0, 16),
}


def _r8(x: float, m: int) -> int:
    return max(m, int(round(x / m)) * m)


def rung_dims(model: Dict, tag: str) -> Dict:
    """The sizes of rung ``tag`` of the model whose published sizes are
    ``model`` (the configuration file's ``model`` object)."""
    width, depth, bits = STEPS[tag]
    out = dict(model)
    heads = (max(1, int(round(model["num_heads"] * width)))
             if model["num_heads"] else 0)
    kvh = model["num_kv_heads"]
    if heads and kvh:
        kvh = max(1, int(round(kvh * width)))
    plen = len(model["block_pattern"])
    out.update(
        num_layers=max(plen, int(round(model["num_layers"] * depth / plen))
                       * plen),
        d_model=_r8(model["d_model"] * width, 64),
        num_heads=heads,
        num_kv_heads=kvh,
        d_ff=_r8(model["d_ff"] * width, 64),
        quant_bits=bits)
    return out


def param_count(m: Dict) -> int:
    """Parameters of a dense-attention or RWKV stack, as the port counts
    them (embedding, blocks, norms)."""
    d, ff, v = m["d_model"], m["d_ff"], m["vocab_size"]
    h, kv, hd = m["num_heads"], m["num_kv_heads"], m.get("head_dim", 128)
    total = v * d + (0 if m.get("tie_embeddings", True) else v * d) + d
    pattern = m["block_pattern"]
    for i in range(m["num_layers"]):
        kind = pattern[i % len(pattern)]
        total += 2 * d
        if kind == "global":
            total += d * h * hd + 2 * d * kv * hd + h * hd * d
            if m.get("qkv_bias"):
                total += h * hd + 2 * kv * hd
            total += 3 * d * ff
        elif kind == "rwkv":
            hs = m.get("rwkv_head_size", 64)
            total += 5 * d * d + 2 * d * 64 + 64 * d + (d // hs) * hs
            total += 2 * d * ff
        else:
            raise ValueError(f"no frozen count for layer kind {kind!r}")
    return total


def accuracy(model: Dict, tag: str) -> float:
    """Accuracy of rung ``tag`` relative to the full model (1.0)."""
    ratio = param_count(rung_dims(model, tag)) / param_count(model)
    acc = ratio ** ACC_EXP
    if STEPS[tag][2] == 8:
        acc -= INT8_PENALTY
    return acc


def demand(model: Dict, tag: str) -> Tuple[float, float]:
    """Rung ``tag``'s demand: (bytes of memory, compute in cell-seconds a
    token per 1k requests a second)."""
    dims = rung_dims(model, tag)
    n = param_count(dims)
    mem = (n * dims["quant_bits"] // 8) * RUNTIME_BUFFERS
    return mem, 2.0 * n / CELL_FLOPS * 1e3


def tag_of(variant_name: str) -> str:
    """``qwen2.5-3b:w050`` -> ``w050``."""
    return variant_name.rsplit(":", 1)[1]
