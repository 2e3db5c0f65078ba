"""Peaks, and the operations and bytes of the model calls and kernels.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity, at its 700 W limit). A share of a peak is stated against them,
with the card's power limit beside it.

K1's and K4's formulas are the ones the port's kernel table in ``PERF.md``
was measured with (``chip_smoke.py``): K1 counts 4 * hd * H operations a
score pair the causal mask keeps, and reads q, k, v and writes o once; K4
counts (5 * hs + 6) * hs operations a (row, head, step), on 3xTF32 tensor
cores (495 / 3 TFLOP/s), and reads r, k, v (bf16), lw, u and the state
(fp32) and writes y and the state (fp32) once.

The model's operations count each matrix product as 2 * m * n * k: the
layers' projections and FFN for every token, attention's two products
over the positions each token attends to, and the output head for the
tokens whose logits the call returns.
"""

from __future__ import annotations

from typing import Dict, Sequence

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32X3_FLOPS = 495e12 / 3


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    """Least seconds the card needs to move ``nbytes`` and do ``flops``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def k1_bound_s(B: int, Sq: int, Skv: int, H: int, KVH: int, hd: int,
               causal: bool, elt: int = 2) -> float:
    """K1's bound for one call (no window)."""
    if causal:
        # query i (of the last Sq of Skv positions) keeps keys 0..offset+i
        off = Skv - Sq
        pairs = Sq * off + Sq * (Sq + 1) // 2
    else:
        pairs = Sq * Skv
    flops = 4 * hd * H * pairs * B
    nbytes = elt * B * hd * (2 * Sq * H + 2 * Skv * KVH)
    return bound_s(nbytes, flops, PEAK_BF16_FLOPS)


def k4_bound_s(B: int, S: int, NH: int, hs: int, elt: int = 2) -> float:
    """K4's bound for one chunked (prefill) call."""
    flops = B * S * NH * (5 * hs + 6) * hs
    nbytes = (3 * elt * B * S * NH * hs          # r, k, v
              + 4 * B * S * NH * hs              # lw
              + 4 * NH * hs                      # u
              + 2 * 4 * B * NH * hs * hs         # state in and out
              + 4 * B * S * NH * hs)             # y (fp32)
    return bound_s(nbytes, flops, PEAK_TF32X3_FLOPS)


def _matmul_params_per_layer(m: Dict) -> int:
    d, ff = m["d_model"], m["d_ff"]
    kind = m["block_pattern"][0]
    if kind == "global":
        h, kv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        return d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff
    if kind == "rwkv":
        # r, k, v, g, o; the decay bottleneck; channel-mix in, out, r
        return 5 * d * d + 2 * d * 64 + 2 * d * ff + d * d
    raise ValueError(f"no FLOP count for layer kind {kind!r}")


def _mixer_flops(m: Dict, contexts: Sequence[int]) -> float:
    """Attention's (or WKV's) operations for tokens that see ``contexts``
    positions each (themselves included), over all layers."""
    kind = m["block_pattern"][0]
    if kind == "global":
        per = 4 * m["num_heads"] * m["head_dim"]
        return float(per * sum(contexts)) * m["num_layers"]
    hs = m["rwkv_head_size"]
    per = (m["d_model"] // hs) * (5 * hs + 6) * hs
    return float(per * len(contexts)) * m["num_layers"]


def prefill_flops(m: Dict, S: int) -> float:
    """A prefill of S tokens from an empty cache, logits of the last."""
    dense = 2.0 * _matmul_params_per_layer(m) * m["num_layers"] * S
    mixer = _mixer_flops(m, range(1, S + 1)) if m["block_pattern"][0] \
        == "global" else _mixer_flops(m, [1] * S)
    head = 2.0 * m["d_model"] * m["vocab_size"]
    return dense + mixer + head


def decode_flops(m: Dict, contexts: Sequence[int]) -> float:
    """One decode step for the slots in use, each at ``contexts[i]``
    positions (its new token included)."""
    n = len(contexts)
    dense = 2.0 * _matmul_params_per_layer(m) * m["num_layers"] * n
    head = 2.0 * m["d_model"] * m["vocab_size"] * n
    return dense + _mixer_flops(m, contexts) + head
