"""A served variant's weights, drawn again from its name.

The program draws each variant's weights on the card from a generator
seeded with the CRC-32 of the variant's name: a normal draw in fp32,
scaled by 1 / sqrt(fan-in), then cast to the served dtype; weight after
weight in the order of the layer's definition, layer after layer, then the
embedding (and, untied, the output table). Norm scales start at one,
biases and shifts at zero, RWKV's base decay at an even spread from -6 to
0.5. This module makes the same draws in the same order on the same kind
of device, so the reference holds the served weights bit for bit without
reading any of the program's tensors. It imports nothing of the program.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List

import torch

DECAY_BOTTLENECK = 64


def variant_seed(name: str) -> int:
    return zlib.crc32(name.encode()) % (2**31)


class _Draw:
    def __init__(self, device: torch.device, seed: int):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, shape, scale, dtype):
        x = torch.randn(tuple(shape), generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return x.mul_(scale).to(dtype)


def _attention_layer(draw, m, dt) -> Dict[str, torch.Tensor]:
    d, h, kv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h * hd)
    w = {"wq": draw((d, h, hd), s_in, dt), "wk": draw((d, kv, hd), s_in, dt),
         "wv": draw((d, kv, hd), s_in, dt), "wo": draw((h, hd, d), s_out, dt)}
    if m.get("qkv_bias"):
        w["bq"] = torch.zeros((h, hd), dtype=dt, device=draw.device)
        w["bk"] = torch.zeros((kv, hd), dtype=dt, device=draw.device)
        w["bv"] = torch.zeros((kv, hd), dtype=dt, device=draw.device)
    ff = m["d_ff"]
    w["w_gate"] = draw((d, ff), 1 / math.sqrt(d), dt)
    w["w_up"] = draw((d, ff), 1 / math.sqrt(d), dt)
    w["w_down"] = draw((ff, d), 1 / math.sqrt(ff), dt)
    return w


def _rwkv_layer(draw, m, dt, device) -> Dict[str, torch.Tensor]:
    f32 = torch.float32
    d, ff, hs = m["d_model"], m["d_ff"], m["rwkv_head_size"]
    s = 1 / math.sqrt(d)
    w = {"tm_mix": draw((5, d), 0.2, f32)}
    for k in ("tm_w_r", "tm_w_k", "tm_w_v", "tm_w_g", "tm_w_o"):
        w[k] = draw((d, d), s, dt)
    w["decay_w1"] = draw((d, DECAY_BOTTLENECK), s, f32)
    w["decay_w2"] = draw((DECAY_BOTTLENECK, d),
                         1 / math.sqrt(DECAY_BOTTLENECK), f32)
    w["decay_base"] = torch.linspace(-6.0, 0.5, d, dtype=f32, device=device)
    w["bonus_u"] = draw((d // hs, hs), 0.5, f32)
    w["cm_mix"] = draw((2, d), 0.2, f32)
    w["cm_w_in"] = draw((d, ff), 1 / math.sqrt(d), dt)
    w["cm_w_out"] = draw((ff, d), 1 / math.sqrt(ff), dt)
    w["cm_w_r"] = draw((d, d), 1 / math.sqrt(d), dt)
    return w


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def draw_weights(m: Dict, variant_name: str,
                 device: torch.device) -> Dict[str, object]:
    """{"layers": [per-layer dict], "embed": table, "unembed": table} of
    the variant with sizes ``m`` (a rung's sizes, ``ladder.rung_dims``),
    in the served dtype."""
    dt = DTYPES[m["param_dtype"]]
    draw = _Draw(device, variant_seed(variant_name))
    kinds = m["block_pattern"]
    if len(kinds) != 1:
        raise ValueError("the reference draws one-kind stacks only")
    layers: List[Dict[str, torch.Tensor]] = []
    for _ in range(m["num_layers"]):
        if kinds[0] == "global":
            layers.append(_attention_layer(draw, m, dt))
        elif kinds[0] == "rwkv":
            layers.append(_rwkv_layer(draw, m, dt, device))
        else:
            raise ValueError(f"no reference for layer kind {kinds[0]!r}")
    V, d = m["vocab_size"], m["d_model"]
    embed = draw((V, d), 1.0 / math.sqrt(d), dt)
    unembed = (embed if m.get("tie_embeddings", True)
               else draw((V, d), 1.0 / math.sqrt(d), dt))
    return {"layers": layers, "embed": embed, "unembed": unembed}
