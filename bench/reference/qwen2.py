"""Plain fp32 forward of a Qwen2-style decoder stack, in blocks.

Each block as the Qwen2 description has it: RMSNorm, grouped-query
attention with QKV bias (where the configuration has one) and rotary embeddings on half-split
pairs at theta ``rope_theta``, causal softmax, then RMSNorm and a SwiGLU
FFN, each with a residual; a final RMSNorm and the tied embedding as the
output head. Everything in fp32 from the served bf16 weights, with TF32
off; rotary angles in fp64. Attention runs over blocks of queries and the
FFN over blocks of rows, so a 16 k prompt fits beside nothing else.

``forward`` returns the logits of the last ``n_out`` positions.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from . import quant as Q

Q_BLOCK = 1024
ROW_BLOCK = 4096


def rmsnorm(x, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def rope_tables(S: int, hd: int, theta: float, device):
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x, cos, sin):
    """x (S, heads, hd); pairs (i, i + hd/2) rotate by position."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attend(q, k, v, hd):
    """Causal GQA over blocks of queries. q (S,H,hd), k/v (S,KV,hd)."""
    S, H, _ = q.shape
    KV = k.shape[1]
    G = H // KV
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for a in range(0, S, Q_BLOCK):
        b = min(S, a + Q_BLOCK)
        qb = q[a:b].reshape(b - a, KV, G, hd)
        s = torch.einsum("qkgd,skd->kgqs", qb, k[:b]) * scale
        qi = torch.arange(a, b, device=q.device)[:, None]
        kj = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.einsum("kgqs,skd->qkgd", p, v[:b]).reshape(
            b - a, H, hd)
    return out


@torch.no_grad()
def forward(w: Dict, m: Dict, tokens: torch.Tensor, n_out: int, *,
            quant: bool = False) -> torch.Tensor:
    """Logits (n_out, V) fp32 of the last ``n_out`` positions of
    ``tokens`` (S,). ``quant``: the control's fp8 linear layers."""
    S = tokens.numel()
    d, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    eps = m["norm_eps"]
    x = w["embed"][tokens].float()
    cos, sin = rope_tables(S, hd, m["rope_theta"], x.device)
    for lw in w["layers"]:
        h = rmsnorm(x, eps)
        q = Q.linear(h, lw["wq"].float().reshape(d, H * hd), quant)
        k = Q.linear(h, lw["wk"].float().reshape(d, KV * hd), quant)
        v = Q.linear(h, lw["wv"].float().reshape(d, KV * hd), quant)
        if "bq" in lw:
            q = q + lw["bq"].float().reshape(H * hd)
            k = k + lw["bk"].float().reshape(KV * hd)
            v = v + lw["bv"].float().reshape(KV * hd)
        q = rope(q.reshape(S, H, hd), cos, sin)
        k = rope(k.reshape(S, KV, hd), cos, sin)
        o = _attend(q, k, v.reshape(S, KV, hd), hd).reshape(S, H * hd)
        del q, k, v
        x = x + Q.linear(o, lw["wo"].float().reshape(H * hd, d), quant)
        del o
        wg, wu, wd = (lw[n].float() for n in ("w_gate", "w_up", "w_down"))
        for a in range(0, S, ROW_BLOCK):
            h = rmsnorm(x[a:a + ROW_BLOCK], eps)
            g = F.silu(Q.linear(h, wg, quant)) * Q.linear(h, wu, quant)
            x[a:a + ROW_BLOCK] += Q.linear(g, wd, quant)
        del wg, wu, wd
    h = rmsnorm(x[S - n_out:], eps)
    return Q.linear(h, w["unembed"].float().T, quant)
