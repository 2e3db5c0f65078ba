"""Plain PyTorch version of the decode attention kernel (the port of
``repro/kernels/decode_attention/ref.py``): dense masked softmax."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, lens, *, window=0):
    """q: (B,H,hd); caches (B,KVH,Smax,hd); lens (B,). Returns (B,H,hd)."""
    B, H, hd = q.shape
    _, KVH, Smax, _ = k_cache.shape
    G = H // KVH
    kx = k_cache.repeat_interleave(G, dim=1)
    vx = v_cache.repeat_interleave(G, dim=1)
    s = torch.einsum("bhk,bhsk->bhs", q.float(), kx.float()) / math.sqrt(hd)
    pos = torch.arange(Smax, device=q.device)
    lens = lens.to(q.device)
    valid = pos[None, :] < lens[:, None]
    if window > 0:
        valid &= pos[None, :] >= lens[:, None] - window
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bhsk->bhk", p, vx.float())
    return o.to(q.dtype)
