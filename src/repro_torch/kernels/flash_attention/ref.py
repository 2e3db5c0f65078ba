"""Plain PyTorch version of the flash attention kernel (the port of
``repro/kernels/flash_attention/ref.py``): dense masked softmax."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B,H,Sq,hd); k,v: (B,KVH,Skv,hd). Naive materialized softmax."""
    B, H, Sq, hd = q.shape
    _, KVH, Skv, _ = k.shape
    G = H // KVH
    kx = k.repeat_interleave(G, dim=1)
    vx = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqk,bhsk->bhqs", q.float(), kx.float()) / math.sqrt(hd)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqs,bhsk->bhqk", p, vx.float())
    return o.to(q.dtype)
