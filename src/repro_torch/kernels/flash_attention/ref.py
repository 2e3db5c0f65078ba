"""Plain PyTorch versions of the flash attention kernels: the forward
(the port of ``repro/kernels/flash_attention/ref.py``, a dense masked
softmax, with its row log-sum-exp on request) and the backward, which
the JAX package takes from XLA's autodiff of ``flash_attention_jnp`` and
the port from ``csrc/flash_attention_bwd.cu``."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.rwkv6_scan.ref import tf32x3_matmul

NEG_INF = -1e30


def _mask(Sq, Skv, causal, window, device):
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= kp > qp - window
    return mask


def _scores(q, k, causal, window):
    """(scaled scores (B,H,Sq,Skv) fp32 with NEG_INF where masked, mask,
    k's heads expanded to q's)."""
    B, H, Sq, hd = q.shape
    _, KVH, Skv, _ = k.shape
    kx = k.repeat_interleave(H // KVH, dim=1)
    s = torch.einsum("bhqk,bhsk->bhqs", q.float(), kx.float()) / math.sqrt(hd)
    mask = _mask(Sq, Skv, causal, window, q.device)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def flash_attention_ref(q, k, v, *, causal=True, window=0, return_lse=False):
    """q: (B,H,Sq,hd); k,v: (B,KVH,Skv,hd). Naive materialized softmax.
    With ``return_lse``, also the row log-sum-exp of the scaled scores
    (B,H,Sq) fp32, the statistic the backward reads."""
    s, _ = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    vx = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    o = torch.einsum("bhqs,bhsk->bhqk", p, vx.float()).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0,
                            tf32x3=False):
    """FlashAttention-2's backward on a dense masked softmax: the plain
    version of ``flash_attention_bwd.cu``. q, o, do: (B,H,Sq,hd); k, v:
    (B,KVH,Skv,hd); lse (B,H,Sq) fp32 from the forward. Returns (dq, dk,
    dv) in the inputs' dtypes; dk and dv sum over each KV head's group
    of G = H / KVH query heads, head by head in the order g = 0 .. G-1.

        P = exp(S - lse), D = rowsum(dO * O), dS = P * (dO V^T - D),
        dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.

    With ``tf32x3`` every product rounds its operands as the kernel's
    fp32 route does (3xTF32: each operand a TF32 high part plus a TF32
    remainder, the lo.lo term dropped).
    """
    B, H, Sq, hd = q.shape
    _, KVH, Skv, _ = k.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)

    def mm(a, b):
        return tf32x3_matmul(a, b, tf32x3)

    qf, dof, of = q.float(), do.float(), o.float()
    kx = k.float().repeat_interleave(G, dim=1)
    vx = v.float().repeat_interleave(G, dim=1)
    mask = _mask(Sq, Skv, causal, window, q.device)
    s = mm(qf, kx.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    D = (dof * of).sum(-1)
    ds = p * (mm(dof, vx.transpose(-1, -2)) - D[..., None])
    dq = mm(ds, kx) * scale
    dk = mm(ds.transpose(-1, -2), qf) * scale
    dv = mm(p.transpose(-1, -2), dof)
    dk = sum(dk.reshape(B, KVH, G, Skv, hd).unbind(2))
    dv = sum(dv.reshape(B, KVH, G, Skv, hd).unbind(2))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
