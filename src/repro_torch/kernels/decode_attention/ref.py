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


def decode_attention_split_ref(q, k_cache, v_cache, lens, *, window=0,
                               chunk):
    """The split-KV algorithm of the CUDA kernel in plain PyTorch, for the
    tests (the main path never calls it). Chunk s covers the key positions
    [s * chunk, (s + 1) * chunk); each chunk's partials are its max m, sum
    l and unnormalized acc in fp32, a chunk with no valid key giving
    exactly (NEG_INF, 0, 0); they merge in fixed split order:
    M = max m_s, w_s = exp(m_s - M), out = sum w_s acc_s / max(sum w_s l_s,
    1e-30). q: (B,H,hd); caches (B,KVH,Smax,hd); lens (B,). Returns the
    output (B,H,hd) in q's dtype and the partials (m, l, acc) shaped
    (B,KVH,n_split,G) and (B,KVH,n_split,G,hd)."""
    B, H, hd = q.shape
    _, KVH, Smax, _ = k_cache.shape
    G = H // KVH
    n_split = -(-Smax // chunk)
    pad = n_split * chunk - Smax
    kx = k_cache.repeat_interleave(G, dim=1).float()
    vx = v_cache.repeat_interleave(G, dim=1).float()
    kx, vx = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (kx, vx))
    s = torch.einsum("bhk,bhsk->bhs", q.float() / math.sqrt(hd), kx)
    pos = torch.arange(n_split * chunk, device=q.device)
    n_valid = lens.to(q.device).long().clamp(0, Smax)
    valid = pos[None, :] < n_valid[:, None]
    if window > 0:
        valid &= pos[None, :] >= (n_valid - window).clamp(min=0)[:, None]
    valid = valid[:, None, :].expand(B, H, -1).reshape(B, H, n_split, chunk)
    s = torch.where(valid, s.reshape(B, H, n_split, chunk),
                    torch.full_like(valid, NEG_INF, dtype=torch.float32))
    m = s.amax(-1)
    nonempty = valid.any(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    m = torch.where(nonempty, m, torch.full_like(m, NEG_INF))
    l = p.sum(-1)
    # as the kernel, V rows outside the valid range are zero, so a stale
    # NaN there never meets p = 0
    vx = torch.where(valid[..., None], vx.reshape(B, H, n_split, chunk, hd),
                     torch.zeros((), device=q.device))
    acc = torch.einsum("bhnc,bhnck->bhnk", p, vx)
    M = m.amax(-1)
    den = torch.zeros_like(M)
    out = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
    for i in range(n_split):                       # fixed split order
        w = torch.exp(m[..., i] - M)
        den = den + w * l[..., i]
        out = out + w[..., None] * acc[..., i, :]
    out = out / den.clamp(min=1e-30)[..., None]

    def by_group(t):                     # (B,H,n,...) -> (B,KVH,n,G,...)
        t = t.reshape(B, KVH, G, n_split, *t.shape[3:])
        return t.transpose(2, 3)

    return out.to(q.dtype), (by_group(m), by_group(l), by_group(acc))
