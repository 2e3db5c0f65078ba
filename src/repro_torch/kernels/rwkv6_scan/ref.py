"""Plain PyTorch versions of the WKV-6 kernels, in the model's
(B, S, nh, hs) layout.

``wkv6_ref`` is the step-by-step recurrence (the port of
``repro/models/rwkv6.py::wkv_scan``, which is also
``repro/kernels/rwkv6_scan/ref.py::wkv6_ref`` with an initial state): the
wrapper's CPU path and the oracle of both CUDA routes.

``wkv6_chunked_ref`` is the algorithm of the chunked CUDA route, step for
step: chunks of ``chunk`` steps cut into sub-chunks of ``sub`` rows, every
exponent kept <= 0 (no clamp on lw), and, with ``tf32x3``, every matrix
product rounded as the kernel's 3xTF32 tensor-core products round their
operands. It is what the CPU tests hold against the JAX model.
"""

from __future__ import annotations

import torch


def wkv6_ref(r, k, v, lw, u, s0=None):
    """r, k, v, lw: (B,S,nh,hs); u: (nh,hs); s0: (B,nh,hs,hs) fp32 or None.

    Returns (y (B,S,nh,hs) fp32, s_out (B,nh,hs,hs) fp32).
    """
    B, S, nh, hs = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(lw.float())
    s = (torch.zeros((B, nh, hs, hs), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    uf = u.float()[..., :, None]
    y = torch.empty((B, S, nh, hs), dtype=torch.float32, device=r.device)
    for t in range(S):
        a = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # (B,nh,hs,hs)
        y[:, t] = torch.einsum("bnk,bnkv->bnv", rf[:, t], s + uf * a)
        s = w[:, t, :, :, None] * s + a
    return y, s


def tf32_round(x):
    """fp32 -> the nearest TF32 value (10-bit mantissa), ties away from
    zero: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32x3_matmul(a, b, tf32x3):
    """a @ b in fp32, or as the kernel's 3xTF32 product: each operand
    split into a TF32 high part and a TF32 remainder, hi.hi + hi.lo +
    lo.hi (lo.lo dropped)."""
    if not tf32x3:
        return a @ b
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def wkv6_chunked_ref(r, k, v, lw, u, s0=None, *, chunk=32, sub=16,
                     tf32x3=False):
    """The chunked route's algorithm; same contract as ``wkv6_ref``.

    Per chunk (padded with zeros past S), with cum the inclusive and
    cum_prev the exclusive cumulative sum of lw: the chunk's state
    increment (k e^{cum_last - cum})^T v and decay e^{cum_last}; a walk
    over the chunks for each chunk's incoming state S_in; then
    y = (r e^{cum_prev}) @ S_in + A @ v, with A[t, s] for t in sub-chunk p
    and s before its first row b_p the product
    (r_t e^{cum_prev_t - cum_prev_{b_p}}) . (k_s e^{cum_prev_{b_p} - cum_s}),
    inside a diagonal sub-chunk sum_k r_t k_s exp(min(cum_prev_t - cum_s,
    0)) for s < t and r_t . (u k_t) at s = t. Every exponent is <= 0.
    """
    B, S, nh, hs = r.shape
    C = chunk
    assert C % sub == 0
    pad = (-S) % C
    nc = (S + pad) // C

    def chunks(t):                           # -> (B, nh, nc, C, hs) fp32
        t = t.float().movedim(2, 1)
        if pad:
            t = torch.nn.functional.pad(t, (0, 0, 0, pad))
        return t.reshape(B, nh, nc, C, hs)

    rc, kc, vc, lwc = map(chunks, (r, k, v, lw))
    cum = torch.cumsum(lwc, dim=3)                          # inclusive
    cum_prev = torch.cat([torch.zeros_like(cum[..., :1, :]),
                          cum[..., :-1, :]], dim=3)         # exclusive
    cum_last = cum[..., -1:, :]

    # (a) each chunk's state increment and decay
    k_dec = kc * torch.exp(cum_last - cum)
    dstate = tf32x3_matmul(k_dec.transpose(-1, -2), vc,
                           tf32x3)                          # (.., hs, hs)
    decay = torch.exp(cum_last[..., 0, :])                  # (.., hs)

    # (b) the walk over chunks
    s = (torch.zeros((B, nh, hs, hs), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, :, c, :, None] * s + dstate[:, :, c]
    s_in = torch.stack(s_in, dim=2)                         # (B,nh,nc,hs,hs)

    # (c) the outputs
    a = torch.zeros((B, nh, nc, C, C), dtype=torch.float32, device=r.device)
    lower = torch.tril(torch.ones((sub, sub), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    uf = u.float()[None, :, None, None, :]
    for p in range(C // sub):
        b0 = p * sub
        rows = slice(b0, b0 + sub)
        rt, kt = rc[..., rows, :], kc[..., rows, :]
        expo = cum_prev[..., rows, None, :] - cum[..., None, rows, :]
        diag = (rt[..., :, None, :] * kt[..., None, :, :]
                * torch.exp(torch.clamp(expo, max=0.0))).sum(-1) * lower
        diag = diag + torch.diag_embed((rt * uf * kt).sum(-1))
        a[..., rows, rows] = diag
        if p:
            ref = cum_prev[..., b0:b0 + 1, :]
            r_loc = rt * torch.exp(cum_prev[..., rows, :] - ref)
            k_loc = kc[..., :b0, :] * torch.exp(ref - cum[..., :b0, :])
            a[..., rows, :b0] = tf32x3_matmul(
                r_loc, k_loc.transpose(-1, -2), tf32x3)
    r_dec = rc * torch.exp(cum_prev)
    y = tf32x3_matmul(r_dec, s_in, tf32x3) + tf32x3_matmul(a, vc, tf32x3)
    y = y.reshape(B, nh, nc * C, hs)[:, :, :S].movedim(1, 2)
    return y.contiguous(), s
