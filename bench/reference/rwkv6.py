"""Plain fp32 forward of an RWKV-6 ("Finch", arXiv:2404.05892) stack.

Each block as the program defines it: LayerNorm, then time-mix (token
shift by one, a sigmoid-weighted interpolation per projection, r / k / v /
g projections, the data-dependent log-decay lw = -exp(base + tanh(x W1)
W2), the WKV recurrence with bonus u, a LayerNorm over the model width
(eps 1e-5), a SiLU gate and the output projection), then LayerNorm and
channel-mix (token shift, a sigmoid receptance times a squared-ReLU FFN),
each with a residual; a final LayerNorm and an untied output head.
Departures from the published block, which the program shares: fixed
interpolation weights (no data-dependent ddlerp) and one LayerNorm over
the width where Finch normalises each head (GroupNorm).

The recurrence per head, with state S (hs x hs):
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(exp(lw_t)) S_{t-1}
          + k_t^T v_t
is evaluated exactly in closed form over chunks of ``CHUNK`` steps: within a
chunk, the decay between two steps as exp of a difference of cumulative
sums of lw (never above zero, so nothing overflows), over a group of chunks
at once; between chunks, the state carried from chunk to chunk.
All fp32 from the served weights, with TF32 off.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import quant as Q

CHUNK = 32
GROUP = 64                   # chunks whose pairs are formed at once
ROW_BLOCK = 8192


def layernorm(x, eps):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    return xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)


def shift(x):
    """x_{t-1}, zero before the first token."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def wkv(r, k, v, lw, u):
    """(S, nh, hs) fp32 each, u (nh, hs) -> y (S, nh, hs)."""
    S, nh, hs = r.shape
    C = CHUNK
    pad = (-S) % C
    if pad:
        # padded steps: no key, no query, no decay
        r, k, v, lw = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                       for t in (r, k, v, lw))
    n = (S + pad) // C
    R, K, V, LW = (t.reshape(n, C, nh, hs) for t in (r, k, v, lw))
    cum = torch.cumsum(LW, dim=1)                 # inclusive, in the chunk
    prev = cum - LW                               # exclusive
    last = cum[:, -1]                             # (n, nh, hs)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)[None, :, :, None, None]
    y = torch.empty_like(R)
    for a in range(0, n, GROUP):
        b = min(n, a + GROUP)
        # y_t += sum_{s<t} (sum_k r_t k_s exp(prev_t - cum_s)) v_s
        e = (prev[a:b, :, None] - cum[a:b, None, :]).masked_fill(
            ~tri, float("-inf")).exp_()
        att = (R[a:b, :, None] * K[a:b, None, :] * e).sum(-1)
        del e
        y[a:b] = (torch.einsum("gtsn,gsnv->gtnv", att, V[a:b])
                  + (R[a:b] * u * K[a:b]).sum(-1, keepdim=True) * V[a:b])
    # each chunk's state increment and decay, then the states in order
    inc = torch.einsum("gsnk,gsnv->gnkv", K * torch.exp(last[:, None] - cum),
                       V)
    decay = torch.exp(last)[..., None]
    state = torch.zeros((nh, hs, hs), dtype=torch.float32, device=r.device)
    states = torch.empty((n, nh, hs, hs), dtype=torch.float32,
                         device=r.device)
    for c in range(n):
        states[c] = state
        state = decay[c] * state + inc[c]
    y += torch.einsum("gtnk,gnkv->gtnv", R * torch.exp(prev), states)
    return y.reshape(n * C, nh, hs)[:S]


@torch.no_grad()
def forward(w: Dict, m: Dict, tokens: torch.Tensor, n_out: int, *,
            quant: bool = False) -> torch.Tensor:
    """Logits (n_out, V) fp32 of the last ``n_out`` positions of
    ``tokens`` (S,). ``quant``: the control's fp8 linear layers."""
    S = tokens.numel()
    d, hs = m["d_model"], m["rwkv_head_size"]
    nh = d // hs
    eps = m["norm_eps"]
    x = w["embed"][tokens].float()
    for lw_ in w["layers"]:
        h = layernorm(x, eps)
        hp = shift(h)
        mix = torch.sigmoid(lw_["tm_mix"])
        xr, xk, xv, xg, xw = (h + (hp - h) * mix[i] for i in range(5))
        del hp
        r = Q.linear(xr, lw_["tm_w_r"].float(), quant).reshape(S, nh, hs)
        k = Q.linear(xk, lw_["tm_w_k"].float(), quant).reshape(S, nh, hs)
        v = Q.linear(xv, lw_["tm_w_v"].float(), quant).reshape(S, nh, hs)
        g = Q.linear(xg, lw_["tm_w_g"].float(), quant)
        dd = torch.tanh(xw @ lw_["decay_w1"]) @ lw_["decay_w2"]
        lw = -torch.exp(lw_["decay_base"] + dd).reshape(S, nh, hs)
        del xr, xk, xv, xg, xw, dd
        y = wkv(r, k, v, lw, lw_["bonus_u"]).reshape(S, d)
        del r, k, v, lw
        y = layernorm(y, 1e-5) * torch.nn.functional.silu(g)
        x = x + Q.linear(y, lw_["tm_w_o"].float(), quant)
        del y, g
        h = layernorm(x, eps)
        hp = shift(h)
        mk, mr = torch.sigmoid(lw_["cm_mix"])
        w_in, w_out, w_r = (lw_[n].float() for n in
                            ("cm_w_in", "cm_w_out", "cm_w_r"))
        for a in range(0, S, ROW_BLOCK):
            hb, pb = h[a:a + ROW_BLOCK], hp[a:a + ROW_BLOCK]
            xk = hb + (pb - hb) * mk
            xr = hb + (pb - hb) * mr
            rg = torch.sigmoid(Q.linear(xr, w_r, quant))
            f = torch.relu(Q.linear(xk, w_in, quant)).square()
            x[a:a + ROW_BLOCK] += rg * Q.linear(f, w_out, quant)
        del h, hp, w_in, w_out, w_r
    h = layernorm(x[S - n_out:], eps)
    return Q.linear(h, w["unembed"].float().T, quant)
