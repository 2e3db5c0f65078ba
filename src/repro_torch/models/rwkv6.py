"""RWKV-6 "Finch" time-mix / channel-mix in PyTorch (port of
``repro/models/rwkv6.py``; arXiv:2404.05892).

Core recurrence per head (state S in R^{hs x hs}, data-dependent decay w_t):

    y_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

On a CUDA tensor ``time_mix`` runs K4 (``kernels.rwkv6_scan``): its
chunked tensor-core kernels for a prefill, the form of ``wkv_chunked``
below, and its recurrence for a decode step, from the slot's state and
with the log-decay as the model computes it (no clamp); under autograd
through ``WKV6Fn`` (the same kernels, then K4's backward kernels). On a
CPU tensor
it runs the ports of the JAX model's two forms, ``wkv_chunked`` (prefill)
and ``wkv_scan`` (decode). On a meta tensor (the dry run's trace: shapes
only) a prefill runs K4's chunked algorithm in plain form,
``wkv6_chunked_ref``, whose one loop over the chunks is a few operations
where ``wkv_chunked``'s body is some eighty. A state passed in is updated
in place and returned; the JAX functions return a new state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked_ref
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref as wkv_scan
from repro_torch.models.layers import _he, init_layernorm, layernorm

DECAY_BOTTLENECK = 64


def init_time_mix(gen, cfg, device, dtype=None):
    dtype = dtype or cfg.pdtype
    f32 = torch.float32
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    nh = d // hs
    s = 1 / math.sqrt(d)
    return {
        "mix": _he(gen, (5, d), 0.2, f32, device),   # r,k,v,g,w lerp coeffs
        "w_r": _he(gen, (d, d), s, dtype, device),
        "w_k": _he(gen, (d, d), s, dtype, device),
        "w_v": _he(gen, (d, d), s, dtype, device),
        "w_g": _he(gen, (d, d), s, dtype, device),
        "w_o": _he(gen, (d, d), s, dtype, device),
        "decay_w1": _he(gen, (d, DECAY_BOTTLENECK), s, f32, device),
        "decay_w2": _he(gen, (DECAY_BOTTLENECK, d),
                        1 / math.sqrt(DECAY_BOTTLENECK), f32, device),
        # base decay: init so w in (0.3, 0.99) across channels
        "decay_base": torch.linspace(-6.0, 0.5, d, dtype=f32, device=device),
        "bonus_u": _he(gen, (nh, hs), 0.5, f32, device),
        "ln_x": init_layernorm(d, f32, device),
    }


def init_channel_mix(gen, cfg, device, dtype=None):
    dtype = dtype or cfg.pdtype
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mix": _he(gen, (2, d), 0.2, torch.float32, device),   # k, r lerp
        "w_in": _he(gen, (d, ff), 1 / math.sqrt(d), dtype, device),
        "w_out": _he(gen, (ff, d), 1 / math.sqrt(ff), dtype, device),
        "w_r": _he(gen, (d, d), 1 / math.sqrt(d), dtype, device),
    }


def _token_shift(x, last=None):
    """x_{t-1} with optional carried last token. x: (B,S,d)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    else:
        last = last[:, None, :].to(x.dtype)
    return torch.cat([last, x[:, :-1]], dim=1)


def _lerp(x, x_prev, mu):
    mu = torch.sigmoid(mu).to(x.dtype)
    return x + (x_prev - x) * mu


def _rkvgw(params, cfg, x, shifted):
    """Project mixed inputs to r,k,v,g and log-decay lw (<= 0)."""
    hs = cfg.rwkv_head_size
    nh = cfg.d_model // hs
    B, S, _ = x.shape
    mr, mk, mv, mg, mw = params["mix"]
    xr = _lerp(x, shifted, mr)
    xk = _lerp(x, shifted, mk)
    xv = _lerp(x, shifted, mv)
    xg = _lerp(x, shifted, mg)
    xw = _lerp(x, shifted, mw)
    r = (xr @ params["w_r"]).reshape(B, S, nh, hs)
    k = (xk @ params["w_k"]).reshape(B, S, nh, hs)
    v = (xv @ params["w_v"]).reshape(B, S, nh, hs)
    g = xg @ params["w_g"]
    # data-dependent decay (Finch): lw = -exp(base + tanh(x W1) W2) <= 0
    dd = torch.tanh(xw.float() @ params["decay_w1"]) @ params["decay_w2"]
    lw = -torch.exp(params["decay_base"] + dd)            # (B,S,d), <= 0
    return r, k, v, g, lw.reshape(B, S, nh, hs)


def wkv_chunked(r, k, v, lw, u, state=None, chunk=32):
    """Chunk-parallel WKV with non-positive cross-step exponents."""
    B, S, nh, hs = r.shape
    pad = (-S) % chunk
    if pad:
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    C = chunk
    nchunk = (S + pad) // C

    def to_chunks(t):
        return t.reshape(B, nchunk, C, nh, hs).movedim(1, 0).float()

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, lw))
    s = (torch.zeros((B, nh, hs, hs), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    causal = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    uf = u.float()
    ys = []
    for c in range(nchunk):
        rt, kt, vt, lwt = rc[c], kc[c], vc[c], lwc[c]      # (B,C,nh,hs)
        cum = torch.cumsum(lwt, dim=1)                     # inclusive
        cum_prev = cum - lwt                               # exclusive
        cum_last = cum[:, -1:]                             # (B,1,nh,hs)
        # inter-chunk: y_t += (r_t * exp(cum_prev)) @ S_in
        r_dec = rt * torch.exp(cum_prev)
        y = torch.einsum("bcnk,bnkv->bcnv", r_dec, s)
        # intra-chunk (s < t): A[t,s] = sum_k r_t[k] k_s[k] e^{cum_prev_t - cum_s}
        expo = cum_prev[:, :, None] - cum[:, None, :]      # (B,C,C,nh,hs)
        a = (rt[:, :, None] * kt[:, None, :]
             * torch.exp(torch.clamp(expo, max=0.0))).sum(-1)
        a = a * causal[None, :, :, None]
        y = y + torch.einsum("bcsn,bsnv->bcnv", a, vt)
        # diagonal (bonus) term
        y = y + (rt * (uf * kt)).sum(-1, keepdim=True) * vt
        # state update: S_out = e^{cum_last} S_in + sum_s (k_s e^{cum_last-cum_s}) v_s
        k_dec = kt * torch.exp(cum_last - cum)
        s = torch.exp(cum_last[:, 0, :, :, None]) * s + \
            torch.einsum("bsnk,bsnv->bnkv", k_dec, vt)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, S + pad, nh, hs)[:, :S]
    return y, s


def time_mix(params, cfg, x, state=None):
    """Full RWKV-6 time-mix layer.

    x: (B,S,d). state: None or {"last": (B,d), "wkv": (B,nh,hs,hs) fp32},
    updated in place. Returns (out, state).
    """
    B, S, d = x.shape
    shifted = _token_shift(x, None if state is None else state["last"])
    r, k, v, g, lw = _rkvgw(params, cfg, x, shifted)
    u = params["bonus_u"]
    s0 = None if state is None else state["wkv"]
    if x.is_cuda:
        start = s0 if s0 is not None else torch.zeros(
            (B, d // cfg.rwkv_head_size) + (cfg.rwkv_head_size,) * 2,
            dtype=torch.float32, device=x.device)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, lw, u, start)):
            # a train step: K4's forward, then its backward kernels; it
            # passes no state to update in place
            if s0 is not None:
                raise ValueError("under autograd WKV-6 updates no state "
                                 "in place")
            y, s_out = wkv_ops.WKV6Fn.apply(r, k, v, lw, u, start)
        else:
            y, s_out = wkv_ops.wkv6(r, k, v, lw, u, start, s_out=s0)
    elif S > 1:
        chunked = wkv6_chunked_ref if x.device.type == "meta" else wkv_chunked
        y, s_out = chunked(r, k, v, lw, u, s0)
    else:
        y, s_out = wkv_scan(r, k, v, lw, u, s0)
    y = y.reshape(B, S, d)
    y = layernorm(params["ln_x"], y, eps=1e-5)
    y = y.to(x.dtype) * F.silu(g.float()).to(x.dtype)
    out = y @ params["w_o"]
    last = x[:, -1].float()
    if state is None:
        return out, {"last": last, "wkv": s_out}
    state["last"].copy_(last)
    if s_out is not state["wkv"]:
        state["wkv"].copy_(s_out)
    return out, state


def channel_mix(params, cfg, x, state=None):
    """RWKV channel-mix (squared-ReLU FFN with receptance gate).

    state: None or {"last": (B,d)}, updated in place.
    """
    shifted = _token_shift(x, None if state is None else state["last"])
    mk, mr = params["mix"]
    xk = _lerp(x, shifted, mk)
    xr = _lerp(x, shifted, mr)
    rgate = torch.sigmoid((xr @ params["w_r"]).float())
    h = xk @ params["w_in"]
    h = torch.square(torch.relu(h.float())).to(x.dtype)
    out = rgate.to(x.dtype) * (h @ params["w_out"])
    last = x[:, -1].float()
    if state is None:
        return out, {"last": last}
    state["last"].copy_(last)
    return out, state


def init_rwkv_state(cfg, batch, device):
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    nh = d // hs
    f32 = torch.float32
    return {
        "tm": {"last": torch.zeros((batch, d), dtype=f32, device=device),
               "wkv": torch.zeros((batch, nh, hs, hs), dtype=f32,
                                  device=device)},
        "cm": {"last": torch.zeros((batch, d), dtype=f32, device=device)},
    }
