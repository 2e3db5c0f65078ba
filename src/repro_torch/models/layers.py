"""Core transformer layers in PyTorch (port of ``repro/models/layers.py``).

Params are plain nested dicts of tensors with the JAX package's names and
shapes, so a params bridge maps them 1:1. ``logical_constraint`` is
dropped: it is a no-op on one device.

``flash_attention`` and ``decode_attention`` send a CUDA tensor to the
hand-written kernels (K1 under autograd through ``FlashAttentionFn``,
whose backward is a kernel too) and a CPU tensor to
``flash_attention_blocked`` (or ``banded_local_attention`` when a sliding
window binds) /
``decode_attention_dense``, the ports of ``flash_attention_jnp``,
``banded_local_attention_jnp`` and ``decode_attention_jnp``, which scale q
in the model dtype as JAX does.
"""

from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30


# a draw of more than DRAW_LIMIT elements is made in slices of about
# DRAW_SLICE along the leading axis, so its fp32 scratch stays about a GiB
# (arctic-480b's expert stacks are 4.5e9 elements a weight; every other
# weight of the ten archs is drawn whole)
DRAW_LIMIT, DRAW_SLICE = 1 << 31, 1 << 28


class _DrawTarget(threading.local):
    """Where ``_he`` puts its draws: None allocates each one; otherwise a
    callable ``(shape, dtype) -> tensor`` that hands the tensor to draw
    into (a meta tensor: no draw at all). ``model.init_params`` uses it to
    draw a stacked layer's weights straight into its slice of the stack."""
    fn = None


DRAW_TARGET = _DrawTarget()


def _he(gen, shape, scale, dtype, device):
    """Normal draw in fp32, scaled, then cast (as ``layers._he``)."""
    shape = tuple(shape)
    out = None if DRAW_TARGET.fn is None else DRAW_TARGET.fn(shape, dtype)
    if out is not None and out.device.type == "meta":
        return out
    n = math.prod(shape)
    if n <= DRAW_LIMIT or len(shape) < 2:
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        x = x.mul_(scale).to(dtype)
        return x if out is None else out.copy_(x)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, DRAW_SLICE // (n // shape[0]))
    for r in range(0, shape[0], rows):
        part = out[r:r + rows]
        x = torch.randn(part.shape, generator=gen, device=device,
                        dtype=torch.float32)
        part.copy_(x.mul_(scale))
    return out


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def init_rmsnorm(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


def init_layernorm(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    out = x * params["scale"].float() + params["bias"].float()
    return out.to(dt)


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------

def rope(x, positions, theta=10_000.0):
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    ar = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-ar / hd * math.log(theta))
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    angles = angles[..., None, :]                          # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA, causal; optional RMSNorm of q and k over head_dim)
# --------------------------------------------------------------------------

def init_attention(gen, cfg, device, dtype=None):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dtype = dtype or cfg.pdtype
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(h * hd)
    p = {
        "wq": _he(gen, (d, h, hd), s_in, dtype, device),
        "wk": _he(gen, (d, kv, hd), s_in, dtype, device),
        "wv": _he(gen, (d, kv, hd), s_in, dtype, device),
        "wo": _he(gen, (h, hd, d), s_out, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, device)
        p["k_norm"] = init_rmsnorm(hd, dtype, device)
    return p


def _qkv(params, cfg, x, positions, rope_on=True, theta=None):
    """q, k, v of one attention block; RoPE at ``theta`` (the config's
    ``rope_theta`` when None), or none when ``rope_on`` is False."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if rope_on:
        theta = cfg.rope_theta if theta is None else theta
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    return q, k, v


def flash_attention(q, k, v, *, causal=True, window=0, kv_block=None):
    """q: (B,Sq,H,hd); k,v: (B,Skv,KVH,hd) -> (B,Sq,H,hd). ``kv_block`` is
    the plain path's block of keys (the JAX caller's; by default from
    Sq). On the card, a call that autograd records goes through
    ``FlashAttentionFn`` (K1, then its backward kernel)."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return flash_ops.FlashAttentionFn.apply(q, k, v, causal, window)
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window)
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 kv_block=kv_block)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0):
    """q: (B,1,H,hd); caches (B,Smax,KVH,hd); cache_len (B,) int32."""
    if q.is_cuda:
        return decode_ops.decode_attention(q, k_cache, v_cache, cache_len,
                                           window=window)
    return decode_attention_dense(q, k_cache, v_cache, cache_len,
                                  window=window)


def flash_attention_plain(q, k, v, *, causal=True, window=0, kv_block=None):
    """The model's attention in plain PyTorch on any device: the path the
    CPU takes, as the JAX model's ``layer_forward`` picks it."""
    if window > 0 and causal and q.shape[1] == k.shape[1] > window:
        # as layer_forward in the JAX model: a binding static window is
        # banded; K1 skips the tiles outside the band on the card
        return banded_local_attention(q, k, v, window=window)
    if kv_block is None:
        kv_block = min(1024, max(128, q.shape[1]))
    return flash_attention_blocked(q, k, v, causal=causal, window=window,
                                   kv_block=kv_block)


def _expand_heads(t, G):
    """(B,S,KVH,hd) -> (B,S,KVH*G,hd); query head h reads kv head h // G."""
    return t if G == 1 else t.repeat_interleave(G, dim=2)


def flash_attention_blocked(q, k, v, *, causal=True, window=0,
                            kv_block=1024):
    """Port of ``flash_attention_jnp``: online softmax over KV blocks.

    q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd) with H % KVH == 0.
    window > 0 => sliding-window causal attention. Returns (B, Sq, H, hd).
    Operands stay in the model dtype; products accumulate in fp32, as
    ``preferred_element_type=float32`` does in JAX.
    """
    B, Sq, H, hd = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qf = (q * torch.tensor(scale, dtype=q.dtype)).float()
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, Sq, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    for start in range(0, Skv, kv_block):
        stop = start + kv_block
        kblk = _expand_heads(k[:, start:stop], G)
        vblk = _expand_heads(v[:, start:stop], G)
        # padding past Skv (as jnp.pad + kv_len_mask) scores NEG_INF
        pad = stop - min(stop, Skv)
        if pad:
            kblk = F.pad(kblk, (0, 0, 0, 0, 0, pad))
            vblk = F.pad(vblk, (0, 0, 0, 0, 0, pad))
        kv_pos = start + torch.arange(kv_block, device=q.device)
        s = torch.einsum("bqhk,bshk->bqhs", qf, kblk.float())
        mask = torch.ones((Sq, kv_block), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window > 0:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        if pad:
            mask &= kv_pos[None, :] < Skv
        s = torch.where(mask[None, :, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqhs,bshk->bqhk", p.to(v.dtype).float(),
                          vblk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def banded_local_attention(q, k, v, *, window, q_block=512):
    """Port of ``banded_local_attention_jnp``: causal sliding-window
    self-attention where each q block attends only to its
    (window + q_block) KV band. Full sequence (Sq == Skv) only."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    q_block = min(q_block, S)
    pad_s = (-S) % q_block
    if pad_s:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad_s)) for t in (q, k, v))
    band = window + q_block
    kp = F.pad(k, (0, 0, 0, 0, window, 0))
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    qs = q * torch.tensor(scale, dtype=q.dtype)
    outs = []
    for i in range(q.shape[1] // q_block):
        q0 = i * q_block
        qb = qs[:, q0:q0 + q_block].float()
        kb = _expand_heads(kp[:, q0:q0 + band], G)
        vb = _expand_heads(vp[:, q0:q0 + band], G)
        q_pos = q0 + torch.arange(q_block, device=q.device)
        kv_pos = q0 - window + torch.arange(band, device=q.device)
        s = torch.einsum("bqhk,bshk->bqhs", qb, kb.float())
        mask = ((q_pos[:, None] >= kv_pos[None, :])
                & (kv_pos[None, :] > q_pos[:, None] - window)
                & (kv_pos[None, :] >= 0) & (q_pos[:, None] < S))
        s = torch.where(mask[None, :, None, :], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        ob = torch.einsum("bqhs,bshk->bqhk", p.to(vb.dtype).float(),
                          vb.float())
        outs.append(ob.to(q.dtype))
    return torch.cat(outs, dim=1)[:, :S]


def decode_attention_dense(q, k_cache, v_cache, cache_len, *, window=0):
    """Port of ``decode_attention_jnp``: one token against a padded cache.

    q: (B, 1, H, hd); k_cache/v_cache: (B, Smax, KVH, hd);
    cache_len: (B,) number of valid cache entries INCLUDING this step.
    """
    B, _, H, hd = q.shape
    _, Smax, KVH, _ = k_cache.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qg = (q * torch.tensor(scale, dtype=q.dtype))[:, 0].reshape(B, KVH, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    pos = torch.arange(Smax, device=q.device)
    valid = pos[None, :] < cache_len[:, None]
    if window > 0:
        valid &= pos[None, :] > cache_len[:, None] - 1 - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------

def init_swiglu(gen, d, ff, dtype, device):
    return {
        "w_gate": _he(gen, (d, ff), 1 / math.sqrt(d), dtype, device),
        "w_up": _he(gen, (d, ff), 1 / math.sqrt(d), dtype, device),
        "w_down": _he(gen, (ff, d), 1 / math.sqrt(ff), dtype, device),
    }


def swiglu(params, x):
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


def init_gelu_mlp(gen, d, ff, dtype, device):
    return {
        "w_in": _he(gen, (d, ff), 1 / math.sqrt(d), dtype, device),
        "b_in": torch.zeros((ff,), dtype=dtype, device=device),
        "w_out": _he(gen, (ff, d), 1 / math.sqrt(ff), dtype, device),
        "b_out": torch.zeros((d,), dtype=dtype, device=device),
    }


def gelu_mlp(params, x):
    """``jax.nn.gelu``'s default, the tanh approximation, on an fp32
    upcast."""
    h = x @ params["w_in"] + params["b_in"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ params["w_out"] + params["b_out"]


# --------------------------------------------------------------------------
# Embedding / LM head
# --------------------------------------------------------------------------

def init_embedding(gen, vocab, d, dtype, device):
    return {"table": _he(gen, (vocab, d), 1.0 / math.sqrt(d), dtype, device)}


def embed(params, tokens):
    return params["table"][tokens]


def unembed(params, x, softcap=0.0):
    logits = x @ params["table"].T
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
