"""Encoder-decoder backbone in PyTorch (port of ``repro/models/encdec.py``,
whisper-medium).

The conv audio frontend is a stub, as in the JAX package: callers pass
precomputed frame embeddings (B, T_frames, d_model). Encoder layers are
bidirectional attention with RoPE + GELU MLP; decoder layers are causal
self attention with RoPE, cross attention to the encoder output (no
RoPE) and a GELU MLP, all pre-LayerNorm. Cross K/V are computed once at
prefill and cached.

The param tree keeps the JAX layout — ``embed``, ``enc_layers`` and
``dec_layers`` stacked on a leading layer axis, ``enc_final_norm``,
``final_norm`` — so the params bridge maps it 1:1; the cache is
``pos`` / ``self`` {k, v} (n_dec, B, max_len, KVH, hd) / ``cross`` {k, v}
(n_dec, B, T, KVH, hd), updated in place as ``model.py``'s is. Python
loops over the stacks replace ``_maybe_scan``; with ``cfg.remat`` under
autograd each encoder and decoder layer is one remat region, as each
scanned body is ``jax.checkpoint``'d there. On the card every
attention is a kernel: K1 for the encoder (non-causal), the decoder's
self attention at prefill (causal) and every cross attention (non-causal,
Sq = the prompt or 1 against Skv = T), K2 for the decoder's self
attention at a decode step.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models.model import (_tree_map, init_stacked, recording,
                                      remat_call, unstack)


def _init_enc_layer(gen, cfg, dev):
    d = cfg.d_model
    return {
        "norm1": L.init_layernorm(d, cfg.pdtype, dev),
        "attn": L.init_attention(gen, cfg, dev),
        "norm2": L.init_layernorm(d, cfg.pdtype, dev),
        "mlp": L.init_gelu_mlp(gen, d, cfg.d_ff, cfg.pdtype, dev),
    }


def _init_dec_layer(gen, cfg, dev):
    d = cfg.d_model
    return {
        "norm1": L.init_layernorm(d, cfg.pdtype, dev),
        "self_attn": L.init_attention(gen, cfg, dev),
        "norm2": L.init_layernorm(d, cfg.pdtype, dev),
        "cross_attn": L.init_attention(gen, cfg, dev),
        "norm3": L.init_layernorm(d, cfg.pdtype, dev),
        "mlp": L.init_gelu_mlp(gen, d, cfg.d_ff, cfg.pdtype, dev),
    }


def init_params(generator, cfg, dev) -> Dict[str, Any]:
    enc = init_stacked(generator, lambda: _init_enc_layer(generator, cfg, dev),
                       cfg.num_encoder_layers, dev)
    dec = init_stacked(generator, lambda: _init_dec_layer(generator, cfg, dev),
                       cfg.num_decoder_layers, dev)
    return {
        "embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                  cfg.pdtype, dev),
        "enc_layers": enc,
        "enc_final_norm": L.init_layernorm(cfg.d_model, cfg.pdtype, dev),
        "dec_layers": dec,
        "final_norm": L.init_layernorm(cfg.d_model, cfg.pdtype, dev),
    }


def _layer(stack, i):
    """Layer ``i`` of a stacked tree, as views."""
    return _tree_map(lambda t: t[i], stack)


def _kv_block(n):
    """The JAX caller's block of keys on the CPU path."""
    return min(1024, max(128, n))


def _enc_layer_fwd(p, cfg, x, positions):
    xn = L.layernorm(p["norm1"], x, cfg.norm_eps)
    q, k, v = L._qkv(p["attn"], cfg, xn, positions)
    o = L.flash_attention(q, k, v, causal=False,
                          kv_block=_kv_block(x.shape[1]))
    x = x + torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"])
    xn = L.layernorm(p["norm2"], x, cfg.norm_eps)
    return x + L.gelu_mlp(p["mlp"], xn)


def encode(params, cfg, frame_embeds):
    """frame_embeds: (B, T, d_model) from the stub frontend."""
    x = frame_embeds.to(cfg.adtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    remat = cfg.remat and recording(x, params)
    for p in unstack(params["enc_layers"], cfg.num_encoder_layers):
        x = (remat_call(_enc_layer_fwd, p, cfg, x, positions) if remat
             else _enc_layer_fwd(p, cfg, x, positions))
    return L.layernorm(params["enc_final_norm"], x, cfg.norm_eps)


def _cross_kv(p, cfg, enc_out):
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["cross_attn"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["cross_attn"]["wv"])
    if cfg.qkv_bias:
        k, v = k + p["cross_attn"]["bk"], v + p["cross_attn"]["bv"]
    return k, v


def _dec_layer_fwd(p, cfg, x, positions, enc_out=None, cross_kv=None,
                   cache=None, decode_pos=None):
    """Decoder layer; full-sequence if ``decode_pos`` is None, else one
    step at absolute positions ``decode_pos`` (B,). With a ``cache``
    (this layer's self {k, v}) a full sequence writes its K/V from slot
    0 and a step writes slot ``decode_pos`` (none past the end), in
    place. Cross K/V are ``cross_kv``, or computed from ``enc_out``."""
    # causal self attention
    xn = L.layernorm(p["norm1"], x, cfg.norm_eps)
    q, k, v = L._qkv(p["self_attn"], cfg, xn, positions)
    if decode_pos is not None:
        W_ = cache["k"].shape[1]
        rows = torch.arange(x.shape[0], device=x.device)
        keep = (decode_pos >= W_)[:, None, None]
        slot = decode_pos.clamp(max=W_ - 1).long()
        for name, new in (("k", k), ("v", v)):
            buf = cache[name]
            buf[rows, slot] = torch.where(keep, buf[rows, slot], new[:, 0])
        lens = torch.clamp(decode_pos + 1, max=W_).to(torch.int32)
        o = L.decode_attention(q, cache["k"], cache["v"], lens)
    else:
        if cache is not None:
            S = k.shape[1]
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
        o = L.flash_attention(q, k, v, causal=True,
                              kv_block=_kv_block(x.shape[1]))
    x = x + torch.einsum("bshk,hkd->bsd", o, p["self_attn"]["wo"])

    # cross attention (no RoPE)
    xn = L.layernorm(p["norm2"], x, cfg.norm_eps)
    qx = torch.einsum("bsd,dhk->bshk", xn, p["cross_attn"]["wq"])
    if cfg.qkv_bias:
        qx = qx + p["cross_attn"]["bq"]
    kx, vx = cross_kv if cross_kv is not None else _cross_kv(p, cfg,
                                                             enc_out)
    o = L.flash_attention(qx, kx, vx, causal=False,
                          kv_block=_kv_block(kx.shape[1]))
    x = x + torch.einsum("bshk,hkd->bsd", o, p["cross_attn"]["wo"])

    xn = L.layernorm(p["norm3"], x, cfg.norm_eps)
    return x + L.gelu_mlp(p["mlp"], xn)


def forward(params, cfg, tokens, frame_embeds):
    """Teacher-forced forward. Returns (logits, aux = 0)."""
    x, aux = forward_features(params, cfg, tokens, frame_embeds)
    return L.unembed(params["embed"], x), aux


def forward_features(params, cfg, tokens, frame_embeds):
    """Forward to the final decoder norm; no unembed matmul."""
    enc_out = encode(params, cfg, frame_embeds)
    x = L.embed(params["embed"], tokens).to(cfg.adtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    remat = cfg.remat and recording(x, params)
    for p in unstack(params["dec_layers"], cfg.num_decoder_layers):
        x = (remat_call(_dec_layer_fwd, p, cfg, x, positions, enc_out)
             if remat else _dec_layer_fwd(p, cfg, x, positions,
                                          enc_out=enc_out))
    x = L.layernorm(params["final_norm"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg, batch, max_len, dev) -> Dict[str, Any]:
    def zeros(length):
        return torch.zeros((cfg.num_decoder_layers, batch, length,
                            cfg.num_kv_heads, cfg.head_dim),
                           dtype=cfg.adtype, device=dev)

    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "self": {"k": zeros(max_len), "v": zeros(max_len)},
            "cross": {"k": zeros(cfg.encoder_seq_len),
                      "v": zeros(cfg.encoder_seq_len)}}


def prefill(params, cfg, tokens, cache, frame_embeds):
    """Encode the frames, write each layer's cross K/V and the prompt's
    self K/V (from slot 0) into ``cache`` in place (the cross buffers
    replaced by ones of the frames' length when that is not the cache's).
    Returns (last-token logits, cache)."""
    if frame_embeds is None:
        raise ValueError("an encoder-decoder prefill needs frame_embeds")
    enc_out = encode(params, cfg, frame_embeds)
    cross = cache["cross"]
    if cross["k"].shape[2] != enc_out.shape[1]:
        # frames other than the config's: the cross cache takes their
        # length, as the JAX prefill's new cache does
        for name in ("k", "v"):
            t = cross[name]
            cross[name] = t.new_zeros(t.shape[:2] + (enc_out.shape[1],)
                                      + t.shape[3:])
    x = L.embed(params["embed"], tokens).to(cfg.adtype)
    S = x.shape[1]
    positions = cache["pos"][:, None] + torch.arange(S, device=x.device)
    for i in range(cfg.num_decoder_layers):
        p_l = _layer(params["dec_layers"], i)
        kx, vx = _cross_kv(p_l, cfg, enc_out)
        cache["cross"]["k"][i].copy_(kx)
        cache["cross"]["v"][i].copy_(vx)
        x = _dec_layer_fwd(p_l, cfg, x, positions, cross_kv=(kx, vx),
                           cache=_layer(cache["self"], i))
    x = L.layernorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x[:, -1:])
    cache["pos"] += S
    return logits[:, 0], cache


def decode_step(params, cfg, tokens, cache):
    """One decode step, cache updated in place. Returns (logits (B,V),
    cache)."""
    pos = cache["pos"]
    x = L.embed(params["embed"], tokens[:, None]).to(cfg.adtype)
    for i in range(cfg.num_decoder_layers):
        cross = _layer(cache["cross"], i)
        x = _dec_layer_fwd(_layer(params["dec_layers"], i), cfg, x,
                           pos[:, None], cross_kv=(cross["k"], cross["v"]),
                           cache=_layer(cache["self"], i), decode_pos=pos)
    x = L.layernorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x)
    cache["pos"] += 1
    return logits[:, 0], cache
