"""Model assembly in PyTorch (port of ``repro/models/model.py``).

The param tree keeps the JAX package's layout: ``embed``, ``final_norm``,
``cycles`` (one stacked tree per position of ``cfg.block_pattern``, with
the layer index as the leading axis) and ``tail`` (unstacked remainder
layers). ``lax.scan`` over cycles becomes a Python loop over the stacked
params; each layer reads its slice as a view.

The kinds ``global``, ``local`` (sliding window over a ring-buffer KV
cache), ``rglru`` (Griffin recurrent block) and ``rwkv`` (RWKV-6 time-mix
and channel-mix) are ported. The cache — KV buffers and recurrent states
alike — is updated in place (``prefill`` and ``decode_step`` write into
the tensors of the cache they are given and return that cache), which
keeps one resident copy of the slot cache; the JAX functions return a new
tree instead.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import rwkv6 as W
from repro_torch.models.config import ModelConfig

KINDS = ("global", "local", "rglru", "rwkv")

# ROADMAP items that bring the layer kinds and features not ported yet
_PENDING_KINDS = {
    "moe": "Queue 1, MoE",
    "moe_dense": "Queue 1, MoE",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not serve yet."""
    for kind in cfg.block_pattern:
        if kind not in KINDS:
            raise NotImplementedError(
                f"layer kind {kind!r} is not ported yet; see ROADMAP.md "
                f"{_PENDING_KINDS[kind]}")
    if cfg.qk_norm:
        raise NotImplementedError(
            "qk_norm is not ported yet; see ROADMAP.md Queue 1, qwen3-32b")
    if cfg.is_encoder_decoder or cfg.num_patch_tokens:
        raise NotImplementedError(
            "encoder-decoder and patch-prefix models are not ported yet; "
            "see ROADMAP.md Queue 1, remaining archs")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_layer(gen, cfg: ModelConfig, kind: str, device) -> Dict[str, Any]:
    dt = cfg.pdtype
    d = cfg.d_model
    if kind in ("global", "local"):
        return {
            "norm1": L.init_rmsnorm(d, dt, device),
            "attn": L.init_attention(gen, cfg, device),
            "norm2": L.init_rmsnorm(d, dt, device),
            "ffn": L.init_swiglu(gen, d, cfg.d_ff, dt, device),
        }
    if kind == "rglru":
        return {
            "norm1": L.init_rmsnorm(d, dt, device),
            "rec": R.init_rglru(gen, cfg, device),
            "norm2": L.init_rmsnorm(d, dt, device),
            "ffn": L.init_swiglu(gen, d, cfg.d_ff, dt, device),
        }
    if kind == "rwkv":
        return {
            "norm1": L.init_layernorm(d, dt, device),
            "tm": W.init_time_mix(gen, cfg, device),
            "norm2": L.init_layernorm(d, dt, device),
            "cm": W.init_channel_mix(gen, cfg, device),
        }
    raise NotImplementedError(kind)


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _tree_stack(trees):
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


def _layer_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_cycles, n_tail) as ``init_params``/``init_cache`` lay them out."""
    plen = len(cfg.block_pattern)
    n_cycles = cfg.num_layers // plen if cfg.scan_layers else 0
    return n_cycles, cfg.num_layers - n_cycles * plen


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random params drawn on ``device`` from ``generator`` (which must
    draw on that device). Layer by layer, so a stacked cycle never needs
    more than one layer of fp32 scratch."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator draws on {generator.device}, params "
                         f"go to {dev}")
    kinds = cfg.layer_kinds()
    pat = cfg.block_pattern
    plen = len(pat)
    n_cycles, n_tail = _layer_counts(cfg)

    cycles = []
    if n_cycles:
        for pos in range(plen):
            first = init_layer(generator, cfg, pat[pos], dev)
            stacked = _tree_map(
                lambda t: torch.empty((n_cycles,) + tuple(t.shape),
                                      dtype=t.dtype, device=dev), first)
            _tree_map(lambda dst, src: dst[0].copy_(src), stacked, first)
            for c in range(1, n_cycles):
                layer = init_layer(generator, cfg, pat[pos], dev)
                _tree_map(lambda dst, src, c=c: dst[c].copy_(src),
                          stacked, layer)
            cycles.append(stacked)
    tail = [init_layer(generator, cfg, kinds[i], dev)
            for i in range(cfg.num_layers - n_tail, cfg.num_layers)]
    p = {
        "embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                  cfg.pdtype, dev),
        "final_norm": (L.init_layernorm if "rwkv" in pat else
                       L.init_rmsnorm)(cfg.d_model, cfg.pdtype, dev),
        "cycles": cycles,
        "tail": tail,
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.init_embedding(generator, cfg.vocab_size,
                                        cfg.d_model, cfg.pdtype, dev)
    return p


def _layers(cfg, params, cache=None) -> Iterator[Tuple[str, Dict, Dict]]:
    """(kind, layer params, layer cache) in stack order; views, not copies.

    Mirrors ``lax.scan`` over ``cycles`` followed by the unrolled tail.
    """
    cyc_p = params["cycles"]
    cyc_c = cache["cycles"] if cache is not None else [None] * len(cyc_p)
    if cyc_p:
        n = next(iter(cyc_p[0]["norm1"].values())).shape[0]
        for c in range(n):
            for kind, p_pos, c_pos in zip(cfg.block_pattern, cyc_p, cyc_c):
                yield (kind, _tree_map(lambda t: t[c], p_pos),
                       None if c_pos is None else
                       _tree_map(lambda t: t[c], c_pos))
    tail_c = cache["tail"] if cache is not None else [None] * len(
        params["tail"])
    tail_kinds = cfg.layer_kinds()[cfg.num_layers - len(params["tail"]):]
    yield from zip(tail_kinds, params["tail"], tail_c)


# ---------------------------------------------------------------------------
# Per-layer apply: full-sequence (prefill / forward) and single-step (decode)
# ---------------------------------------------------------------------------

def _recurrent_layer(params, cfg, kind, x, state):
    """An ``rwkv`` or ``rglru`` layer over S >= 1 tokens, from ``state``
    (updated in place) or from zeros when it is None. Returns x."""
    if kind == "rwkv":
        h, _ = W.time_mix(params["tm"], cfg,
                          L.layernorm(params["norm1"], x, cfg.norm_eps),
                          None if state is None else state["tm"])
        x = x + h
        h, _ = W.channel_mix(params["cm"], cfg,
                             L.layernorm(params["norm2"], x, cfg.norm_eps),
                             None if state is None else state["cm"])
        return x + h
    h, _ = R.recurrent_block(params["rec"], cfg,
                             L.rmsnorm(params["norm1"], x, cfg.norm_eps),
                             state)
    x = x + h
    return x + L.swiglu(params["ffn"],
                        L.rmsnorm(params["norm2"], x, cfg.norm_eps))


def layer_forward(params, cfg, kind, x, positions, cache=None):
    """Full-sequence layer apply. With a cache, the recurrent kinds start
    from its state and every kind leaves its state (K/V, ``h``/``conv``,
    ``last``/``wkv``) in it, in place. Returns x."""
    if kind in ("rwkv", "rglru"):
        return _recurrent_layer(params, cfg, kind, x, cache)

    window = cfg.window_size if kind == "local" else 0
    xn = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    q, k, v = L._qkv(params["attn"], cfg, xn, positions)
    o = L.flash_attention(q, k, v, causal=True, window=window)
    x = x + torch.einsum("bshk,hkd->bsd", o, params["attn"]["wo"])
    xn = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    x = x + L.swiglu(params["ffn"], xn)
    if cache is not None:
        _write_kv_prefill(cache, kind, k, v)
    return x


def _kv_cache_len(cfg, kind, max_len):
    return min(cfg.window_size, max_len) if kind == "local" else max_len


def _write_kv_prefill(cache, kind, k, v):
    """Write prefill K/V into the cache from slot 0, or, for a ``local``
    prompt longer than its ring buffer, the last W tokens at slots t % W."""
    S = k.shape[1]
    W_ = cache["k"].shape[1]
    if kind == "local" and S > W_:
        slots = torch.arange(S - W_, S, device=k.device) % W_
        cache["k"][:, slots] = k[:, S - W_:]
        cache["v"][:, slots] = v[:, S - W_:]
    else:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v


def layer_decode(params, cfg, kind, x, pos, cache):
    """Single-token layer apply. x: (B,1,d); pos: (B,) absolute position.
    Updates ``cache`` in place (an attention kind writes this step's K/V
    before attending)."""
    if kind in ("rwkv", "rglru"):
        return _recurrent_layer(params, cfg, kind, x, cache)

    xn = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    q, k, v = L._qkv(params["attn"], cfg, xn, pos[:, None])
    W_ = cache["k"].shape[1]
    # as the one-hot select of the JAX model: the ring slot pos % W for
    # ``local``, position pos for ``global`` (no write past the end)
    slot = pos % W_ if kind == "local" else pos
    rows = torch.arange(x.shape[0], device=x.device)
    keep = (slot >= W_)[:, None, None]
    slot = slot.clamp(max=W_ - 1).long()
    for name, new in (("k", k), ("v", v)):
        buf = cache[name]
        buf[rows, slot] = torch.where(keep, buf[rows, slot], new[:, 0])
    filled = torch.clamp(pos + 1, max=W_).to(torch.int32)
    o = L.decode_attention(q, cache["k"], cache["v"], filled)
    x = x + torch.einsum("bshk,hkd->bsd", o, params["attn"]["wo"])
    xn = L.rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + L.swiglu(params["ffn"], xn)


# ---------------------------------------------------------------------------
# Cache allocation
# ---------------------------------------------------------------------------

def init_layer_cache(cfg, kind, batch, max_len, device):
    if kind == "rwkv":
        return W.init_rwkv_state(cfg, batch, device)
    if kind == "rglru":
        return R.init_rglru_state(cfg, batch, cfg.adtype, device)
    shape = (batch, _kv_cache_len(cfg, kind, max_len), cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    check_supported(cfg)
    dev = resolve_device(device)
    n_cycles, n_tail = _layer_counts(cfg)
    cycles = []
    if n_cycles:
        for kind in cfg.block_pattern:
            one = init_layer_cache(cfg, kind, batch, max_len, dev)
            cycles.append(_tree_map(
                lambda t: torch.zeros((n_cycles,) + tuple(t.shape),
                                      dtype=t.dtype, device=dev), one))
    tail = [init_layer_cache(cfg, kind, batch, max_len, dev)
            for kind in cfg.layer_kinds()[cfg.num_layers - n_tail:]]
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "cycles": cycles, "tail": tail}


# ---------------------------------------------------------------------------
# Whole-model forward / prefill / decode
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg, tokens):
    x = L.embed(params["embed"], tokens).to(cfg.adtype)
    if cfg.scale_embedding:
        x = x * math.sqrt(cfg.d_model)
    return x


def _unembed(params, cfg, x):
    norm = L.layernorm if "rwkv" in cfg.block_pattern else L.rmsnorm
    x = norm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params.get("unembed", params["embed"]), x,
                     cfg.logit_softcap)


def forward(params, cfg: ModelConfig, tokens):
    """Full-sequence forward from zero state. Returns (logits, aux_loss)
    as JAX does; aux is 0 for the ported kinds."""
    check_supported(cfg)
    x = _embed_inputs(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for kind, p_l, _ in _layers(cfg, params):
        x = layer_forward(p_l, cfg, kind, x, positions)
    return _unembed(params, cfg, x), torch.zeros((), device=x.device)


def prefill(params, cfg: ModelConfig, tokens, cache):
    """Process a prompt, fill the cache in place. Returns (last-token
    logits, cache). Attends only over the new K/V and writes them from
    cache slot 0 (a fresh cache, as the engine uses it); the recurrent
    kinds start from the state the cache holds, as in the JAX model."""
    check_supported(cfg)
    x = _embed_inputs(params, cfg, tokens)
    S = x.shape[1]
    positions = cache["pos"][:, None] + torch.arange(S, device=x.device)
    for kind, p_l, c_l in _layers(cfg, params, cache):
        x = layer_forward(p_l, cfg, kind, x, positions, cache=c_l)
    logits = _unembed(params, cfg, x[:, -1:])
    cache["pos"] += S
    return logits[:, 0], cache


def decode_step(params, cfg: ModelConfig, tokens, cache):
    """One decode step, cache updated in place. tokens: (B,) int.
    Returns (logits (B,V), cache)."""
    check_supported(cfg)
    pos = cache["pos"]
    x = _embed_inputs(params, cfg, tokens[:, None])
    for kind, p_l, c_l in _layers(cfg, params, cache):
        x = layer_decode(p_l, cfg, kind, x, pos, c_l)
    logits = _unembed(params, cfg, x)
    cache["pos"] += 1
    return logits[:, 0], cache


# -- per-slot cache views (serving engine continuous batching) -------------

def _batch_axis(key: str) -> int:
    return 1 if key == "cycles" else 0     # stacked caches lead with layers


def cache_take_slot(cache: Dict[str, Any], slot: int) -> Dict[str, Any]:
    """Length-1 batch view of one slot of a decode cache. The tensors are
    views: writes through them land in ``cache``."""
    return {k: _tree_map(lambda t, ax=_batch_axis(k): t.narrow(ax, slot, 1),
                         v) for k, v in cache.items()}


def cache_zero(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Zero every leaf of a cache or slot view in place (KV buffers,
    recurrent states and ``pos``)."""
    _tree_map(lambda t: t.zero_(), tree)
    return tree


def cache_put_slot(cache: Dict[str, Any], slot: int,
                   sub: Dict[str, Any]) -> Dict[str, Any]:
    """Write a length-1 batch view back into slot ``slot`` (a no-op for
    the leaves that are still views of ``cache``)."""
    def put(full, part, ax):
        dst = full.narrow(ax, slot, 1)
        if part.data_ptr() != dst.data_ptr():
            dst.copy_(part)
    for k, v in cache.items():
        _tree_map(lambda f, p, ax=_batch_axis(k): put(f, p, ax), v, sub[k])
    return cache


def param_count(params) -> int:
    total: List[int] = []
    _tree_map(lambda t: total.append(t.numel()), params)
    return sum(total)
