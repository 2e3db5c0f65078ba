"""Model assembly in PyTorch (port of ``repro/models/model.py``).

The param tree keeps the JAX package's layout: ``embed``, ``final_norm``,
``cycles`` (one stacked tree per position of ``cfg.block_pattern``, with
the layer index as the leading axis) and ``tail`` (unstacked remainder
layers). ``lax.scan`` over cycles becomes a Python loop over the stacked
params; each layer reads its slice as a view.

The kinds ``global``, ``local`` (sliding window over a ring-buffer KV
cache, RoPE at ``rope_theta_local`` where set), ``moe``/``moe_dense``
(global attention with a Mixture-of-Experts FFN, whose load-balancing aux
loss ``forward`` returns), ``rglru`` (Griffin recurrent block) and
``rwkv`` (RWKV-6 time-mix and channel-mix) are ported, as are a prefix of
embeddings (llava's patches, ``prefix_embeds``) and, in ``encdec.py``,
the encoder-decoder backbone (whisper), to which the public functions
here hand an ``is_encoder_decoder`` config. The cache — KV buffers and
recurrent states alike — is updated in place (``prefill`` and
``decode_step`` write into the tensors of the cache they are given and
return that cache), which keeps one resident copy of the slot cache; the
JAX functions return a new tree instead.

With ``cfg.remat`` set, ``forward_features`` under autograd runs each of
the JAX model's ``jax.checkpoint(..., nothing_saveable)`` regions under a
non-reentrant ``torch.utils.checkpoint``: the backward recomputes a
region's activations from its input instead of keeping them
(``remat_regions`` gives the JAX granularity). JAX's per-layer scan of a
gemma3-style interleave where no window binds (``_merge_attention_stack``)
has the arithmetic of the loop over kinds here; only its regions differ.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import trace
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import rwkv6 as W
from repro_torch.models.config import ModelConfig

ATTN_KINDS = ("global", "local", "moe", "moe_dense")


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
    if kind in ("moe", "moe_dense"):
        return {
            "norm1": L.init_rmsnorm(d, dt, device),
            "attn": L.init_attention(gen, cfg, device),
            "norm2": L.init_rmsnorm(d, dt, device),
            "moe": M.init_moe(gen, cfg, device),
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


def init_stacked(generator: torch.Generator, init_one: Callable[[], Any],
                 n: int, dev) -> Dict[str, Any]:
    """``n`` layers from ``init_one()`` (which draws from ``generator``)
    stacked on a leading axis: the draws of n calls in order, each
    layer's weights drawn straight into its slice of the stack, so no
    layer is ever held beside the stack. A first pass with meta tensors
    for the draws (the generator's state put back after it) finds the
    leaves and their shapes."""
    calls: List[torch.Tensor] = []

    def probe(shape, dtype):
        calls.append(torch.empty(shape, dtype=dtype, device="meta"))
        return calls[-1]

    state = generator.get_state()
    L.DRAW_TARGET.fn = probe
    try:
        template = init_one()
    finally:
        L.DRAW_TARGET.fn = None
        generator.set_state(state)
    stacked = _tree_map(lambda t: torch.empty((n,) + tuple(t.shape),
                                              dtype=t.dtype, device=dev),
                        template)
    if torch.device(dev).type == "meta":      # shapes only: nothing to draw
        return stacked
    where = {}
    _tree_map(lambda t, s: where.__setitem__(id(t), s), template, stacked)
    dests = [where[id(t)] for t in calls]     # the stack of each draw

    def put(dst, src):
        if src.data_ptr() != dst.data_ptr():
            dst.copy_(src)

    for c in range(n):
        todo = iter(d[c] for d in dests)

        def target(shape, dtype, todo=todo):
            dst = next(todo)
            if tuple(dst.shape) != shape or dst.dtype != dtype:
                raise RuntimeError(f"draw {shape} {dtype} does not match "
                                   f"its slice {tuple(dst.shape)}")
            return dst

        L.DRAW_TARGET.fn = target
        try:
            layer = init_one()
        finally:
            L.DRAW_TARGET.fn = None
        _tree_map(lambda s, x, c=c: put(s[c], x), stacked, layer)
    return stacked


def _layer_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_cycles, n_tail) as ``init_params``/``init_cache`` lay them out."""
    plen = len(cfg.block_pattern)
    n_cycles = cfg.num_layers // plen if cfg.scan_layers else 0
    return n_cycles, cfg.num_layers - n_cycles * plen


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random params drawn on ``device`` from ``generator`` (which must
    draw on that device). Layer by layer, each stacked layer drawn into
    its slice of the stack (``init_stacked``), so the device never holds
    more than the params and one weight's fp32 scratch. On ``meta`` nothing
    is drawn (``param_shapes``)."""
    dev = resolve_device(device)
    if dev.type != "meta" and generator.device.type != dev.type:
        raise ValueError(f"generator draws on {generator.device}, params "
                         f"go to {dev}")
    if cfg.is_encoder_decoder:
        from repro_torch.models import encdec
        return encdec.init_params(generator, cfg, dev)
    kinds = cfg.layer_kinds()
    pat = cfg.block_pattern
    plen = len(pat)
    n_cycles, n_tail = _layer_counts(cfg)

    cycles = [init_stacked(generator, lambda kind=kind: init_layer(
        generator, cfg, kind, dev), n_cycles, dev)
        for kind in pat] if n_cycles else []
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


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_params``' tree as meta tensors: the shapes and dtypes of the
    JAX ``param_shapes``, with nothing drawn or allocated (the dry run's
    templates)."""
    return init_params(torch.Generator(), cfg, device="meta")


def unstack(tree, n: int) -> List[Any]:
    """The ``n`` layers of a stacked tree, as views through one ``unbind``
    a leaf. Under autograd each leaf's gradient is then one stack of the
    layers' gradients, where indexing every layer (``t[c]``) would
    zero-fill and add a whole copy of the stack per layer."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: p[c] for k, p in parts.items()} for c in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [unstack(v, n) for v in tree]
        return [type(tree)(p[c] for p in parts) for c in range(n)]
    return list(tree.unbind(0))


def _layers(cfg, params, cache=None) -> Iterator[Tuple[str, Dict, Dict]]:
    """(kind, layer params, layer cache) in stack order; views, not copies.

    Mirrors ``lax.scan`` over ``cycles`` followed by the unrolled tail.
    """
    cyc_p = params["cycles"]
    cyc_c = cache["cycles"] if cache is not None else [None] * len(cyc_p)
    if cyc_p:
        n = next(iter(cyc_p[0]["norm1"].values())).shape[0]
        per = [unstack(p_pos, n) for p_pos in cyc_p]
        for c in range(n):
            for kind, p_pos, c_pos in zip(cfg.block_pattern, per, cyc_c):
                yield (kind, p_pos[c], None if c_pos is None else
                       _tree_map(lambda t: t[c], c_pos))
    tail_c = cache["tail"] if cache is not None else [None] * len(
        params["tail"])
    tail_kinds = cfg.layer_kinds()[cfg.num_layers - len(params["tail"]):]
    yield from zip(tail_kinds, params["tail"], tail_c)


# ---------------------------------------------------------------------------
# Per-layer apply: full-sequence (prefill / forward) and single-step (decode)
# ---------------------------------------------------------------------------

def _theta(cfg, kind) -> float:
    """RoPE theta of an attention layer (``_attn_common``)."""
    if kind == "local" and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


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


def _ffn(params, cfg, kind, xn):
    """The attention kinds' FFN: (SwiGLU, None), or the MoE FFN and its
    aux loss."""
    if kind in ("moe", "moe_dense"):
        return M.moe_ffn(params["moe"], cfg, xn)
    return L.swiglu(params["ffn"], xn), None


def layer_forward(params, cfg, kind, x, positions, cache=None):
    """Full-sequence layer apply. With a cache, the recurrent kinds start
    from its state and every kind leaves its state (K/V, ``h``/``conv``,
    ``last``/``wkv``) in it, in place. Returns (x, aux loss or None)."""
    if kind in ("rwkv", "rglru"):
        return _recurrent_layer(params, cfg, kind, x, cache), None

    window = cfg.window_size if kind == "local" else 0
    xn = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    q, k, v = L._qkv(params["attn"], cfg, xn, positions,
                     theta=_theta(cfg, kind))
    o = L.flash_attention(q, k, v, causal=True, window=window)
    x = x + torch.einsum("bshk,hkd->bsd", o, params["attn"]["wo"])
    h, aux = _ffn(params, cfg, kind, L.rmsnorm(params["norm2"], x,
                                               cfg.norm_eps))
    if cache is not None:
        _write_kv_prefill(cache, kind, k, v)
    return x + h, aux


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
    q, k, v = L._qkv(params["attn"], cfg, xn, pos[:, None],
                     theta=_theta(cfg, kind))
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
    h, _ = _ffn(params, cfg, kind, L.rmsnorm(params["norm2"], x,
                                             cfg.norm_eps))
    return x + h


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
    dev = resolve_device(device)
    if cfg.is_encoder_decoder:
        from repro_torch.models import encdec
        return encdec.init_cache(cfg, batch, max_len, dev)
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

def _embed_inputs(params, cfg, tokens, prefix_embeds=None):
    """Token embeddings (scaled where the config says), after a prefix of
    given embeddings (llava's patches) in the activation dtype."""
    x = L.embed(params["embed"], tokens).to(cfg.adtype)
    if cfg.scale_embedding:
        x = x * math.sqrt(cfg.d_model)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.adtype), x], dim=1)
    return x


def _final_norm(params, cfg, x):
    norm = L.layernorm if "rwkv" in cfg.block_pattern else L.rmsnorm
    return norm(params["final_norm"], x, cfg.norm_eps)


def unembed_table(params):
    return params.get("unembed", params["embed"])


def _unembed(params, cfg, x):
    return L.unembed(unembed_table(params), _final_norm(params, cfg, x),
                     cfg.logit_softcap)


def forward(params, cfg: ModelConfig, tokens, prefix_embeds=None):
    """Full-sequence forward from zero state. Returns (logits, aux_loss)
    as JAX does: aux is the sum of the MoE layers' load-balancing losses
    (0 without MoE layers). ``prefix_embeds`` (B, P, d) go before the
    tokens (an encoder-decoder model's frame embeddings instead), and the
    logits cover them too."""
    if cfg.is_encoder_decoder:
        from repro_torch.models import encdec
        return encdec.forward(params, cfg, tokens, prefix_embeds)
    x, aux = forward_features(params, cfg, tokens, prefix_embeds)
    return L.unembed(unembed_table(params), x, cfg.logit_softcap), aux


def forward_features(params, cfg: ModelConfig, tokens, prefix_embeds=None):
    """``forward`` up to and including the final norm; no unembed."""
    if cfg.is_encoder_decoder:
        from repro_torch.models import encdec
        return encdec.forward_features(params, cfg, tokens, prefix_embeds)
    x = _embed_inputs(params, cfg, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and recording(x, params)
    for group, region in remat_regions(cfg, params, x.shape[1]):
        if remat and region:
            x, aux = remat_call(_layer_group, cfg, group, x, aux, positions)
        else:
            x, aux = _layer_group(cfg, group, x, aux, positions)
    return _final_norm(params, cfg, x), aux


def recording(x, params) -> bool:
    """Whether autograd records a forward of ``params`` on ``x``: grad
    mode on and ``x`` or a param leaf requiring grad. ``x`` comes from
    the embedding, so the leaves are walked only when that table is not
    trained."""
    if not torch.is_grad_enabled():
        return False
    if x.requires_grad:
        return True
    flags = []
    _tree_map(lambda t: flags.append(t.requires_grad), params)
    return any(flags)


def remat_call(fn, *args):
    """``fn(*args)`` as one remat region: its activations are dropped
    after the forward and recomputed by the backward, as
    ``jax.checkpoint(fn, policy=nothing_saveable)``. The models draw no
    random numbers in a forward, so no RNG state is saved per region
    (``preserve_rng_state=False``)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _uniform_attention(cfg) -> bool:
    """Every kind of a pattern of more than one is plain attention (JAX's
    ``_uniform_attention``)."""
    return (len(cfg.block_pattern) > 1 and
            all(k in ("local", "global") for k in cfg.block_pattern))


def remat_regions(cfg, params, seq_len: int
                  ) -> List[Tuple[List[Tuple[str, Dict]], bool]]:
    """``_layers`` in stack order as the JAX model's remat regions: (a
    list of (kind, layer params), whether it is checkpointed). A uniform
    attention stack where no window binds at ``seq_len`` (JAX's merged
    per-layer scan) has one region a layer, its tail's included; every
    other stack one a ``block_pattern`` cycle, with each tail layer
    alone and not checkpointed (JAX's ``_stack_body`` under the scan,
    then the unrolled tail)."""
    layers = [(kind, p_l) for kind, p_l, _ in _layers(cfg, params)]
    binds = "local" in cfg.block_pattern and cfg.window_size < seq_len
    if params["cycles"] and _uniform_attention(cfg) and not binds:
        return [([layer], True) for layer in layers]
    n_cyc = len(layers) - len(params["tail"])
    plen = len(cfg.block_pattern)
    return ([(layers[i:i + plen], True) for i in range(0, n_cyc, plen)]
            + [([layer], False) for layer in layers[n_cyc:]])


def _layer_group(cfg, group, x, aux, positions):
    """``layer_forward`` over ``group``'s layers; the MoE aux losses added
    to ``aux``, as JAX's scan carries them."""
    for kind, p_l in group:
        x, a = layer_forward(p_l, cfg, kind, x, positions)
        if a is not None:
            aux = aux + a
    return x, aux


def prefill(params, cfg: ModelConfig, tokens, cache, prefix_embeds=None):
    """Process a prompt, fill the cache in place. Returns (last-token
    logits, cache). Attends only over the new K/V and writes them from
    cache slot 0 (a fresh cache, as the engine uses it); the recurrent
    kinds start from the state the cache holds, as in the JAX model.
    ``prefix_embeds`` (B, P, d) go before the tokens and count in
    ``pos``; an encoder-decoder model takes its frame embeddings there.
    Traced as ``model.prefill`` (``S``: the tokens' length, ``cfg``)."""
    with trace.span("model.prefill", S=int(tokens.shape[1]),
                    cfg=cfg) if trace.ON else trace.OFF:
        if cfg.is_encoder_decoder:
            from repro_torch.models import encdec
            return encdec.prefill(params, cfg, tokens, cache, prefix_embeds)
        x = _embed_inputs(params, cfg, tokens, prefix_embeds)
        S = x.shape[1]
        positions = cache["pos"][:, None] + torch.arange(S, device=x.device)
        for kind, p_l, c_l in _layers(cfg, params, cache):
            x, _ = layer_forward(p_l, cfg, kind, x, positions, cache=c_l)
        logits = _unembed(params, cfg, x[:, -1:])
        cache["pos"] += S
        return logits[:, 0], cache


def decode_step(params, cfg: ModelConfig, tokens, cache):
    """One decode step, cache updated in place. tokens: (B,) int.
    Returns (logits (B,V), cache). Traced as ``model.decode_step``
    (``B``, ``cfg``)."""
    with trace.span("model.decode_step", B=int(tokens.shape[0]),
                    cfg=cfg) if trace.ON else trace.OFF:
        if cfg.is_encoder_decoder:
            from repro_torch.models import encdec
            return encdec.decode_step(params, cfg, tokens, cache)
        pos = cache["pos"]
        x = _embed_inputs(params, cfg, tokens[:, None])
        for kind, p_l, c_l in _layers(cfg, params, cache):
            x = layer_decode(p_l, cfg, kind, x, pos, c_l)
        logits = _unembed(params, cfg, x)
        cache["pos"] += 1
        return logits[:, 0], cache


# -- per-slot cache views (serving engine continuous batching) -------------

_STACKED_KEYS = ("cycles", "self", "cross")   # leading dim = layer stack


def _batch_axis(key: str) -> int:
    return 1 if key in _STACKED_KEYS else 0


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
