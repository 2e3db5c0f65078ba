"""Mixture-of-Experts FFN in PyTorch (port of ``repro/models/moe.py``):
top-k routing with capacity-bucketed dispatch.

The dispatch is the JAX package's, step for step, so the two drop the
same token-slots: a stable sort of the (token, choice) slots by expert,
an (E, C) slot grid that keeps each expert's first C slots in sorted
order (the rest are dropped), the token id T as the fill of an empty
slot (it gathers a zero row), one batched product per expert weight
stack, and a gather back with the gate weights. ``logical_constraint``
is left out: it only places shards, and the port runs on one device.

Used by qwen3-moe-30b-a3b (128 experts, top-8).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _he, init_swiglu, swiglu


def init_moe(gen, cfg, device, dtype=None):
    dtype = dtype or cfg.pdtype
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": _he(gen, (d, E), 1 / math.sqrt(d), torch.float32, device),
        "we_gate": _he(gen, (E, d, ff), 1 / math.sqrt(d), dtype, device),
        "we_up": _he(gen, (E, d, ff), 1 / math.sqrt(d), dtype, device),
        "we_down": _he(gen, (E, ff, d), 1 / math.sqrt(ff), dtype, device),
    }
    if cfg.dense_residual_d_ff:
        p["dense"] = init_swiglu(gen, d, cfg.dense_residual_d_ff, dtype,
                                 device)
    return p


def _capacity(tokens: int, cfg) -> int:
    c = int(math.ceil(tokens * cfg.top_k / cfg.num_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8, as the JAX package


def _route(params, cfg, xt):
    """Router softmax over experts, top-k, renormalized gates."""
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)   # (T, E)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)              # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def _gather_rows(table, index):
    """``jnp.take(table, index, axis=0, mode="fill", fill_value=0)`` for
    indices in [0, len(table)]: index len(table) gives a zero row."""
    pad = torch.zeros((1,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    return torch.cat([table, pad])[index]


def dispatch(idx, E: int, C: int):
    """The slot grid of a top-k routing ``idx`` (T, k).

    Returns (slot_tok (E, C): the source token of each expert slot, T
    where empty; slot_of (T*k,): the flat slot e * C + pos of each
    (token, choice), E * C where it was dropped).

    Every shape is fixed by (T, k, E, C) and nothing is read back to the
    host (no ``bincount``, no boolean index), so a decode step with MoE
    layers can be captured in a CUDA graph."""
    T, k = idx.shape
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros((E,), dtype=torch.long, device=idx.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=idx.device) - starts[sorted_e]
    tok = order // k
    keep = pos < C
    # a dropped slot writes to a spare column C, cut off after
    slot_tok = torch.full((E, C + 1), T, dtype=torch.long, device=idx.device)
    slot_tok[sorted_e, torch.where(keep, pos, C)] = tok
    slot_tok = slot_tok[:, :C]
    slot_of = torch.full((T * k,), E * C, dtype=torch.long,
                         device=idx.device)
    slot_of[order] = torch.where(keep, sorted_e * C + pos,
                                 torch.full_like(pos, E * C))
    return slot_tok, slot_of


def moe_ffn(params, cfg, x):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar fp32)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    C = _capacity(T, cfg)
    xt = x.reshape(T, d)
    probs, gate, idx = _route(params, cfg, xt)

    # Switch-style load-balancing aux loss
    me = probs.mean(0)                                        # (E,)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, idx.reshape(-1),
        torch.full((T * k,), 1.0 / (T * k), dtype=torch.float32,
                   device=x.device))
    aux = E * torch.sum(me * ce)

    # dispatch: token ids into the (E, C) slot grid, then a row gather
    slot_tok, slot_of = dispatch(idx, E, C)
    buf = _gather_rows(xt, slot_tok.reshape(-1)).reshape(E, C, d)

    # expert computation (batched SwiGLU)
    g = torch.bmm(buf, params["we_gate"])
    u = torch.bmm(buf, params["we_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    eo = torch.bmm(h, params["we_down"])                      # (E, C, d)

    # combine: each (token, choice) reads its slot's row, gate-weighted
    slot_out = _gather_rows(eo.reshape(E * C, d), slot_of)   # (T*k, d)
    w = gate.reshape(-1).to(x.dtype)[:, None]
    y = (slot_out * w).reshape(T, k, d).sum(dim=1).reshape(B, S, d)
    if "dense" in params:
        y = y + swiglu(params["dense"], x)
    return y, aux


def moe_ffn_dense_ref(params, cfg, x):
    """O(T*E) oracle: every expert on every token, exact top-k combine
    (no capacity drops)."""
    B, S, d = x.shape
    E = cfg.num_experts
    xt = x.reshape(-1, d)
    _, gate, idx = _route(params, cfg, xt)
    g = torch.einsum("td,edf->etf", xt, params["we_gate"])
    u = torch.einsum("td,edf->etf", xt, params["we_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    eo = torch.einsum("etf,efd->etd", h, params["we_down"])  # (E, T, d)
    onehot = F.one_hot(idx, E).float()                        # (T, k, E)
    w = (onehot * gate[..., None]).sum(1)                     # (T, E)
    y = torch.einsum("te,etd->td", w.to(x.dtype), eo).reshape(B, S, d)
    if "dense" in params:
        y = y + swiglu(params["dense"], x)
    return y
