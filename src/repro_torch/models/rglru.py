"""RG-LRU recurrent block in PyTorch (port of ``repro/models/rglru.py``;
Griffin / RecurrentGemma, arXiv:2402.19427).

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    a_t = exp(-c * softplus(Lambda) * r_t),  r_t, i_t block-diag sigmoid gates

The two block-diagonal gate products are PyTorch einsums; the elementwise
tail of the gates and the scan over the sequence go through K3's gated
route ``kernels.rglru_scan.ops.rglru_gated_scan`` (one kernel on a CUDA
tensor, a and b never in memory; ``_gates`` followed by the sequential
scan on a CPU tensor), for the prefill and the decode step alike; on a
CUDA tensor that autograd records, through ``RGLRUGatedScanFn`` (the same
kernel, then K3's backward kernel). On a meta tensor (the dry run's
trace: shapes only) it runs the gated route's chunked algorithm in plain
form, ``_gates`` then ``rglru_scan_chunked_ref``, whose loops are over a
chunk's steps and the chunks rather than over every step. A state
passed in is updated in place (``h`` by the scan itself, ``conv`` by a
copy) and returned; the JAX functions return a new state instead.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rglru_scan.ref import (RGLRU_C, rglru_gates_ref,
                                                rglru_scan_chunked_ref)
from repro_torch.models.layers import _he


def init_rglru(gen, cfg, device, dtype=None):
    dtype = dtype or cfg.pdtype
    d = cfg.d_model
    w = cfg.rnn_width or d
    nb = cfg.rnn_blocks
    if w % nb:
        raise ValueError(f"rnn_width {w} is not a multiple of rnn_blocks "
                         f"{nb}")
    # Lambda init so that a in [0.9, 0.999] at r=1 (Griffin appendix).
    lam_min, lam_max = 0.9, 0.999
    u = torch.rand((w,), generator=gen, device=device, dtype=torch.float32)
    a_init = lam_min + u * (lam_max - lam_min)
    # a = exp(-c*softplus(L)) => softplus(L) = -log(a)/c
    sp = -torch.log(a_init) / RGLRU_C
    width = cfg.conv1d_width
    return {
        "w_x": _he(gen, (d, w), 1 / math.sqrt(d), dtype, device),
        "w_gate_rec": _he(gen, (d, w), 1 / math.sqrt(d), dtype, device),
        "conv_w": _he(gen, (width, w), 1 / math.sqrt(width), dtype, device),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "gate_a": _he(gen, (nb, w // nb, w // nb), 1 / math.sqrt(w // nb),
                      dtype, device),
        "gate_x": _he(gen, (nb, w // nb, w // nb), 1 / math.sqrt(w // nb),
                      dtype, device),
        "log_lambda": torch.log(torch.expm1(sp)),           # stays fp32
        "w_out_rec": _he(gen, (w, d), 1 / math.sqrt(w), dtype, device),
    }


def _block_gate(weight, x, nb):
    """Block-diagonal linear: x (B,S,w) -> (B,S,w)."""
    B, S, w = x.shape
    xb = x.reshape(B, S, nb, w // nb)
    return torch.einsum("bsnw,nwv->bsnv", xb, weight).reshape(B, S, w)


def _gate_products(params, cfg, xb):
    """The block-diagonal gate products (r's and i's pre-activations)."""
    nb = cfg.rnn_blocks
    return (_block_gate(params["gate_a"], xb, nb),
            _block_gate(params["gate_x"], xb, nb))


def _gates(params, cfg, xb):
    """The scan's decays a and inputs b (B,S,w) fp32."""
    return rglru_gates_ref(*_gate_products(params, cfg, xb), xb,
                           params["log_lambda"])


def rglru_scan(params, cfg, xb, h0=None, *, h_last=None):
    """Scan over the sequence. xb: (B, S, w) post-conv input; h0: (B, w)
    fp32 or None (zeros). ``h_last`` receives the last state when given.

    Returns (h (B,S,w) fp32, h_last (B,w) fp32).
    """
    ga, gx = _gate_products(params, cfg, xb)
    lam = params["log_lambda"]
    if h0 is None:
        h0 = torch.zeros((xb.shape[0], xb.shape[2]), dtype=torch.float32,
                         device=xb.device)
    if xb.is_cuda and torch.is_grad_enabled() and any(
            t.requires_grad for t in (ga, gx, xb, lam, h0)):
        # a train step: K3's forward, then its backward kernel; it passes
        # no state to update in place
        if h_last is not None:
            raise ValueError("under autograd the scan updates no state in "
                             "place")
        return rglru_ops.RGLRUGatedScanFn.apply(ga, gx, xb, lam, h0)
    if xb.device.type == "meta":
        h, last = rglru_scan_chunked_ref(*rglru_gates_ref(ga, gx, xb, lam),
                                         h0)
        return h, (last if h_last is None else h_last.copy_(last))
    return rglru_ops.rglru_gated_scan(ga, gx, xb, lam, h0, h_last=h_last)


def causal_conv1d(params, x, tail=None):
    """Depthwise causal conv. x: (B,S,w); tail: (B,width-1,w) history or None.

    Returns (y (B,S,w), new_tail (B,width-1,w)).
    """
    w = params["conv_w"]                   # (width, w)
    width = w.shape[0]
    S = x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(width))
    new_tail = xp[:, S:S + width - 1] if width > 1 else tail
    return y + params["conv_b"], new_tail


def recurrent_block(params, cfg, x, state=None):
    """Full Griffin recurrent block.

    x: (B, S, d). state: None or {"h": (B,w) fp32, "conv": (B,width-1,w)},
    updated in place. Returns (out (B,S,d), state).
    """
    xb = torch.einsum("bsd,dw->bsw", x, params["w_x"])
    gate = torch.einsum("bsd,dw->bsw", x, params["w_gate_rec"])
    xb, new_tail = causal_conv1d(params, xb,
                                 None if state is None else state["conv"])
    if state is None:
        h, h_last = rglru_scan(params, cfg, xb)
        state = {"h": h_last, "conv": new_tail}
    else:
        h, _ = rglru_scan(params, cfg, xb, state["h"], h_last=state["h"])
        state["conv"].copy_(new_tail)
    y = h.to(x.dtype) * F.gelu(gate.float(), approximate="tanh").to(x.dtype)
    out = torch.einsum("bsw,wd->bsd", y, params["w_out_rec"])
    return out, state


def init_rglru_state(cfg, batch, dtype, device):
    w = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype,
                            device=device),
    }
