"""Wrappers of the prefill flash attention kernel (``csrc/flash_attention.cu``)
and of its backward (``csrc/flash_attention_bwd.cu``).

Take the model's (B, S, H, hd) layout. A CUDA tensor launches the kernel
on the current stream (no synchronize); a CPU tensor runs the plain
version in ``ref.py``. There is no fallback from one to the other.

``FlashAttentionFn`` is the differentiable call: its forward launches K1
and keeps each row's log-sum-exp, its backward launches the backward
kernels. ``plan_bwd`` decides, from the shapes and the card's SM count
alone, whether the dK/dV pass splits each GQA group across blocks (fp32
partials in a scratch this wrapper allocates, summed in a fixed order),
so two runs on one card are bit-equal. ``LAUNCHES`` counts K1's forward
launches, ``BWD_LAUNCHES`` the backward's (one a call, whatever the
number of kernels).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from repro_torch import trace
from repro_torch.kernels import _build
from repro_torch.kernels._build import sm_count
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = _build.DTYPE_CODES

# kernel launches since the last reset, forward and backward; read and
# reset by chip_smoke.py
LAUNCHES = 0
BWD_LAUNCHES = 0
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load(NAME)
    fn = lib.faillite_flash_attention
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = ([_P] * 5 + [_I] * 7 + [_L] * 12 + [_I, _I, _P])
    return fn


def _lib_bwd():
    lib = _build.load(BWD_NAME)
    fn = lib.faillite_flash_attention_bwd
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = ([_P] * 10 + [_I] * 7 + [_P, _I, _I, _P, _P])
    return fn


class BwdPlan(NamedTuple):
    """The backward's launch plan: ``bk`` keys a dK/dV block; ``split``:
    one dK/dV block per (query head, key tile), writing fp32 partials
    into ``scratch_bytes`` of scratch that a second kernel sums over each
    GQA group, else one block per (KV head, key tile) that walks its
    group's heads; ``blocks`` the dK/dV grid's size."""
    bk: int
    split: bool
    blocks: int
    scratch_bytes: int


def plan_bwd(B, H, KVH, Sq, Skv, hd, n_sm):
    """The backward's launch plan for these shapes on a card of ``n_sm``
    SMs. Splits the GQA group exactly when the group has more than one
    head and the unsplit grid, B x KVH x ceil(Skv / bk) blocks, is under
    1.5 blocks an SM; the scratch is the partial dK and dV, (B, Skv, H,
    hd) fp32 each. The dK/dV grid walks key tiles, so Sq does not enter.
    Depends on these numbers only, never on data.

    The kernel runs one block an SM. Below 1.5 waves the unsplit grid
    leaves SMs idle, and its longest blocks (the first key tiles under a
    causal mask, each walking G heads) set the time; the split's G
    times more blocks, longest first, even that out for the price of the
    partials' round trip and the reduction. On an H100 (132 SMs; both
    plans timed by chip_smoke.py's phase 8 (a)) the split is faster up
    to 192 unsplit blocks in bf16 and 224 in f32, and 2-8% slower from
    224 in bf16 and 256 in f32."""
    # the kernel's key tile (``Cfg::BK`` in csrc/flash_attention_bwd.cu):
    # four row groups of 16 keys, fewer where a head of 256 takes two
    # warps' columns
    bk = 16 * 4 // (hd // min(hd, 128))
    tiles = -(-Skv // bk)
    split = H > KVH and 2 * B * KVH * tiles < 3 * n_sm
    if not split:
        return BwdPlan(bk, False, B * KVH * tiles, 0)
    return BwdPlan(bk, True, B * H * tiles, 2 * B * Skv * H * hd * 4)


def _check(q, k, v, window, *, o=None, do=None, lse=None):
    """Shapes, devices and dtypes of a forward call, and with ``o``,
    ``do`` and ``lse`` of a backward call; raises before any launch."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,S,H,hd), k/v (B,S,KVH,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, _, KVH, hdk = k.shape
    if Bk != B or hdk != hd or KVH == 0 or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form GQA attention")
    for name, t in (("o", o), ("do", do)):
        if t is not None and t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}; "
                             f"got {tuple(t.shape)}")
    if lse is not None:
        if tuple(lse.shape) != (B, H, Sq):
            raise ValueError(f"lse must be ({B},{H},{Sq}); got "
                             f"{tuple(lse.shape)}")
        if lse.dtype != torch.float32:
            raise TypeError(f"want a float32 lse; got {lse.dtype}")
    extra = [t for t in (o, do, lse) if t is not None]
    if any(t.device != q.device for t in (k, v, *extra)):
        raise ValueError("q, k, v (and o, do, lse) must be on one device")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"want float32 or bfloat16 q/k/v of one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != q.dtype for t in (o, do) if t is not None):
        raise TypeError("o and do must have q's dtype")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _check_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")


def _forward(q, k, v, causal, window, with_lse):
    """(out, lse or None): K1 on the card, the plain version on the CPU."""
    global LAUNCHES
    _check(q, k, v, window)
    if q.device.type == "cpu":
        o = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window, return_lse=with_lse)
        if with_lse:
            return o[0].transpose(1, 2), o[1]
        return o.transpose(1, 2), None
    _check_cuda(q)
    B, Sq, H, hd = q.shape
    _, Skv, KVH, _ = k.shape
    if any(t.stride(-1) != 1 or not _build.rows_aligned(t) for t in (q, k, v)):
        raise ValueError("q, k, v need a unit stride on head_dim and "
                         "16-byte aligned rows")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(),
             DTYPES[q.dtype], B, H, KVH, Sq, Skv, hd,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], int(bool(causal)), int(window), stream)
    _build.check(err, NAME)
    with _count_lock:
        LAUNCHES += 1
    return out, lse


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B,Sq,H,hd); k,v: (B,Skv,KVH,hd) -> (B,Sq,H,hd). Traced as
    ``k1`` (the call's shapes and element size; the launch, not the
    kernel's run)."""
    with trace.span("k1", B=q.shape[0], Sq=q.shape[1], Skv=k.shape[1],
                    H=q.shape[2], KVH=k.shape[2], hd=q.shape[3],
                    causal=causal, window=window, elt=q.element_size()) \
            if trace.ON else trace.OFF:
        return _forward(q, k, v, causal, window, False)[0]


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0):
    """Gradients (dq, dk, dv) of ``flash_attention`` at (q, k, v), given
    its output ``o``, its row log-sum-exp ``lse`` (B,H,Sq) fp32 and the
    output's gradient ``do``: the backward kernel on the card, the plain
    version on the CPU. dk and dv sum over each KV head's query heads."""
    _check(q, k, v, window, o=o, do=do, lse=lse)
    if q.device.type == "cpu":
        t = (q, k, v, o, do)
        dq, dk, dv = flash_attention_bwd_ref(
            *(x.transpose(1, 2) for x in t[:4]), lse, t[4].transpose(1, 2),
            causal=causal, window=window)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    _check_cuda(q)
    B, Sq, H, hd = q.shape
    _, Skv, KVH, _ = k.shape
    return _bwd_launch(q, k, v, o, lse, do, causal, window,
                       plan_bwd(B, H, KVH, Sq, Skv, hd,
                                sm_count(q.device.index)))


def _bwd_launch(q, k, v, o, lse, do, causal, window, plan):
    """The backward's kernels on checked CUDA tensors under ``plan``."""
    global BWD_LAUNCHES
    B, Sq, H, hd = q.shape
    _, Skv, KVH, _ = k.shape
    # the kernels read rows with 16-byte copies
    q, k, v, o, do = (x if x.stride(-1) == 1 and _build.rows_aligned(x)
                      else x.clone(memory_format=torch.contiguous_format)
                      for x in (q, k, v, o, do))
    lse = lse.contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    scratch = (torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                           device=q.device) if plan.split else None)
    strides = (ctypes.c_int64 * 24)(*(st for x in (q, k, v, o, do, dq, dk, dv)
                                      for st in x.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib_bwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), D.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     DTYPES[q.dtype], B, H, KVH, Sq, Skv, hd,
                     ctypes.cast(strides, _P), int(bool(causal)), int(window),
                     None if scratch is None else scratch.data_ptr(),
                     stream)
    _build.check(err, BWD_NAME)
    with _count_lock:
        BWD_LAUNCHES += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward keeps (q, k, v, o,
    lse), the backward is ``flash_attention_bwd``. On CPU tensors both run
    the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=0):
        o, lse = _forward(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None
