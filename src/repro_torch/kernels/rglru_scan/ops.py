"""Wrappers of the RG-LRU scan kernel (K3, ``csrc/rglru_scan.cu``).

Two routes:

- ``rglru_scan(a, b, h0)`` takes the (B, S, W) fp32 decays and inputs,
  the TPU kernel's contract;
- ``rglru_gated_scan(ga, gx, xb, log_lambda, h0)`` takes the model's
  values before the elementwise tail of its gates (the block-diagonal
  gate products and the post-conv input, in the model dtype) and computes
  a and b inside the kernel, so they never reach memory. The model's
  prefill and decode step call this one.

A CUDA tensor launches the kernel on the current stream (no synchronize):
a prefill (S > 1) the chunked scan, a decode step (S = 1) one thread per
(row, channel). A CPU tensor runs the plain version in ``ref.py``. There
is no fallback from one to the other. ``LAUNCHES`` counts the calls that
launched, either route; ``GATED_LAUNCHES`` those of the gated route.

``RGLRUGatedScanFn`` is the gated route under autograd: its forward is
``rglru_gated_scan``, its backward ``rglru_gated_scan_bwd`` (the kernel
of ``csrc/rglru_scan_bwd.cu`` on the card, counted in ``BWD_LAUNCHES``;
``rglru_gated_scan_bwd_ref`` on the CPU). The (a, b) route has no
backward and refuses grad on the card.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import (rglru_gated_scan_bwd_ref,
                                                rglru_gated_scan_ref,
                                                rglru_scan_ref)

NAME = "rglru_scan"
BWD_NAME = "rglru_scan_bwd"
# the ROADMAP entry of the (a, b) route's backward, named when a launch
# under grad is refused (``_build.refuse_grad``)
GRAD_ITEM = ("ROADMAP Queue 2, 'Backward kernels': "
             "not queued: K3's (a, b) route, which no model calls")
DTYPES = _build.DTYPE_CODES
# the backward kernel (csrc/rglru_scan_bwd.cu): chunks (warps) a block at
# most (MAXW), blocks a cluster at most (MAXCL), the steps of a chunk a
# thread holds in registers (KMAX); the warps an SM the card holds of it
MAX_WARPS = 16
MAX_CLUSTER = 8
KEEP_STEPS = 8
WAVE_WARPS = 16

# wrapper calls that launched, either route, those of the gated route,
# and the gated route's backward calls, since the last reset; read and
# reset by chip_smoke.py
LAUNCHES = 0
GATED_LAUNCHES = 0
BWD_LAUNCHES = 0
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load(NAME)
    fn = lib.faillite_rglru_scan
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 5 + [_I] * 3 + [_L] * 4 + [_P]
    return fn


def _lib_gated():
    lib = _build.load(NAME)
    fn = lib.faillite_rglru_gated_scan
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 7 + [_I] * 4 + [_L] * 8 + [_P]
    return fn


def _lib_bwd():
    lib = _build.load(BWD_NAME)
    fn = lib.faillite_rglru_gated_scan_bwd
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 14 + [_I] * 8 + [_L] * 6 + [_P]
    return fn


def bwd_vec(W: int) -> int:
    """Channels a thread of the backward kernel: two (one
    ``__nv_bfloat162`` or ``float2`` load) where the width is even, one
    otherwise."""
    return 2 if W % 2 == 0 else 1


def plan_chunks(B: int, S: int, W: int, vec: int,
                sm_count: int) -> tuple:
    """The backward kernel's cut of the sequence: (cl, nw, L), a thread
    block cluster of ``cl`` blocks of ``nw`` chunks of L steps each, with
    L = ceil(S / (cl nw)).

    A block owns 32 ``vec`` channels of a row, a warp a chunk, a thread L
    steps of its ``vec`` channels; the grid holds B ceil(W / 32 vec) cl
    nw warps. The chunks are the most, a power of two at most
    MAX_CLUSTER x MAX_WARPS and S rounded up, whose grid the card holds
    at once (WAVE_WARPS warps an SM of ``sm_count``: blocks of 16 warps at
    up to 128 registers a thread), so no block waits for another to
    finish; in blocks of MAX_WARPS chunks where there are that many. At
    recurrentgemma-2b's width that is 32 chunks at B = 1 (L = 8 at
    S = 256: ga and dh held in registers between the passes) and 16 at
    B = 2, at least two waves of warps (two on each of an SM's four
    schedulers). A function of its arguments alone, so two launches of
    one shape give the same bits.
    """
    if min(B, S, W, vec, sm_count) <= 0:
        raise ValueError(f"bad plan arguments {(B, S, W, vec, sm_count)}")
    groups = -(-W // (32 * vec))
    top = min(MAX_CLUSTER * MAX_WARPS, 1 << (S - 1).bit_length())
    slots = 1
    while slots < top and B * groups * slots * 2 <= WAVE_WARPS * sm_count:
        slots *= 2
    nw = min(MAX_WARPS, slots)
    return slots // nw, nw, -(-S // slots)


def _check_state(x, h0, h_last):
    B, _, W = x.shape
    for name, t in (("h0", h0), ("h_last", h_last)):
        if t is not None and tuple(t.shape) != (B, W):
            raise ValueError(f"{name} must be ({B},{W}), got "
                             f"{tuple(t.shape)}")
    for t in (h0, h_last):
        if t is not None and t.device != x.device:
            raise ValueError("inputs, h0 and h_last must be on one device")
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"want float32 h0 and h_last; got {t.dtype}")


def _check(a, b, h0, h_last):
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"want a, b (B,S,W) of one shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError("a, b, h0 and h_last must be on one device")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"want float32 tensors; got {a.dtype}, {b.dtype}")
    _check_state(a, h0, h_last)


def _state_out(x, h0, h_last):
    """h_last to write on the card, after checking the state strides."""
    B, _, W = x.shape
    if h_last is None:
        h_last = torch.empty((B, W), dtype=torch.float32, device=x.device)
    if h0.stride(-1) != 1 or h_last.stride(-1) != 1:
        raise ValueError("h0 and h_last need a unit stride on the width")
    return h_last


def _cpu_result(h, last, h_last):
    if h_last is None:
        return h, last
    h_last.copy_(last)
    return h, h_last


def rglru_scan(a, b, h0, *, h_last=None):
    """a, b: (B,S,W) fp32; h0: (B,W) fp32 -> (h (B,S,W), h_last (B,W)).

    When ``h_last`` is given, the last state is written into it (it may
    be ``h0`` itself) and returned.
    """
    global LAUNCHES
    _check(a, b, h0, h_last)
    if a.device.type == "cpu":
        return _cpu_result(*rglru_scan_ref(a, b, h0), h_last)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _build.refuse_grad("K3 (RG-LRU scan)", GRAD_ITEM, a, b, h0)
    B, S, W = a.shape
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous (B,S,W)")
    h_last = _state_out(a, h0, h_last)
    h = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib()(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
                 h_last.data_ptr(), B, S, W, a.stride(0), a.stride(1),
                 h0.stride(0), h_last.stride(0), stream)
    _build.check(err, NAME)
    with _count_lock:
        LAUNCHES += 1
    return h, h_last


def _check_gated(ga, gx, xb, log_lambda, h0, h_last):
    if xb.dim() != 3 or not (ga.shape == gx.shape == xb.shape):
        raise ValueError(f"want ga, gx, xb (B,S,W) of one shape; got "
                         f"{[tuple(t.shape) for t in (ga, gx, xb)]}")
    W = xb.shape[2]
    if tuple(log_lambda.shape) != (W,):
        raise ValueError(f"log_lambda must be ({W},), got "
                         f"{tuple(log_lambda.shape)}")
    if any(t.device != xb.device for t in (ga, gx, log_lambda)):
        raise ValueError("ga, gx, xb, log_lambda, h0 and h_last must be on "
                         "one device")
    if xb.dtype not in DTYPES or not (ga.dtype == gx.dtype == xb.dtype):
        raise TypeError(f"want float32 or bfloat16 ga, gx, xb of one dtype; "
                        f"got {ga.dtype}, {gx.dtype}, {xb.dtype}")
    if log_lambda.dtype != torch.float32:
        raise TypeError(f"want float32 log_lambda; got {log_lambda.dtype}")
    _check_state(xb, h0, h_last)
    if xb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xb.device}")


def rglru_gated_scan(ga, gx, xb, log_lambda, h0, *, h_last=None):
    """ga, gx, xb: (B,S,W) float32 or bfloat16, one dtype; log_lambda (W,)
    float32; h0: (B,W) float32 -> (h (B,S,W) fp32, h_last (B,W) fp32).

    h_t = a_t h_{t-1} + b_t with (a, b) = ``rglru_gates_ref(ga, gx, xb,
    log_lambda)``. When ``h_last`` is given, the last state is written into
    it (it may be ``h0`` itself) and returned. The launch is invisible to
    autograd: ``RGLRUGatedScanFn`` is the differentiable call.
    """
    global LAUNCHES, GATED_LAUNCHES
    _check_gated(ga, gx, xb, log_lambda, h0, h_last)
    if xb.device.type == "cpu":
        return _cpu_result(*rglru_gated_scan_ref(ga, gx, xb, log_lambda, h0),
                           h_last)
    B, S, W = xb.shape
    if any(t.stride(-1) != 1 for t in (ga, gx, xb)) \
            or not log_lambda.is_contiguous():
        raise ValueError("ga, gx and xb need a unit stride on the width, "
                         "log_lambda must be contiguous")
    h_last = _state_out(xb, h0, h_last)
    h = torch.empty((B, S, W), dtype=torch.float32, device=xb.device)
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = _lib_gated()(
        ga.data_ptr(), gx.data_ptr(), xb.data_ptr(), log_lambda.data_ptr(),
        h0.data_ptr(), h.data_ptr(), h_last.data_ptr(), DTYPES[xb.dtype],
        B, S, W, *ga.stride()[:2], *gx.stride()[:2], *xb.stride()[:2],
        h0.stride(0), h_last.stride(0), stream)
    _build.check(err, NAME)
    with _count_lock:
        LAUNCHES += 1
        GATED_LAUNCHES += 1
    return h, h_last


def rglru_gated_scan_bwd(ga, gx, xb, log_lambda, h0, h, dh, dh_last):
    """Gradients (dga, dgx, dxb, dlog_lambda, dh0) of ``rglru_gated_scan``
    at (ga, gx, xb, log_lambda, h0), given its output ``h`` (B,S,W) fp32
    and the gradients ``dh`` (B,S,W) of h and ``dh_last`` (B,W) of the
    last state: the backward kernel on the card, its chunks planned by
    ``plan_chunks``; the plain version on the CPU. Each gradient has its
    input's dtype."""
    _check_gated(ga, gx, xb, log_lambda, h0, None)
    B, S, W = xb.shape
    for name, t, shape in (("h", h, (B, S, W)), ("dh", dh, (B, S, W)),
                           ("dh_last", dh_last, (B, W))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != xb.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {xb.device}")
    if xb.device.type == "cpu":
        return rglru_gated_scan_bwd_ref(ga, gx, xb, log_lambda, h0, h, dh,
                                        dh_last)
    if any(t.stride(-1) != 1 for t in (ga, gx, xb)):
        raise ValueError("ga, gx and xb need a unit stride on the width")
    return _bwd_launch(ga, gx, xb, log_lambda, h0, h, dh, dh_last,
                       plan_chunks(B, S, W, bwd_vec(W),
                                   _build.sm_count(xb.device.index)))


def _bwd_launch(ga, gx, xb, log_lambda, h0, h, dh, dh_last, plan):
    """The backward kernel on checked CUDA tensors under ``plan`` = (cl,
    nw, L), ``plan_chunks``'s or another that covers S (chip_smoke.py
    times several)."""
    global BWD_LAUNCHES
    B, S, W = xb.shape
    cl, nw, L = plan
    vec = bwd_vec(W)
    if vec == 2:
        # a pair is one load: even strides, aligned rows
        ga, gx, xb = (t if t.data_ptr() % (2 * t.element_size()) == 0
                      and t.stride(0) % 2 == 0 and t.stride(1) % 2 == 0
                      else t.contiguous() for t in (ga, gx, xb))
    h0, h, dh, dh_last, log_lambda = (
        t.contiguous() for t in (h0, h, dh, dh_last, log_lambda))
    grads = [torch.empty((B, S, W), dtype=xb.dtype, device=xb.device)
             for _ in range(3)]
    dlam = torch.empty((W,), dtype=torch.float32, device=xb.device)
    dh0 = torch.empty((B, W), dtype=torch.float32, device=xb.device)
    part = torch.empty((B * cl, W), dtype=torch.float32, device=xb.device)
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = _lib_bwd()(
        ga.data_ptr(), gx.data_ptr(), xb.data_ptr(), log_lambda.data_ptr(),
        h0.data_ptr(), h.data_ptr(), dh.data_ptr(), dh_last.data_ptr(),
        *(g.data_ptr() for g in grads), dlam.data_ptr(), dh0.data_ptr(),
        part.data_ptr(), DTYPES[xb.dtype], B, S, W, vec, cl, nw, L,
        *ga.stride()[:2], *gx.stride()[:2], *xb.stride()[:2], stream)
    _build.check(err, BWD_NAME)
    with _count_lock:
        BWD_LAUNCHES += 1
    return (*grads, dlam, dh0)


class RGLRUGatedScanFn(torch.autograd.Function):
    """``rglru_gated_scan`` under autograd: (ga, gx, xb, log_lambda, h0)
    -> (h, h_last), both fresh tensors. The forward keeps its inputs and
    h; the backward is ``rglru_gated_scan_bwd``. On CPU tensors both run
    the plain versions."""

    @staticmethod
    def forward(ctx, ga, gx, xb, log_lambda, h0):
        h, h_last = rglru_gated_scan(ga, gx, xb, log_lambda, h0)
        ctx.save_for_backward(ga, gx, xb, log_lambda, h0, h)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        return rglru_gated_scan_bwd(*ctx.saved_tensors, dh.float(),
                                    dh_last.float())
