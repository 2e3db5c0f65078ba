"""Wrapper of the WKV-6 kernels (``csrc/rwkv6_scan.cu``).

Takes the model's (B, S, nh, hs) layout: r, k, v in the activation dtype,
the log-decay lw in fp32, the bonus u (nh, hs) and the initial state s0
(B, nh, hs, hs) fp32. A CUDA tensor launches on the current stream (no
synchronize); a CPU tensor runs the plain version ``wkv6_ref`` in
``ref.py``. There is no fallback from one to the other.

The route follows from the shape alone (``chunked_route``): a prefill
(S > 1) runs the chunk-parallel kernels on the tensor cores (three
launches over chunks of ``CHUNK`` steps; its plain version is
``wkv6_chunked_ref``), a decode step (S = 1) the recurrence. Both are
counted once per call in ``LAUNCHES``; ``CHUNKED_LAUNCHES`` counts the
calls that took the chunked route.

``WKV6Fn`` is the differentiable call: its forward is either route, and
keeps each chunk's incoming state (the chunked route's ``states``
buffer), its backward is ``wkv6_bwd`` (the kernels of
``csrc/rwkv6_scan_bwd.cu`` on the card, counted in ``BWD_LAUNCHES``;
``wkv6_chunked_bwd_ref`` on the CPU), for every S.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch import trace
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import (wkv6_chunked_bwd_ref,
                                                wkv6_ref)

NAME = "rwkv6_scan"
BWD_NAME = "rwkv6_scan_bwd"
HEAD_SIZES = (8, 16, 32, 64)
CHUNK = 32                 # steps per chunk of the prefill route (csrc)
DTYPES = _build.DTYPE_CODES

# wrapper calls that launched, either route, those of the chunked route,
# and the backward's calls, since the last reset; read and reset by
# chip_smoke.py
LAUNCHES = 0
CHUNKED_LAUNCHES = 0
BWD_LAUNCHES = 0
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load(NAME)
    fn = lib.faillite_wkv6
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 8 + [_I] * 5 + [_L] * 19 + [_P]
    return fn


def _lib_chunked():
    lib = _build.load(NAME)
    fn = lib.faillite_wkv6_chunked
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 10 + [_I] * 5 + [_L] * 19 + [_P]
    return fn


def _lib_bwd():
    lib = _build.load(BWD_NAME)
    fn = lib.faillite_wkv6_bwd
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 17 + [_I] * 5 + [_L] * 15 + [_P]
    return fn


def chunked_route(S: int) -> bool:
    """A prefill (S > 1) takes the chunked kernels, a decode step the
    recurrence: decided from the sequence length alone."""
    return S > 1


def n_chunks(S: int) -> int:
    return -(-S // CHUNK)


def _check(r, k, v, lw, u, s0, s_out):
    if r.dim() != 4 or not (k.shape == v.shape == lw.shape == r.shape):
        raise ValueError(f"want r, k, v, lw (B,S,nh,hs) of one shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, lw)]}")
    B, _, nh, hs = r.shape
    if tuple(u.shape) != (nh, hs):
        raise ValueError(f"u must be ({nh},{hs}), got {tuple(u.shape)}")
    for name, t in (("s0", s0), ("s_out", s_out)):
        if t is not None and tuple(t.shape) != (B, nh, hs, hs):
            raise ValueError(f"{name} must be ({B},{nh},{hs},{hs}), got "
                             f"{tuple(t.shape)}")
    ts = [t for t in (r, k, v, lw, u, s0, s_out) if t is not None]
    if any(t.device != r.device for t in ts):
        raise ValueError("r, k, v, lw, u, s0 and s_out must be on one device")
    if r.dtype not in DTYPES or not (r.dtype == k.dtype == v.dtype):
        raise TypeError(f"want float32 or bfloat16 r/k/v of one dtype; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != torch.float32 for t in (lw, u, s0, s_out)
           if t is not None):
        raise TypeError("lw, u, s0 and s_out must be float32")


def _launch(r, k, v, lw, u, s0, y, s_out, stream):
    """Launch the route of ``chunked_route(S)`` on checked tensors:
    (CUDA error code, the chunked route's ``states`` buffer or None)."""
    B, S, nh, hs = r.shape
    strides = (DTYPES[r.dtype], B, nh, S, hs,
               *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *lw.stride()[:3], *y.stride()[:3],
               *s0.stride()[:2], *s_out.stride()[:2], stream)
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr())
    if not chunked_route(S):
        return _lib()(*ptrs, *strides), None
    nc = n_chunks(S)
    # each chunk's state increment, then its incoming state: never s0 or
    # s_out, which may be one tensor
    states = torch.empty((B, nh, nc, hs, hs), dtype=torch.float32,
                         device=r.device)
    decay = torch.empty((B, nh, nc, hs), dtype=torch.float32,
                        device=r.device)
    return _lib_chunked()(*ptrs, states.data_ptr(), decay.data_ptr(),
                          *strides), states


def wkv6(r, k, v, lw, u, s0, *, s_out=None):
    """WKV-6 from state ``s0`` -> (y (B,S,nh,hs) fp32, s_out).

    When ``s_out`` is given, the final state is written into it (it may be
    ``s0`` itself) and returned. The launch is invisible to autograd:
    ``WKV6Fn`` is the differentiable call. Traced as ``k4`` (the call's
    shapes, route and element size; the launch, not the kernels' run).
    """
    with trace.span("k4", B=r.shape[0], S=r.shape[1], NH=r.shape[2],
                    hs=r.shape[3], chunked=chunked_route(r.shape[1]),
                    elt=r.element_size()) if trace.ON else trace.OFF:
        return _forward(r, k, v, lw, u, s0, s_out)[:2]


def _forward(r, k, v, lw, u, s0, s_out=None):
    """(y, s_out, each chunk's incoming state (B,nh,nc,hs,hs) fp32): the
    kernels' ``states`` buffer after a chunked launch, s0 itself after a
    recurrent one (one chunk); None on the CPU."""
    global LAUNCHES, CHUNKED_LAUNCHES
    _check(r, k, v, lw, u, s0, s_out)
    if r.device.type == "cpu":
        y, s = wkv6_ref(r, k, v, lw, u, s0)
        if s_out is None:
            return y, s, None
        s_out.copy_(s)
        return y, s_out, None
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    B, S, nh, hs = r.shape
    if hs not in HEAD_SIZES:
        raise ValueError(f"head size {hs} not in {HEAD_SIZES}")
    if s_out is None:
        s_out = torch.empty((B, nh, hs, hs), dtype=torch.float32,
                            device=r.device)
    if any(t.stride(-1) != 1 for t in (r, k, v, lw)) \
            or not u.is_contiguous() \
            or any(t.stride()[2:] != (hs, 1) for t in (s0, s_out)):
        raise ValueError("r, k, v, lw need a unit last stride, u must be "
                         "contiguous, and each (b, h) block of s0/s_out "
                         "contiguous")
    y = torch.empty((B, S, nh, hs), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err, states = _launch(r, k, v, lw, u, s0, y, s_out, stream)
    _build.check(err, NAME)
    with _count_lock:
        LAUNCHES += 1
        CHUNKED_LAUNCHES += chunked_route(S)
    if states is None:
        states = s0[:, :, None]
    return y, s_out, states


def wkv6_bwd(r, k, v, lw, u, s0, states, dy, ds_out):
    """Gradients (dr, dk, dv, dlw, du, ds0) of ``wkv6`` at (r, k, v, lw,
    u, s0), given the gradients ``dy`` (B,S,nh,hs) of y and ``ds_out``
    (B,nh,hs,hs) of the final state: the backward kernels on the card,
    reading ``states``, each chunk's incoming state from ``_forward``;
    the plain version ``wkv6_chunked_bwd_ref`` on the CPU (``states`` is
    not read). dr, dk, dv have r's dtype, the rest fp32."""
    global BWD_LAUNCHES
    _check(r, k, v, lw, u, s0, ds_out)
    B, S, nh, hs = r.shape
    if tuple(dy.shape) != (B, S, nh, hs) or dy.dtype != torch.float32 \
            or dy.device != r.device:
        raise ValueError(f"dy must be ({B},{S},{nh},{hs}) float32 on "
                         f"{r.device}")
    if r.device.type == "cpu":
        return wkv6_chunked_bwd_ref(r, k, v, lw, u, s0, dy, ds_out)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    if hs not in HEAD_SIZES:
        raise ValueError(f"head size {hs} not in {HEAD_SIZES}")
    nc = n_chunks(S)
    if tuple(states.shape) != (B, nh, nc, hs, hs) \
            or states.dtype != torch.float32:
        raise ValueError(f"states must be ({B},{nh},{nc},{hs},{hs}) float32")
    if any(t.stride(-1) != 1 for t in (r, k, v, lw, dy)):
        raise ValueError("r, k, v, lw and dy need a unit last stride")
    u, states, ds_out = (t.contiguous() for t in (u, states, ds_out))
    if states.data_ptr() % 16:       # read as 16-byte copies
        states = states.clone()
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty((B, S, nh, hs), dtype=r.dtype,
                              device=r.device) for _ in range(3))
    dlw = torch.empty((B, S, nh, hs), **f32)
    du = torch.empty((nh, hs), **f32)
    ds0 = torch.empty((B, nh, hs, hs), **f32)
    # each chunk's G, then its dS_out; each chunk's decay and du partial
    gbuf = torch.empty((B, nh, nc, hs, hs), **f32)
    decay = torch.empty((B, nh, nc, hs), **f32)
    du_part = torch.empty((B, nh, nc, hs), **f32)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _lib_bwd()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), states.data_ptr(), dy.data_ptr(), ds_out.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(),
        du.data_ptr(), ds0.data_ptr(), gbuf.data_ptr(), decay.data_ptr(),
        du_part.data_ptr(), DTYPES[r.dtype], B, nh, S, hs,
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *lw.stride()[:3],
        *dy.stride()[:3], stream)
    _build.check(err, BWD_NAME)
    with _count_lock:
        BWD_LAUNCHES += 1
    return dr, dk, dv, dlw, du, ds0


class WKV6Fn(torch.autograd.Function):
    """``wkv6`` under autograd: (r, k, v, lw, u, s0) -> (y, s_out), both
    fresh tensors. The forward keeps its inputs and each chunk's incoming
    state; the backward is ``wkv6_bwd``. On CPU tensors both run the plain
    versions."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0):
        y, s_out, states = _forward(r, k, v, lw, u, s0)
        ctx.save_for_backward(r, k, v, lw, u, s0, states)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds_out):
        r, k, v, lw, u, s0, states = ctx.saved_tensors
        return wkv6_bwd(r, k, v, lw, u, s0, states, dy.float().contiguous(),
                        ds_out.float())

