"""Wrapper of the WKV-6 kernel (``csrc/rwkv6_scan.cu``).

Takes the model's (B, S, nh, hs) layout: r, k, v in the activation dtype,
the log-decay lw in fp32, the bonus u (nh, hs) and the initial state s0
(B, nh, hs, hs) fp32. A CUDA tensor launches the kernel on the current
stream (no synchronize); a CPU tensor runs the plain version in
``ref.py``. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

NAME = "rwkv6_scan"
HEAD_SIZES = (8, 16, 32, 64)
DTYPES = _build.DTYPE_CODES

# kernel launches since the last reset; read and reset by chip_smoke.py
LAUNCHES = 0
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load(NAME)
    fn = lib.faillite_wkv6
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 8 + [_I] * 5 + [_L] * 19 + [_P]
    return fn


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


def wkv6(r, k, v, lw, u, s0, *, s_out=None):
    """WKV-6 from state ``s0`` -> (y (B,S,nh,hs) fp32, s_out).

    When ``s_out`` is given, the final state is written into it (it may be
    ``s0`` itself) and returned.
    """
    global LAUNCHES
    _check(r, k, v, lw, u, s0, s_out)
    if r.device.type == "cpu":
        y, s = wkv6_ref(r, k, v, lw, u, s0)
        if s_out is None:
            return y, s
        s_out.copy_(s)
        return y, s_out
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
    fn = _lib()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
             u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
             DTYPES[r.dtype], B, nh, S, hs,
             *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *lw.stride()[:3], *y.stride()[:3],
             *s0.stride()[:2], *s_out.stride()[:2], stream)
    _build.check(err, NAME)
    with _count_lock:
        LAUNCHES += 1
    return y, s_out
