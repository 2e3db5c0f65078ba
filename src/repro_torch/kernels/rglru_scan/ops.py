"""Wrapper of the RG-LRU scan kernel (``csrc/rglru_scan.cu``).

Takes the model's (B, S, W) fp32 gate products. A CUDA tensor launches the
kernel on the current stream (no synchronize); a CPU tensor runs the plain
version in ``ref.py``. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

NAME = "rglru_scan"

# kernel launches since the last reset; read and reset by chip_smoke.py
LAUNCHES = 0
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _lib():
    lib = _build.load(NAME)
    fn = lib.faillite_rglru_scan
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 5 + [_I] * 3 + [_L] * 4 + [_P]
    return fn


def _check(a, b, h0, h_last):
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"want a, b (B,S,W) of one shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    B, _, W = a.shape
    for name, t in (("h0", h0), ("h_last", h_last)):
        if t is not None and tuple(t.shape) != (B, W):
            raise ValueError(f"{name} must be ({B},{W}), got "
                             f"{tuple(t.shape)}")
    ts = [t for t in (a, b, h0, h_last) if t is not None]
    if any(t.device != a.device for t in ts):
        raise ValueError("a, b, h0 and h_last must be on one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"want float32 tensors; got "
                        f"{[t.dtype for t in ts]}")


def rglru_scan(a, b, h0, *, h_last=None):
    """a, b: (B,S,W) fp32; h0: (B,W) fp32 -> (h (B,S,W), h_last (B,W)).

    When ``h_last`` is given, the last state is written into it (it may
    be ``h0`` itself) and returned.
    """
    global LAUNCHES
    _check(a, b, h0, h_last)
    if a.device.type == "cpu":
        h, last = rglru_scan_ref(a, b, h0)
        if h_last is None:
            return h, last
        h_last.copy_(last)
        return h, h_last
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    B, S, W = a.shape
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous (B,S,W)")
    if h_last is None:
        h_last = torch.empty((B, W), dtype=torch.float32, device=a.device)
    if h0.stride(-1) != 1 or h_last.stride(-1) != 1:
        raise ValueError("h0 and h_last need a unit stride on the width")
    h = torch.empty_like(a)
    fn = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
             h_last.data_ptr(), B, S, W, a.stride(0), a.stride(1),
             h0.stride(0), h_last.stride(0), stream)
    _build.check(err, NAME)
    with _count_lock:
        LAUNCHES += 1
    return h, h_last
