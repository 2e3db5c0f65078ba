"""Wrapper of the prefill flash attention kernel (``csrc/flash_attention.cu``).

Takes the model's (B, S, H, hd) layout. A CUDA tensor launches the
kernel on the current stream (no synchronize); a CPU tensor runs the
plain version in ``ref.py``. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = _build.DTYPE_CODES

# kernel launches since the last reset; read and reset by chip_smoke.py
LAUNCHES = 0
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64



def _lib():
    lib = _build.load(NAME)
    fn = lib.faillite_flash_attention
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = ([_P] * 4 + [_I] * 7 + [_L] * 12 + [_I, _I, _P])
    return fn


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,S,H,hd), k/v (B,S,KVH,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    Bk, _, KVH, hdk = k.shape
    if Bk != B or hdk != hd or KVH == 0 or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form GQA attention")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"want float32 or bfloat16 q/k/v of one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B,Sq,H,hd); k,v: (B,Skv,KVH,hd) -> (B,Sq,H,hd)."""
    global LAUNCHES
    _check(q, k, v, window)
    if q.device.type == "cpu":
        o = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window)
        return o.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    _, Skv, KVH, _ = k.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 or not _build.rows_aligned(t) for t in (q, k, v)):
        raise ValueError("q, k, v need a unit stride on head_dim and "
                         "16-byte aligned rows")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    fn = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             DTYPES[q.dtype], B, H, KVH, Sq, Skv, hd,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], int(bool(causal)), int(window), stream)
    _build.check(err, NAME)
    with _count_lock:
        LAUNCHES += 1
    return out
