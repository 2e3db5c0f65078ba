"""Wrapper of the planner's masked-argmax kernel (K5,
``csrc/planner_argmax.cu``), and its plain PyTorch version.

One contract (first maximum among masked-in entries, (-1, -inf) on an
empty mask; see ref.py), for one (S,) row or a batch of (N, S) rows whose
values may share one column (row stride 0). A CUDA tensor launches the
kernel on the current stream (no synchronize); a CPU tensor runs
``masked_argmax_torch``. There is no fallback from one to the other.
Both are exact — comparisons only — so the choice never changes a
placement.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

NAME = "planner_argmax"

# kernel launches since the last reset; read and reset by chip_smoke.py
LAUNCHES = 0
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.float64: 2}


def _lib():
    lib = _build.load(NAME)
    fn = lib.faillite_masked_argmax
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * 4 + [_I] * 2 + [_L] * 2 + [_I, _P]
    return fn


def masked_argmax_torch(values: torch.Tensor, mask: torch.Tensor):
    """Plain version over the last axis: a max-reduce, then the first
    index attaining it as a min over iota (``torch.argmax`` takes no
    bool, and this is the formulation of the JAX package's
    ``masked_argmax_jnp``). The ``mask &`` term keeps an empty mask on
    the (-1, -inf) contract."""
    n = values.shape[-1]
    neg = float("-inf")
    masked = torch.where(mask, values, neg)
    mx = masked.amax(-1)
    iota = torch.arange(n, dtype=torch.int32, device=values.device)
    i = torch.where(mask & (masked == mx.unsqueeze(-1)), iota, n).amin(-1)
    found = i < n
    return torch.where(found, i, -1), torch.where(found, mx, neg)


def _check(values, mask):
    if values.dim() not in (1, 2) or tuple(mask.shape) != \
            tuple(values.shape):
        raise ValueError(f"want values and mask of one shape, (S,) or "
                         f"(N, S); got {tuple(values.shape)}, "
                         f"{tuple(mask.shape)}")
    if values.shape[-1] < 1:
        raise ValueError("want S >= 1")
    if values.dtype not in _DTYPES:
        raise TypeError(f"want float32 or float64 values; got "
                        f"{values.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"want a bool mask; got {mask.dtype}")
    if mask.device != values.device:
        raise ValueError("values and mask must be on one device")


def masked_argmax(values: torch.Tensor, mask: torch.Tensor):
    """values (S,) or (N, S) float32/float64, mask bool of that shape ->
    (idx int32, val in the values' dtype), 0-dim or (N,): the first
    maximum of ``values`` where ``mask`` is set, per row; (-1, -inf)
    where the row's mask is empty."""
    global LAUNCHES
    _check(values, mask)
    if values.device.type == "cpu":
        return masked_argmax_torch(values, mask)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    one = values.dim() == 1
    v2 = values.unsqueeze(0) if one else values
    m2 = mask.unsqueeze(0) if one else mask
    if v2.stride(1) != 1 or m2.stride(1) != 1:
        raise ValueError("values and mask need a unit stride along S")
    N, S = v2.shape
    idx = torch.empty(N, dtype=torch.int32, device=values.device)
    val = torch.empty(N, dtype=values.dtype, device=values.device)
    fn = _lib()
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = fn(v2.data_ptr(), m2.data_ptr(), idx.data_ptr(), val.data_ptr(),
             N, S, v2.stride(0), m2.stride(0), _DTYPES[values.dtype],
             stream)
    _build.check(err, NAME)
    with _count_lock:
        LAUNCHES += 1
    if one:
        return idx[0], val[0]
    return idx, val


__all__ = ["masked_argmax", "masked_argmax_torch"]
