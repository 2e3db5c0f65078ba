"""Plain PyTorch version of the int8 weight-only matmul (the port of
``repro/kernels/int8_matmul/ref.py``)."""

from __future__ import annotations

import torch


def int8_matmul_ref(x, w_q, scale, out_dtype=None):
    """x: (M,K); w_q: (K,N) int8; scale: (N,)."""
    out_dtype = out_dtype or x.dtype
    acc = x.float() @ w_q.float()
    return (acc * scale.float()).to(out_dtype)
