"""Plain PyTorch version of the int8 weight-only matmul (the port of
``repro/kernels/int8_matmul/ref.py``), and the CUDA kernel's split-K
algorithm, for the tests."""

from __future__ import annotations

import torch


def int8_matmul_ref(x, w_q, scale, out_dtype=None):
    """x: (M,K); w_q: (K,N) int8; scale: (N,)."""
    out_dtype = out_dtype or x.dtype
    acc = x.float() @ w_q.float()
    return (acc * scale.float()).to(out_dtype)


def int8_matmul_splitk_ref(x, w_q, scale, n_split, k_chunk, out_dtype=None):
    """The CUDA kernel's algorithm: x and the int8 codes widened exactly,
    an fp32 partial sum over each K range of ``k_chunk``, the partials
    added in split order, then the scale once."""
    out_dtype = out_dtype or x.dtype
    acc = None
    for s in range(n_split):
        ks = slice(s * k_chunk, (s + 1) * k_chunk)
        part = x[:, ks].float() @ w_q[ks].float()
        acc = part if acc is None else acc + part
    return (acc * scale.float()).to(out_dtype)
