"""Plain PyTorch version of the RG-LRU scan kernel (the port of
``repro/kernels/rglru_scan/ref.py``): a sequential scan over the
sequence, which gives the associative scan's numbers to fp32 rounding."""

from __future__ import annotations

import torch


def rglru_scan_ref(a, b, h0):
    """a, b: (B,S,W); h0: (B,W). h_t = a_t*h_{t-1} + b_t.

    Returns (h (B,S,W) fp32, h_last (B,W) fp32).
    """
    a, b = a.float(), b.float()
    h = torch.empty_like(a)
    hv = h0.float()
    for t in range(a.shape[1]):
        hv = a[:, t] * hv + b[:, t]
        h[:, t] = hv
    return h, hv
