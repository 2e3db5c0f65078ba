"""Plain PyTorch version of the WKV-6 kernel: the step-by-step recurrence
(the port of ``repro/models/rwkv6.py::wkv_scan``, which is also
``repro/kernels/rwkv6_scan/ref.py::wkv6_ref`` with an initial state), in
the model's (B, S, nh, hs) layout."""

from __future__ import annotations

import torch


def wkv6_ref(r, k, v, lw, u, s0=None):
    """r, k, v, lw: (B,S,nh,hs); u: (nh,hs); s0: (B,nh,hs,hs) fp32 or None.

    Returns (y (B,S,nh,hs) fp32, s_out (B,nh,hs,hs) fp32).
    """
    B, S, nh, hs = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(lw.float())
    s = (torch.zeros((B, nh, hs, hs), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    uf = u.float()[..., :, None]
    y = torch.empty((B, S, nh, hs), dtype=torch.float32, device=r.device)
    for t in range(S):
        a = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # (B,nh,hs,hs)
        y[:, t] = torch.einsum("bnk,bnkv->bnv", rf[:, t], s + uf * a)
        s = w[:, t, :, :, None] * s + a
    return y, s
