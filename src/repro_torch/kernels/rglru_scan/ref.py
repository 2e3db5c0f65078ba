"""Plain PyTorch versions of the RG-LRU scan kernel (the port of
``repro/kernels/rglru_scan/ref.py``) and of its gated route.

``rglru_scan_ref`` is a sequential scan over the sequence, which gives the
associative scan's numbers to fp32 rounding. ``rglru_gates_ref`` is the
elementwise tail of the model's gates (``models/rglru.py`` ``_gates``, the
one copy of that arithmetic), and ``rglru_gated_scan_ref`` the two in a
row: what the gated route computes. ``rglru_scan_chunked_ref`` is the CUDA
kernel's chunked algorithm, for the tests. ``rglru_gated_scan_bwd_ref`` is
the gated route's reverse pass: the oracle of ``csrc/rglru_scan_bwd.cu``
and the backward of ``RGLRUGatedScanFn`` on a CPU tensor;
``rglru_gated_scan_bwd_chunked_ref`` is the same reverse pass in that
kernel's chunked order, for the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

RGLRU_C = 8.0
CHUNKS = 32          # chunks of the sequence a block (csrc: NC)


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


def rglru_gates_ref(ga, gx, xb, log_lambda):
    """The decays and inputs of the scan from the block-diagonal gate
    products ga, gx and the post-conv input xb (B,S,W), log_lambda (W,).

        a = exp(-c softplus(Lambda) sigmoid(ga))
        b = sqrt(1 - a^2) sigmoid(gx) xb,   1 - a^2 = 1 - exp(2 log a)

    Returns (a, b) (B,S,W) fp32.
    """
    r = torch.sigmoid(ga.float())
    i = torch.sigmoid(gx.float())
    log_a = -RGLRU_C * F.softplus(log_lambda.float()) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed in log space for stability
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * i * xb.float()
    return a, b


def rglru_gated_scan_bwd_ref(ga, gx, xb, log_lambda, h0, h, dh, dh_last):
    """Gradients of ``rglru_gated_scan_ref`` at (ga, gx, xb, log_lambda,
    h0), given its output ``h`` (B,S,W) and the gradients ``dh`` of h and
    ``dh_last`` (B,W) of the last state.

    The adjoint of h from the last step back, g_t = dh_t + a_{t+1} g_{t+1}
    with g_{S-1} = dh_{S-1} + dh_last, gives da_t = g_t h_{t-1} (h_{-1} =
    h0), db_t = g_t and dh0 = a_0 g_0; then the chain through
    ``rglru_gates_ref``. d mult / d log_a is -e^{2 log_a} / mult where
    the clamp of 1 - e^{2 log_a} at 1e-12 is not active and 0 where it
    is, as ``torch.clamp`` and ``jnp.maximum`` give off a tie.
    dlog_lambda sums over (B, S) in a fixed order.

    Returns (dga, dgx, dxb, dlog_lambda, dh0), each in its input's dtype.
    """
    r = torch.sigmoid(ga.float())
    i = torch.sigmoid(gx.float())
    x = xb.float()
    sp_c = -RGLRU_C * F.softplus(log_lambda.float())
    log_a = sp_c * r
    a = torch.exp(log_a)
    e2 = torch.exp(2.0 * log_a)
    one_m = 1.0 - e2
    mult = torch.sqrt(torch.clamp(one_m, min=1e-12))
    dh = dh.float()
    h_prev = torch.cat([h0.float()[:, None], h.float()[:, :-1]], dim=1)
    g = torch.empty_like(dh)
    carry = dh_last.float()
    for t in range(dh.shape[1] - 1, -1, -1):
        gt = dh[:, t] + carry
        g[:, t] = gt
        carry = a[:, t] * gt
    dh0 = carry
    da = g * h_prev
    dmult = torch.where(one_m > 1e-12, -e2 / mult, torch.zeros_like(mult))
    dlog_a = da * a + g * i * x * dmult
    dga = dlog_a * sp_c * r * (1.0 - r)
    dgx = g * mult * x * i * (1.0 - i)
    dxb = g * mult * i
    dlam = ((dlog_a * r).sum((0, 1)) * -RGLRU_C
            * torch.sigmoid(log_lambda.float()))
    return (dga.to(ga.dtype), dgx.to(gx.dtype), dxb.to(xb.dtype),
            dlam.to(log_lambda.dtype), dh0)


def rglru_gated_scan_bwd_chunked_ref(ga, gx, xb, log_lambda, h0, h, dh,
                                     dh_last, *, chunk, per_block=None):
    """``rglru_gated_scan_bwd_ref`` in the order of the backward kernel
    (``csrc/rglru_scan_bwd.cu``) with chunks of ``chunk`` steps, grouped
    in blocks of ``per_block`` chunks (all of them by default): each
    chunk's adjoint scanned from a zero carry, right to left, to
    (P, H) = (prod a, a_{t0} g_{t0}); with f_k(x) = P_k x + H_k, a
    Kogge-Stone suffix scan inside each block gives F_k = f_k o ... o
    f_last of the block; the carry at a block's right end is dh_last
    through the later blocks' composites, last to first; the carry into
    chunk k is F_{k+1} of it (the identity after the block's last chunk)
    and dh0 the first block's composite of it; each chunk rescanned from
    its carry. Steps past S are the identity (a = 1, dh = 0). Same
    contract and returns as ``rglru_gated_scan_bwd_ref``.
    """
    r = torch.sigmoid(ga.float())
    i = torch.sigmoid(gx.float())
    x = xb.float()
    sp_c = -RGLRU_C * F.softplus(log_lambda.float())
    log_a = sp_c * r
    a = torch.exp(log_a)
    e2 = torch.exp(2.0 * log_a)
    one_m = 1.0 - e2
    mult = torch.sqrt(torch.clamp(one_m, min=1e-12))
    dh = dh.float()
    B, S, W = dh.shape
    L = chunk
    nb = per_block or -(-S // L)
    n = -(-S // (L * nb)) * nb                 # chunks, empty ones included
    pad = n * L - S
    ap = torch.cat([a, a.new_ones(B, pad, W)], 1).reshape(B, n, L, W)
    dp = torch.cat([dh, dh.new_zeros(B, pad, W)], 1).reshape(B, n, L, W)
    P, H = a.new_ones(B, n, W), a.new_zeros(B, n, W)
    for u in range(L - 1, -1, -1):           # pass 1, every chunk at once
        H = ap[:, :, u] * (dp[:, :, u] + H)
        P = P * ap[:, :, u]
    P, H = P.reshape(B, n // nb, nb, W), H.reshape(B, n // nb, nb, W)
    d = 1
    while d < nb:                            # F_k = f_k o ... o f_last
        Pn = torch.cat([P[:, :, d:], P.new_ones(B, n // nb, d, W)], 2)
        Hn = torch.cat([H[:, :, d:], H.new_zeros(B, n // nb, d, W)], 2)
        H, P = P * Hn + H, P * Pn
        d *= 2
    c = dh_last.float()
    ends = [None] * (n // nb)                # the carry at each block's end
    for q in range(n // nb - 1, -1, -1):
        ends[q] = c
        c = P[:, q, 0] * c + H[:, q, 0]
    dh0 = c
    ends = torch.stack(ends, 1)[:, :, None]
    carry = torch.cat([P[:, :, 1:] * ends + H[:, :, 1:], ends], 2)
    carry = carry.reshape(B, n, W)
    g = torch.empty_like(dp)
    for u in range(L - 1, -1, -1):           # pass 2, from the carries
        g[:, :, u] = dp[:, :, u] + carry
        carry = ap[:, :, u] * g[:, :, u]
    g = g.reshape(B, n * L, W)[:, :S]
    h_prev = torch.cat([h0.float()[:, None], h.float()[:, :-1]], dim=1)
    da = g * h_prev
    dmult = torch.where(one_m > 1e-12, -e2 / mult, torch.zeros_like(mult))
    dlog_a = da * a + g * i * x * dmult
    dga = dlog_a * sp_c * r * (1.0 - r)
    dgx = g * mult * x * i * (1.0 - i)
    dxb = g * mult * i
    dlam = ((dlog_a * r).sum((0, 1)) * -RGLRU_C
            * torch.sigmoid(log_lambda.float()))
    return (dga.to(ga.dtype), dgx.to(gx.dtype), dxb.to(xb.dtype),
            dlam.to(log_lambda.dtype), dh0)


def rglru_gated_scan_ref(ga, gx, xb, log_lambda, h0):
    """The gated route: the gates, then the scan from h0 (B,W).

    Returns (h (B,S,W) fp32, h_last (B,W) fp32).
    """
    return rglru_scan_ref(*rglru_gates_ref(ga, gx, xb, log_lambda), h0)


def chunk_len(S):
    """Steps a chunk of the CUDA kernel's prefill: the sequence in CHUNKS
    chunks, from S alone."""
    return -(-S // CHUNKS)


def rglru_scan_chunked_ref(a, b, h0, chunk=None):
    """The CUDA kernel's prefill algorithm in plain PyTorch: chunks of
    ``chunk`` steps (``chunk_len(S)`` by default) each scanned from zero to
    (prod a, h_end), the carries combined in chunk order from h0, then each
    chunk rescanned from its carry-in. Steps past S are the identity.

    Returns (h (B,S,W) fp32, h_last (B,W) fp32).
    """
    a, b, h0 = a.float(), b.float(), h0.float()
    B, S, W = a.shape
    L = chunk or chunk_len(S)
    n = -(-S // L)
    pad = n * L - S
    ap = torch.cat([a, a.new_ones(B, pad, W)], 1).reshape(B, n, L, W)
    bp = torch.cat([b, b.new_zeros(B, pad, W)], 1).reshape(B, n, L, W)
    P = a.new_ones(B, n, W)
    H = a.new_zeros(B, n, W)
    for u in range(L):                       # pass 1, every chunk at once
        H = ap[:, :, u] * H + bp[:, :, u]
        P = P * ap[:, :, u]
    carry = torch.empty_like(H)
    c = h0
    for k in range(n):                       # the carries, in chunk order
        carry[:, k] = c
        c = P[:, k] * c + H[:, k]
    h = torch.empty_like(ap)
    hv = carry
    for u in range(L):                       # pass 2, from the carry-in
        hv = ap[:, :, u] * hv + bp[:, :, u]
        h[:, :, u] = hv
    h = h.reshape(B, n * L, W)[:, :S]
    return h, h[:, -1].clone()
