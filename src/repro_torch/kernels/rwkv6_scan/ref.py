"""Plain PyTorch versions of the WKV-6 kernels, in the model's
(B, S, nh, hs) layout.

``wkv6_ref`` is the step-by-step recurrence (the port of
``repro/models/rwkv6.py::wkv_scan``, which is also
``repro/kernels/rwkv6_scan/ref.py::wkv6_ref`` with an initial state): the
wrapper's CPU path and the oracle of both CUDA routes.

``wkv6_chunked_ref`` is the algorithm of the chunked CUDA route, step for
step: chunks of ``chunk`` steps cut into sub-chunks of ``sub`` rows, every
exponent kept <= 0 (no clamp on lw), and, with ``tf32x3``, every matrix
product rounded as the kernel's 3xTF32 tensor-core products round their
operands. It is what the CPU tests hold against the JAX model.
``wkv6_chunked_bwd_ref`` is its reverse; with ``sub=16`` and ``tf32x3``
it is the algorithm and rounding of the backward kernel
(``csrc/rwkv6_scan_bwd.cu``).
"""

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


def tf32_round(x):
    """fp32 -> the nearest TF32 value (10-bit mantissa), ties away from
    zero: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32x3_matmul(a, b, tf32x3):
    """a @ b in fp32, or as the kernel's 3xTF32 product: each operand
    split into a TF32 high part and a TF32 remainder, hi.hi + hi.lo +
    lo.hi (lo.lo dropped)."""
    if not tf32x3:
        return a @ b
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _chunked(xs, lw, C):
    """The tensors ``xs`` and lw (B,S,nh,hs) in chunks of C steps, padded
    with zeros past S: ([x (B,nh,nc,C,hs) fp32], cum, cum_prev, cum_last),
    with cum the inclusive and cum_prev the exclusive cumulative sum of lw
    in each chunk and cum_last its last row (B,nh,nc,1,hs)."""
    B, S, nh, hs = lw.shape
    pad = (-S) % C
    nc = (S + pad) // C

    def chunks(t):                           # -> (B, nh, nc, C, hs) fp32
        t = t.float().movedim(2, 1)
        if pad:
            t = torch.nn.functional.pad(t, (0, 0, 0, pad))
        return t.reshape(B, nh, nc, C, hs)

    lwc = chunks(lw)
    cum = torch.cumsum(lwc, dim=3)                          # inclusive
    cum_prev = torch.cat([torch.zeros_like(cum[..., :1, :]),
                          cum[..., :-1, :]], dim=3)         # exclusive
    return [chunks(x) for x in xs], cum, cum_prev, cum[..., -1:, :]


def _unchunk(t, S):
    """(B,nh,nc,C,hs) -> (B,S,nh,hs), the padding dropped."""
    B, nh, nc, C, hs = t.shape
    return t.reshape(B, nh, nc * C, hs)[:, :, :S].movedim(1, 2).contiguous()


def _state_walk(kc, vc, cum, cum_last, s0, tf32x3):
    """Each chunk's state increment (k e^{cum_last - cum})^T v and decay
    e^{cum_last}, then the walk over the chunks from s0: (S_in
    (B,nh,nc,hs,hs), the final state, decay (B,nh,nc,hs))."""
    B, nh, nc, _, hs = kc.shape
    k_dec = kc * torch.exp(cum_last - cum)
    dstate = tf32x3_matmul(k_dec.transpose(-1, -2), vc,
                           tf32x3)                          # (.., hs, hs)
    decay = torch.exp(cum_last[..., 0, :])                  # (.., hs)
    s = (torch.zeros((B, nh, hs, hs), dtype=torch.float32, device=kc.device)
         if s0 is None else s0.float())
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, :, c, :, None] * s + dstate[:, :, c]
    return torch.stack(s_in, dim=2), s, decay


def wkv6_chunked_ref(r, k, v, lw, u, s0=None, *, chunk=32, sub=16,
                     tf32x3=False):
    """The chunked route's algorithm; same contract as ``wkv6_ref``.

    Per chunk (padded with zeros past S), with cum the inclusive and
    cum_prev the exclusive cumulative sum of lw: the chunk's state
    increment (k e^{cum_last - cum})^T v and decay e^{cum_last}; a walk
    over the chunks for each chunk's incoming state S_in; then
    y = (r e^{cum_prev}) @ S_in + A @ v, with A[t, s] for t in sub-chunk p
    and s before its first row b_p the product
    (r_t e^{cum_prev_t - cum_prev_{b_p}}) . (k_s e^{cum_prev_{b_p} - cum_s}),
    inside a diagonal sub-chunk sum_k r_t k_s exp(min(cum_prev_t - cum_s,
    0)) for s < t and r_t . (u k_t) at s = t. Every exponent is <= 0.
    """
    B, S, nh, hs = r.shape
    C = chunk
    assert C % sub == 0
    (rc, kc, vc), cum, cum_prev, cum_last = _chunked((r, k, v), lw, C)
    nc = rc.shape[2]
    # (a) and (b): each chunk's incoming state
    s_in, s, _ = _state_walk(kc, vc, cum, cum_last, s0, tf32x3)

    # (c) the outputs
    a = torch.zeros((B, nh, nc, C, C), dtype=torch.float32, device=r.device)
    lower = torch.tril(torch.ones((sub, sub), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    uf = u.float()[None, :, None, None, :]
    for p in range(C // sub):
        b0 = p * sub
        rows = slice(b0, b0 + sub)
        rt, kt = rc[..., rows, :], kc[..., rows, :]
        expo = cum_prev[..., rows, None, :] - cum[..., None, rows, :]
        diag = (rt[..., :, None, :] * kt[..., None, :, :]
                * torch.exp(torch.clamp(expo, max=0.0))).sum(-1) * lower
        diag = diag + torch.diag_embed((rt * uf * kt).sum(-1))
        a[..., rows, rows] = diag
        if p:
            ref = cum_prev[..., b0:b0 + 1, :]
            r_loc = rt * torch.exp(cum_prev[..., rows, :] - ref)
            k_loc = kc[..., :b0, :] * torch.exp(ref - cum[..., :b0, :])
            a[..., rows, :b0] = tf32x3_matmul(
                r_loc, k_loc.transpose(-1, -2), tf32x3)
    r_dec = rc * torch.exp(cum_prev)
    y = tf32x3_matmul(r_dec, s_in, tf32x3) + tf32x3_matmul(a, vc, tf32x3)
    return _unchunk(y, S), s


def wkv6_chunked_bwd_ref(r, k, v, lw, u, s0, dy, ds_out, *, chunk=32,
                         sub=None, tf32x3=False):
    """Gradients of ``wkv6_chunked_ref`` at (r, k, v, lw, u, s0), given
    the gradients ``dy`` (B,S,nh,hs) of y and ``ds_out`` (B,nh,hs,hs) of
    the final state. The algorithm of
    ``csrc/rwkv6_scan_bwd.cu`` with ``sub=16``, per chunk of ``chunk``
    steps (padded with zeros past S), with cum, cum_prev and cum_last as
    in the forward:

    - S_in of each chunk, recomputed by the forward's walk;
    - the chunks walked backwards for the adjoint of each chunk's outgoing
      state: dS_in,c = e^{cum_last,c} (rows) dS_out,c + (r e^{cum_prev})^T
      dy_c, dS_out,c-1 = dS_in,c, and ds0 = dS_in,0;
    - per chunk, with E[t, s] = e^{cum_prev_t - cum_s} (every exponent
      <= 0) for s < t, the intra-chunk A[t, s] = sum_i r_t k_s E[t, s],
      dA[t, s] = dy_t . v_s and the bonus terms at s = t:
        dr_t = e^{cum_prev_t} (S_in dy_t) + sum_{s<t} dA[t,s] k_s E[t,s]
               + dA[t,t] u k_t,
        dk_s = sum_{t>s} dA[t,s] r_t E[t,s] + e^{cum_last - cum_s}
               (dS_out v_s) + dA[s,s] u r_s,
        dv_s = sum_{t>s} A[t,s] dy_t + (r_s . u k_s) dy_s
               + (k_s e^{cum_last - cum_s}) dS_out,
        du = sum_{b,t} dA[t,t] r_t k_t;
    - dlw from the gradients of the cumulative sums: with dr' and dk'
      those of r and k without the bonus, X_t = r_t dr'_t (of cum_prev_t),
      Y_t the intra-chunk part of k_t dk'_t (of cum_t, negated) and Z_t
      its state part,
        dlw_tau = sum_{t>tau} X_t - sum_{t>=tau} Y_t + sum_{t<tau} Z_t
                  + sum_j e^{cum_last} S_in dS_out,
      the state terms through dcum_last and -dcum_s already netted, so
      only the intra-chunk pairs cancel (X and Y both hold a pair (t, s)
      whose exponent has no step between them at full size).

    ``sub=None`` sums every pair s < t exactly, its E evaluated one by
    one. With ``sub`` the chunk is cut into sub-chunks of ``sub`` rows,
    as the forward cuts it: the pairs inside a diagonal sub-chunk stay
    exact, and for t in sub-chunk p and s before its first row b_p the
    pairs go through products of the factors R~_t = r_t e^{cum_prev_t -
    cum_prev_{b_p}} and K~_s = k_s e^{cum_prev_{b_p} - cum_s} (both
    exponents <= 0): A[t, s] = R~_t . K~_s, dr_in,t = e^{cum_prev_t -
    cum_prev_{b_p}} (dA[t, <b_p] K~) and dk_in,s = e^{cum_prev_{b_p} -
    cum_s} (dA[>=b_p, s]^T R~), summed over the later sub-chunks; the
    bonus sits on A's diagonal for dv.

    With ``tf32x3`` every matrix product is rounded as the kernel's
    tensor-core products round theirs (``tf32x3_matmul``); the sums over
    the E-weighted pairs stay in fp32. Returns (dr, dk, dv in r's dtype,
    dlw, du, ds0 fp32).
    """
    S, C = r.shape[1], chunk
    (rc, kc, vc, dyc), cum, cum_prev, cum_last = _chunked((r, k, v, dy),
                                                          lw, C)
    nc = rc.shape[2]
    s_in, _, decay = _state_walk(kc, vc, cum, cum_last, s0, tf32x3)

    def mm(a, b):
        return tf32x3_matmul(a, b, tf32x3)

    # the reverse walk: dS_out of each chunk, and ds0
    e_prev = torch.exp(cum_prev)
    g = mm((rc * e_prev).transpose(-1, -2), dyc)            # (.., hs, hs)
    d = ds_out.float()
    d_out = [None] * nc
    for c in range(nc - 1, -1, -1):
        d_out[c] = d
        d = decay[:, :, c, :, None] * d + g[:, :, c]
    d_out = torch.stack(d_out, dim=2)                       # (B,nh,nc,hs,hs)

    # the intra-chunk pairs s < t computed exactly: all of them, or those
    # of the diagonal sub-chunks
    idx = torch.arange(C, device=r.device)
    exact = idx[:, None] > idx[None, :]
    if sub is not None:
        if C % sub:
            raise ValueError(f"sub={sub} must divide chunk={C}")
        exact &= (idx[:, None] // sub) == (idx[None, :] // sub)
    expo = cum_prev[..., :, None, :] - cum[..., None, :, :]
    e = torch.exp(torch.clamp(expo, max=0.0)) * exact[:, :, None]
    a = (rc[..., :, None, :] * kc[..., None, :, :] * e).sum(-1)
    da = mm(dyc, vc.transpose(-1, -2))                      # dy_t . v_s
    dbonus = torch.diagonal(da, dim1=-2, dim2=-1)[..., None]
    uf = u.float()[None, :, None, None, :]
    bonus = (rc * uf * kc).sum(-1, keepdim=True)
    dal = (da * exact)[..., None]
    dr_in = (dal * e * kc[..., None, :, :]).sum(-2)
    dk_in = (dal * e * rc[..., :, None, :]).sum(-3)
    for p in range(1, C // sub if sub is not None else 1):
        b0 = p * sub
        rows = slice(b0, b0 + sub)
        ref = cum_prev[..., b0:b0 + 1, :]
        f_r = torch.exp(cum_prev[..., rows, :] - ref)
        f_k = torch.exp(ref - cum[..., :b0, :])
        r_loc, k_loc = rc[..., rows, :] * f_r, kc[..., :b0, :] * f_k
        da_off = da[..., rows, :b0]
        a[..., rows, :b0] = mm(r_loc, k_loc.transpose(-1, -2))
        dr_in[..., rows, :] += f_r * mm(da_off, k_loc)
        dk_in[..., :b0, :] += f_k * mm(da_off.transpose(-1, -2), r_loc)
    dr_inter = e_prev * mm(dyc, s_in.transpose(-1, -2))
    k_exp = torch.exp(cum_last - cum)
    dk_state = k_exp * mm(vc, d_out.transpose(-1, -2))
    if sub is None:
        dv = mm(a.transpose(-1, -2), dyc) + bonus * dyc
    else:
        a = a + torch.diag_embed(bonus[..., 0])
        dv = mm(a.transpose(-1, -2), dyc)
    dv = dv + mm(kc * k_exp, d_out)
    dr = dr_inter + dr_in + dbonus * uf * kc
    dk = dk_in + dk_state + dbonus * uf * rc
    du = (dbonus * rc * kc).sum((0, 2, 3))

    # dlw: reverse cumulative sums of the cumulative sums' gradients
    x = rc * (dr_inter + dr_in)
    y = kc * dk_in
    z = kc * dk_state
    zl = (decay[..., None] * s_in * d_out).sum(-1)[..., None, :]
    def rev(t):                              # sum over t' >= t
        return torch.flip(torch.cumsum(torch.flip(t, [3]), 3), [3])

    dlw = (rev(x) - x) - rev(y) + (torch.cumsum(z, 3) - z) + zl
    return (_unchunk(dr, S).to(r.dtype), _unchunk(dk, S).to(k.dtype),
            _unchunk(dv, S).to(v.dtype), _unchunk(dlw, S), du.to(u.dtype),
            d)
