"""The backward passes of K3's gated route and of K4 on the CPU, against
the JAX package's autodiff.

- ``rglru_gated_scan_bwd_ref`` (the plain version of
  ``csrc/rglru_scan_bwd.cu``), chained through the block-diagonal gate
  products by autograd, against ``jax.vjp`` of the JAX model's
  ``rglru_scan`` (``repro/models/rglru.py``, the associative scan over
  ``_gates``) with respect to xb, gate_a, gate_x, log_lambda and h0, on
  bridged params: f32 and bf16 gates, zero and carried h0, S in {1, 7,
  33, 100}, and gates pushed to a -> 1 where the clamp of 1 - a^2 binds.
- ``rglru_gated_scan_bwd_chunked_ref``, the backward kernel's order
  (chunk summaries, the carries by a Kogge-Stone scan inside a block and
  the cluster's blocks last to first), at the chunks ``plan_chunks``
  gives and at others, against the same ``jax.vjp`` and the sequential
  plain backward; ``plan_chunks``'s contract.
- ``wkv6_chunked_bwd_ref`` (the plain version of
  ``csrc/rwkv6_scan_bwd.cu``), with every pair exact and with the
  kernel's ``sub=16`` (the off-diagonal sub-chunk pairs through products
  of their factors), plain and with ``tf32x3=True`` (every matrix product
  rounded as 3xTF32 products round), against ``jax.vjp`` of
  ``wkv_chunked`` (``repro/models/rwkv6.py``) and of ``wkv_scan`` for
  S = 1: lw spread down to -20, S no multiple of the 32-step chunk, hs in
  {8, 16, 64}, a carried s0, nonzero gradients of y and of the final
  state, f32 and bf16 r/k/v.
- ``RGLRUGatedScanFn`` and ``WKV6Fn`` on CPU tensors (the plain forward,
  the plain backward) against torch autograd through the plain forward.

Tolerances, relative to the largest |gradient| of each tensor: 1e-4 in
f32 and 2e-2 with bf16 inputs, dlw included. dlw's intra-chunk pairs
cancel (a pair whose exponent spans no step enters both the exclusive and
the inclusive cumulative sum at full size), so its error is eps times
those terms rather than times dlw itself; with lw spread from -0.05 to
-20 the largest |dlw| comes from the slow channels, and the worst dlw
error measured against jax.vjp on these cases is 8.2e-6 of it, exact
pairs or ``sub=16``, plain or tf32x3 alike: the off-diagonal pairs'
differently rounded X and Y products leave no visible residue (the other
gradients' worst is 8.5e-6 in f32, 2.5e-3 in bf16).
"""

import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import rwkv6 as JW  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_gated_scan_bwd_chunked_ref, rglru_gated_scan_bwd_ref,
    rglru_gated_scan_ref)
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: E402
    wkv6_chunked_bwd_ref, wkv6_ref)
from repro_torch.models import rglru as TR  # noqa: E402

RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the kernel's chunked order against the sequential plain backward
SEQ_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
ARCH = "recurrentgemma-2b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    """A JAX array or torch tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    """A JAX array as a torch tensor of the same dtype and values."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    """max |got - want| / max |want|."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


def _rglru_case(S, dtype, carried, extreme):
    """The JAX model's ``rglru_scan`` and its ``jax.vjp`` on bridged
    params (``extreme``: log_lambda -30 on half the channels), and the
    port's gate products: (JAX (h, h_last), JAX gradients of (xb,
    gate_a, gate_x, log_lambda, h0), (ga, gx, xb, log_lambda, h0) on the
    port with the gate products and xb recorded by autograd, leaves
    {gate_a, gate_x}, dh, dh_last)."""
    B, W = 2, 64
    cj = jconfigs.get_smoke(ARCH).replace(rnn_width=W, param_dtype=dtype,
                                          activation_dtype=dtype)
    ct = tconfigs.get_smoke(ARCH).replace(rnn_width=W, param_dtype=dtype,
                                          activation_dtype=dtype)
    pj = JR.init_rglru(jax.random.PRNGKey(S), cj)
    if extreme:
        pj = dict(pj, log_lambda=pj["log_lambda"].at[: W // 2].set(-30.0))
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                "cpu")
    r = np.random.default_rng(S + 7 * carried)
    x = r.standard_normal((B, S, W)).astype(np.float32)
    xj = jnp.asarray(x, JDT[dtype])
    h0 = (r.standard_normal((B, W)) if carried
          else np.zeros((B, W))).astype(np.float32)
    dh = r.standard_normal((B, S, W)).astype(np.float32)
    dh_last = r.standard_normal((B, W)).astype(np.float32)

    def f(xb, gate_a, gate_x, log_lambda, h0):
        p = dict(pj, gate_a=gate_a, gate_x=gate_x, log_lambda=log_lambda)
        return JR.rglru_scan(p, cj, xb, h0)

    out, vjp = jax.vjp(f, xj, pj["gate_a"], pj["gate_x"], pj["log_lambda"],
                       jnp.asarray(h0))
    want = vjp((jnp.asarray(dh), jnp.asarray(dh_last)))

    xt = _t(xj).requires_grad_()
    leaves = {k: pt[k].detach().clone().requires_grad_()
              for k in ("gate_a", "gate_x")}
    ga, gx = TR._gate_products(dict(pt, **leaves), ct, xt)
    return (out, want, (ga, gx, xt, pt["log_lambda"], torch.from_numpy(h0)),
            leaves, torch.from_numpy(dh), torch.from_numpy(dh_last))


def _chain(bwd, ins, leaves, h, dh, dh_last, dtype):
    """A plain backward's gradients of (ga, gx, xb), chained through the
    gate products by autograd: the gradients of (xb, gate_a, gate_x,
    log_lambda, h0)."""
    ga, gx, xt, lam, h0t = ins
    dga, dgx, dxb, dlam, dh0 = bwd(ga.detach(), gx.detach(), xt.detach(),
                                   lam, h0t, h.detach(), dh, dh_last)
    assert dga.dtype == dgx.dtype == dxb.dtype == TDT[dtype]
    assert dlam.dtype == dh0.dtype == torch.float32
    xt.grad = None
    for leaf in leaves.values():
        leaf.grad = None
    torch.autograd.backward([ga, gx, xt], [dga, dgx, dxb],
                            retain_graph=True)
    return (xt.grad, leaves["gate_a"].grad, leaves["gate_x"].grad, dlam,
            dh0)


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 7, 33, 100])
def test_rglru_bwd_ref_matches_jax_vjp(S, dtype, carried, extreme):
    """The gated route's plain backward, chained through the gate
    products, against ``jax.vjp`` of the JAX model's ``rglru_scan``.
    ``extreme`` sets log_lambda to -30 on half the channels: there a
    rounds to 1, 1 - a^2 to 0, and the clamp at 1e-12 binds, so d mult /
    d log_a (-1 / mult = -1e6 off the clamp) must be exactly 0 on both
    sides. (Between the clamp and |log a| ~ 1e-3, 1 - a^2 keeps few
    digits in f32 and two libraries' exp give gradients that differ in
    the third digit; tests/test_torch_cuda.py holds the kernel against
    the plain backward there, on one card.)"""
    out, want, ins, leaves, dh, dh_last = _rglru_case(S, dtype, carried,
                                                      extreme)
    h, h_last = rglru_gated_scan_ref(*ins)
    assert _rel(h, out[0]) < 2e-4 and _rel(h_last, out[1]) < 2e-4
    got = _chain(rglru_gated_scan_bwd_ref, ins, leaves, h, dh, dh_last,
                 dtype)
    for name, g, w in zip(("xb", "gate_a", "gate_x", "log_lambda", "h0"),
                          got, want):
        assert _rel(g, w) < RTOL[dtype], (name, _rel(g, w))


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 7, 33, 100])
def test_rglru_bwd_chunked_ref_matches_jax_vjp(S, dtype, extreme):
    """The backward kernel's order (``rglru_gated_scan_bwd_chunked_ref``:
    chunk summaries, a Kogge-Stone suffix scan of the carries inside each
    block, the blocks' composites last to first, the rescans) for the
    plan ``plan_chunks`` gives on a 132-SM card and for chunks of 1, 3 and
    8 steps in blocks of 2, 4 and all chunks, against ``jax.vjp`` (RTOL)
    and the sequential plain backward (1e-5 in f32; in bf16 a gradient
    may round to the neighbouring bf16 value), carried h0, the clamp
    binding where ``extreme``."""
    out, want, ins, leaves, dh, dh_last = _rglru_case(S, dtype, True,
                                                      extreme)
    h, _ = rglru_gated_scan_ref(*ins)
    seq = _chain(rglru_gated_scan_bwd_ref, ins, leaves, h, dh, dh_last,
                 dtype)
    B, W = h.shape[0], h.shape[2]
    _, nw, L = rglru_ops.plan_chunks(B, S, W,
                                     rglru_ops.bwd_vec(W), 132)
    for chunk, per_block in ((L, nw), (1, 2), (3, 4), (8, None)):
        got = _chain(functools.partial(rglru_gated_scan_bwd_chunked_ref,
                                       chunk=chunk, per_block=per_block),
                     ins, leaves, h, dh, dh_last, dtype)
        for name, g, w, q in zip(("xb", "gate_a", "gate_x", "log_lambda",
                                  "h0"), got, want, seq):
            assert _rel(g, w) < RTOL[dtype], (chunk, name, _rel(g, w))
            assert _rel(g, q) < SEQ_RTOL[dtype], (chunk, name, _rel(g, q))


@pytest.mark.parametrize("sms", [114, 132])
def test_rglru_bwd_plan_chunks_contract(sms):
    """``plan_chunks``: clusters of at most 8 blocks of at most 16 chunks
    cover S with the shortest chunks, the same answer for the same
    arguments, a grid of at most one wave of 16 warps an SM wherever a
    chunk of its own does not exceed it, and at recurrentgemma-2b's width
    (B = 1, 2; S = 256, 2100; f32 and bf16 pairs) at least two waves of
    warps (8 an SM), with ga and dh held in registers (L <= 8) at B = 1,
    S = 256."""
    for B, S, W, vec in itertools.product((1, 2, 3, 8), (1, 2, 7, 33, 100,
                                                          256, 257, 2100),
                                          (64, 2560, 2561), (1, 2)):
        cl, nw, L = rglru_ops.plan_chunks(B, S, W, vec, sms)
        assert (cl, nw, L) == rglru_ops.plan_chunks(B, S, W, vec, sms)
        assert 1 <= cl <= rglru_ops.MAX_CLUSTER
        assert 1 <= nw <= rglru_ops.MAX_WARPS
        assert L == -(-S // (cl * nw))          # covers S, evenly
        warps = B * -(-W // (32 * vec)) * cl * nw
        assert cl * nw == 1 or warps <= rglru_ops.WAVE_WARPS * sms
    for B, S, vec in itertools.product((1, 2), (256, 2100), (1, 2)):
        cl, nw, L = rglru_ops.plan_chunks(B, S, 2560, vec, sms)
        assert B * -(-2560 // (32 * vec)) * cl * nw >= 8 * sms, (B, S, vec)
    assert rglru_ops.plan_chunks(1, 256, 2560, 2, sms)[2] \
        <= rglru_ops.KEEP_STEPS
    with pytest.raises(ValueError):
        rglru_ops.plan_chunks(1, 0, 64, 1, sms)


# (B, NH, S, hs, lw_min, carried, dtype): lw to -20 and to -3, S no
# multiple of 32, S below one chunk, S = 1 (against wkv_scan), every head
# size of the tests, bf16 r/k/v
WKV_CASES = [
    (2, 2, 45, 16, -20.0, True, "float32"),
    (1, 3, 70, 8, -3.0, True, "float32"),
    (1, 2, 33, 64, -20.0, True, "float32"),
    (2, 1, 100, 16, -20.0, False, "float32"),
    (1, 2, 7, 64, -3.0, True, "float32"),
    (2, 2, 1, 16, -20.0, True, "float32"),
    (1, 2, 1, 64, -3.0, False, "float32"),
    (1, 2, 40, 16, -20.0, True, "bfloat16"),
]


@pytest.mark.parametrize("tf32x3,sub", [(False, None), (True, None),
                                        (False, 16), (True, 16)],
                         ids=["False", "True", "False-16", "True-16"])
@pytest.mark.parametrize("B,NH,S,hs,lw_min,carried,dtype", WKV_CASES)
def test_wkv_bwd_ref_matches_jax_vjp(B, NH, S, hs, lw_min, carried, dtype,
                                     tf32x3, sub):
    """The chunked backward against ``jax.vjp`` of the JAX model's
    ``wkv_chunked`` (``wkv_scan`` at S = 1) with respect to r, k, v, lw,
    u and s0, with nonzero gradients of y and of the final state: every
    pair exact (``sub`` None), or the kernel's algorithm (``sub=16``: the
    off-diagonal sub-chunk pairs through products of their factors)."""
    r = np.random.default_rng(B * 1000 + S * 10 + hs)
    rkv = [r.standard_normal((B, S, NH, hs)).astype(np.float32)
           for _ in range(3)]
    lw = -np.exp(r.uniform(np.log(0.05), np.log(-lw_min),
                           (B, S, NH, hs))).astype(np.float32)
    u = (r.standard_normal((NH, hs)) * 0.3).astype(np.float32)
    s0 = (r.standard_normal((B, NH, hs, hs)) * 0.3 if carried
          else np.zeros((B, NH, hs, hs))).astype(np.float32)
    dy = r.standard_normal((B, S, NH, hs)).astype(np.float32)
    ds = r.standard_normal((B, NH, hs, hs)).astype(np.float32)
    rkvj = [jnp.asarray(x, JDT[dtype]) for x in rkv]
    fn = JW.wkv_scan if S == 1 else JW.wkv_chunked
    _, vjp = jax.vjp(fn, *rkvj, jnp.asarray(lw), jnp.asarray(u),
                     jnp.asarray(s0))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = wkv6_chunked_bwd_ref(*(_t(x) for x in rkvj),
                               *(torch.from_numpy(x) for x in (lw, u, s0)),
                               torch.from_numpy(dy), torch.from_numpy(ds),
                               sub=sub, tf32x3=tf32x3)
    assert [g.dtype for g in got] == [TDT[dtype]] * 3 + [torch.float32] * 3
    for name, g, w in zip(("r", "k", "v", "lw", "u", "s0"), got, want):
        assert _rel(g, w) < RTOL[dtype], (name, _rel(g, w))


def test_recurrent_functions_on_cpu_match_autograd():
    """``RGLRUGatedScanFn`` and ``WKV6Fn`` on CPU tensors run the plain
    forward and the plain backward; their gradients match autograd
    through the plain forward, and nothing is launched."""
    r = np.random.default_rng(5)

    def leaves(*shapes):
        return [torch.from_numpy(r.standard_normal(s).astype(np.float32))
                .requires_grad_() for s in shapes]

    n0 = (rglru_ops.LAUNCHES, rglru_ops.BWD_LAUNCHES, wkv_ops.LAUNCHES,
          wkv_ops.BWD_LAUNCHES)
    B, S, W = 2, 37, 16
    xs = leaves((B, S, W), (B, S, W), (B, S, W), (W,), (B, W))
    dh = torch.from_numpy(r.standard_normal((B, S, W)).astype(np.float32))
    for fn in (rglru_ops.RGLRUGatedScanFn.apply, rglru_gated_scan_ref):
        h, h_last = fn(*xs)
        g = torch.autograd.grad((h * dh).sum() + h_last.sum(), xs)
        if fn is rglru_gated_scan_ref:
            for a, b in zip(got, g):
                assert _rel(a, b) < RTOL["float32"]
        got = g
    NH, hs = 2, 8
    xs = leaves(*[(B, S, NH, hs)] * 3, (B, S, NH, hs), (NH, hs),
                (B, NH, hs, hs))
    with torch.no_grad():
        xs[3].copy_(-torch.exp(xs[3]))            # lw <= 0
    dy = torch.from_numpy(r.standard_normal((B, S, NH, hs))
                          .astype(np.float32))
    for fn in (wkv_ops.WKV6Fn.apply, wkv6_ref):
        y, s = fn(*xs)
        g = torch.autograd.grad((y * dy).sum() + s.sum(), xs)
        if fn is wkv6_ref:
            for a, b in zip(got, g):
                assert _rel(a, b) < RTOL["float32"]
        got = g
    assert n0 == (rglru_ops.LAUNCHES, rglru_ops.BWD_LAUNCHES,
                  wkv_ops.LAUNCHES, wkv_ops.BWD_LAUNCHES)


def test_backward_wrappers_reject_bad_input():
    """The backward entries check shapes and dtypes before any launch."""
    x = torch.zeros(2, 5, 8)
    lam, h0 = torch.zeros(8), torch.zeros(2, 8)
    with pytest.raises(ValueError):
        rglru_ops.rglru_gated_scan_bwd(x, x, x, lam, h0, x[:, :4], x, h0)
    with pytest.raises(TypeError):
        rglru_ops.rglru_gated_scan_bwd(x, x, x, lam, h0, x.double(), x, h0)
    r = torch.zeros(1, 5, 2, 8)
    u, s0 = torch.zeros(2, 8), torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError):
        wkv_ops.wkv6_bwd(r, r, r, r, u, s0, None, r[:, :4], s0)
    with pytest.raises(ValueError):
        wkv_ops.wkv6_bwd(r, r, r, r, u, s0, None, r, s0[..., :4])
