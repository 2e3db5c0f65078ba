"""K1's backward on the CPU: ``flash_attention_bwd_ref`` (the plain
version of ``csrc/flash_attention_bwd.cu``) against autograd through the
port's ``flash_attention_plain`` and against ``jax.vjp`` of the JAX
model's ``flash_attention_jnp`` (and ``banded_local_attention_jnp`` where
a window binds), on the same numpy inputs; ``FlashAttentionFn``'s wiring
driven through its plain routes; K1's row log-sum-exp; the shape checks
of the backward entry. Tolerance: f32 1e-5 of the largest |gradient|
(the three compute one function in f32 in different orders).

Also the CUDA route's algorithm where it runs here: ``plan_bwd``'s
launch plan (when the dK/dV pass splits each GQA group across blocks)
and the plain backward with ``tf32x3=True``, every product rounded as
the kernel's fp32 route rounds it (3xTF32) and dK/dV summed over the
group in the split's order, against ``jax.vjp`` within the card's f32
tolerance, 1e-4 of the largest |gradient|.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import (banded_local_attention_jnp,  # noqa: E402
                                 flash_attention_jnp)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.models import layers as L  # noqa: E402

RTOL = 1e-5
CARD_RTOL = 1e-4     # the card's f32 tolerance of K1's backward

# (B, Sq, Skv, H, KVH, hd, causal, window): causal, a window that binds
# and one that does not, non-causal with Sq != Skv (whisper's cross
# attention), G in {1, 2, 7}, hd in {16, 64}
CASES = [
    (2, 40, 40, 4, 4, 16, True, 0),      # G = 1
    (2, 40, 40, 4, 2, 16, True, 0),      # G = 2
    (1, 33, 33, 14, 2, 64, True, 0),     # G = 7, ragged
    (2, 48, 48, 4, 2, 16, True, 8),      # window binds (banded in JAX)
    (1, 30, 30, 7, 1, 64, True, 64),     # window wider than the prompt
    (2, 8, 50, 4, 4, 16, False, 0),      # non-causal, Sq < Skv
    (1, 50, 20, 14, 2, 64, False, 0),    # non-causal, Sq > Skv, G = 7
]


def _inputs(B, Sq, Skv, H, KVH, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KVH, hd)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    return q, k, v, do


def _close(got, want, rtol=RTOL):
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rtol * max(1.0, np.abs(b).max())


def _jax_grads(q, k, v, do, causal, window):
    Sq, Skv = q.shape[1], k.shape[1]
    if window and causal and Sq == Skv > window:
        fn = lambda q, k, v: banded_local_attention_jnp(  # noqa: E731
            q, k, v, window=window)
    else:
        fn = lambda q, k, v: flash_attention_jnp(  # noqa: E731
            q, k, v, causal=causal, window=window,
            kv_block=min(1024, max(128, Sq)))
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return vjp(jnp.asarray(do))


def _bwd_ref(q, k, v, do, causal, window, tf32x3=False):
    """The plain backward in the model's layout, on the plain forward's
    o and lse."""
    t = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v, do)]
    o, lse = flash_attention_ref(*t[:3], causal=causal, window=window,
                                 return_lse=True)
    return [g.transpose(1, 2) for g in flash_attention_bwd_ref(
        *t[:3], o, lse, t[3], causal=causal, window=window, tf32x3=tf32x3)]


@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_autograd_and_jax_vjp(case):
    B, Sq, Skv, H, KVH, hd, causal, window = case
    q, k, v, do = _inputs(B, Sq, Skv, H, KVH, hd, seed=sum(case[:6]))
    ref = _bwd_ref(q, k, v, do, causal, window)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = L.flash_attention_plain(*leaves, causal=causal, window=window)
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    _close([g.numpy() for g in ref], [g.numpy() for g in auto])
    _close([g.numpy() for g in ref], _jax_grads(q, k, v, do, causal,
                                                window))


@pytest.mark.parametrize("case", CASES[:4] + CASES[5:6])
def test_flash_attention_fn_wiring_on_cpu(case):
    """``FlashAttentionFn`` on CPU tensors (its plain routes: the dense
    forward with lse, ``flash_attention_bwd_ref``) gives autograd's
    gradients through the plain forward, and counts no launch."""
    B, Sq, Skv, H, KVH, hd, causal, window = case
    q, k, v, do = _inputs(B, Sq, Skv, H, KVH, hd, seed=7)
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    n0, b0 = fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES
    out = fa_ops.FlashAttentionFn.apply(*a, causal, window)
    got = torch.autograd.grad(out, a, torch.from_numpy(do))
    want_out = flash_attention_ref(*(x.transpose(1, 2) for x in b),
                                   causal=causal,
                                   window=window).transpose(1, 2)
    want = torch.autograd.grad(want_out, b, torch.from_numpy(do))
    assert torch.equal(out.detach(), want_out.detach())
    _close([g.numpy() for g in got], [g.numpy() for g in want])
    assert (fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES) == (n0, b0)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_row_logsumexp_of_the_plain_forward(causal, window):
    """lse = log sum_k exp(q.k / sqrt(hd)) over the unmasked keys."""
    q, k, v, _ = _inputs(2, 12, 12, 4, 2, 16, seed=3)
    t = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    _, lse = flash_attention_ref(*t, causal=causal, window=window,
                                 return_lse=True)
    kx = t[1].double().repeat_interleave(2, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", t[0].double(), kx) / math.sqrt(16)
    qp, kp = torch.arange(12)[:, None], torch.arange(12)[None, :]
    keep = torch.ones(12, 12, dtype=torch.bool)
    if causal:
        keep &= qp >= kp
    if window:
        keep &= kp > qp - window
    want = torch.logsumexp(s.masked_fill(~keep, -math.inf), dim=-1)
    assert lse.dtype == torch.float32
    assert torch.allclose(lse.double(), want, rtol=0, atol=1e-5)


def test_model_attention_takes_the_plain_path_on_cpu_under_grad():
    """On the CPU the model's attention stays on the plain path when
    autograd records it (FlashAttentionFn only on a CUDA tensor)."""
    q, k, v, _ = _inputs(1, 16, 16, 4, 2, 16, seed=4)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = L.flash_attention(*leaves, causal=True)
    assert out.grad_fn is not None
    assert "FlashAttentionFn" not in type(out.grad_fn).__name__


def test_backward_entry_rejects_bad_shapes():
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(2, 8, 8, 4, 2, 16, seed=5))
    o = torch.zeros_like(q)
    lse = torch.zeros((2, 4, 8))
    kw = dict(causal=True, window=0)
    fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    with pytest.raises(ValueError, match="do must have"):
        fa_ops.flash_attention_bwd(q, k, v, o, lse, do[:, :4], **kw)
    with pytest.raises(ValueError, match="o must have"):
        fa_ops.flash_attention_bwd(q, k, v, o[..., :8], lse, do, **kw)
    with pytest.raises(ValueError, match="lse must be"):
        fa_ops.flash_attention_bwd(q, k, v, o, lse[:, :, :4], do, **kw)
    with pytest.raises(TypeError, match="float32 lse"):
        fa_ops.flash_attention_bwd(q, k, v, o, lse.double(), do, **kw)
    with pytest.raises(TypeError, match="q's dtype"):
        fa_ops.flash_attention_bwd(q, k, v, o, lse, do.double(), **kw)


# qwen2.5-3b's heads (16 query heads on 2 KV heads, head_dim 128) at a
# ragged S
QWEN_HEADS = (1, 100, 100, 16, 2, 128, True, 0)


@pytest.mark.parametrize("case", CASES + [QWEN_HEADS])
def test_bwd_ref_tf32x3_matches_jax_vjp(case):
    """The fp32 route's arithmetic, every product in 3xTF32 and dK/dV
    summed head by head in the split's order, stays within the card's
    f32 tolerance of JAX's gradients; and it is not the fp32 product (the
    option rounds)."""
    B, Sq, Skv, H, KVH, hd, causal, window = case
    q, k, v, do = _inputs(B, Sq, Skv, H, KVH, hd, seed=sum(case[:6]) + 1)
    got = _bwd_ref(q, k, v, do, causal, window, tf32x3=True)
    _close([g.numpy() for g in got], _jax_grads(q, k, v, do, causal, window),
           rtol=CARD_RTOL)
    plain = _bwd_ref(q, k, v, do, causal, window)
    assert any(not torch.equal(a, b) for a, b in zip(got, plain))


# (B, H, KVH, Sq, Skv, hd): the phase 8 (a) rows and BWD_SWEEP's sides,
# each with its key tile and its dK/dV grid unsplit and split
PLAN_SHAPES = {
    (2, 16, 2, 256, 256, 128): (64, 16, 128),        # qwen2.5-3b B=2 S=256
    (5, 16, 2, 1024, 1024, 128): (64, 160, 1280),    # past 132 SMs
    (1, 14, 2, 256, 256, 256): (32, 16, 112),        # G = 7, hd 256
    (1, 56, 8, 256, 256, 128): (64, 32, 224),        # arctic-480b
    (1, 32, 16, 2100, 2100, 128): (64, 528, 1056),   # gemma3-27b
    (1, 10, 1, 2100, 2100, 256): (32, 66, 660),      # recurrentgemma-2b
    (1, 16, 16, 64, 1500, 64): (64, 384, None),      # whisper cross, G = 1
    (2, 8, 2, 24, 24, 16): (64, 4, 16),              # a smoke rung
}


@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
@pytest.mark.parametrize("n_sm", [10, 11, 106, 107, 132, 352, 353])
def test_plan_bwd_splits_exactly_when_the_group_grid_cannot_fill_the_card(
        shape, n_sm):
    """Split iff the group has more than one head and the unsplit grid
    has fewer than 1.5 blocks an SM (16 blocks: 11 SMs or more; 160: 107;
    528: 353); the scratch is the fp32 partial dK and dV, 2 B Skv H hd 4
    bytes; the same shapes give the same plan."""
    B, H, KVH, Sq, Skv, hd = shape
    bk, unsplit, split = PLAN_SHAPES[shape]
    plan = fa_ops.plan_bwd(B, H, KVH, Sq, Skv, hd, n_sm)
    if split is not None and unsplit < 1.5 * n_sm:
        assert plan == fa_ops.BwdPlan(bk, True, split,
                                      2 * B * Skv * H * hd * 4)
    else:
        assert plan == fa_ops.BwdPlan(bk, False, unsplit, 0)
    assert fa_ops.plan_bwd(B, H, KVH, Sq, Skv, hd, n_sm) == plan


@pytest.mark.parametrize("hd", fa_ops.HEAD_DIMS)
def test_plan_bwd_never_splits_a_group_of_one(hd):
    for n_sm in (1, 132, 10**6):
        plan = fa_ops.plan_bwd(1, 4, 4, 8, 8, hd, n_sm)
        assert not plan.split and plan.scratch_bytes == 0


def test_plan_bwd_at_the_training_shapes():
    """qwen2.5-3b B=2 S=256 on 132 SMs: 16 blocks become 128, with 8.4 MB
    of scratch a layer; recurrentgemma-2b's S=2100: 43 MB; gemma3-27b's
    528 blocks fill four waves and stay unsplit."""
    plan = fa_ops.plan_bwd(2, 16, 2, 256, 256, 128, 132)
    assert (plan.split, plan.blocks, plan.scratch_bytes) == \
        (True, 128, 8_388_608)
    assert fa_ops.plan_bwd(2, 16, 2, 256, 256, 128, 10).blocks == 16
    plan = fa_ops.plan_bwd(1, 10, 1, 2100, 2100, 256, 132)
    assert (plan.split, plan.scratch_bytes) == (True, 43_008_000)
    assert not fa_ops.plan_bwd(1, 32, 16, 2100, 2100, 128, 132).split
