"""K4's chunked route (the prefill on tensor cores) on the CPU: its
algorithm, ``wkv6_chunked_ref``, against the JAX package.

``wkv6_chunked_ref`` is what the chunked CUDA kernels compute, step for
step: chunks of C steps cut into sub-chunks of 16 rows, the off-diagonal
sub-chunk pairs as matrix products whose two factors are each decayed to
the first row of the later sub-chunk, the diagonal sub-chunks exactly,
every exponent <= 0 and no clamp on lw. It is held, at 5e-4 (the
tolerance of tests/test_kernels.py for K4):

- against the port's ``wkv6_ref`` and the JAX model's ``wkv_chunked`` and
  ``wkv_scan``, from a nonzero state, for C = 32 and 64 and lw down to
  -20, where the naive two-factor form of the Pallas kernel overflows;
- against the interpret-mode Pallas ``wkv6`` where lw >= -40/chunk, so
  that kernel's clamp changes nothing;
- with the kernel's 3xTF32 rounding of every matrix product, at
  rwkv6-3b's full prefill shape on chip_smoke.py's input distribution:
  within 5e-4 in f32 and 2e-2 (K4's bf16 tolerance) in bf16.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6_scan.ops import wkv6 as pallas_wkv6  # noqa: E402
from repro.models import rwkv6 as JW  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: E402
    tf32_round, wkv6_chunked_ref, wkv6_ref)

WKV_SWEEP = [                       # tests/test_kernels.py:82-86
    (2, 3, 70, 16),
    (1, 2, 64, 32),
    (2, 1, 33, 8),
]
WKV_ATOL, BF16_ATOL = 5e-4, 2e-2
LENGTHS = [1, 15, 16, 17, 63, 64, 65, 250]
CSRC = (Path(wkv_ops.__file__).parent / "csrc" / "rwkv6_scan.cu")


def _inputs(seed, B, NH, S, hs, lw_min, state=True):
    """(B,S,nh,hs) numpy inputs, lw spread over [lw_min, -0.05], u, and a
    nonzero (or zero) initial state."""
    r = np.random.default_rng(seed)
    rkv = [r.standard_normal((B, S, NH, hs)).astype(np.float32)
           for _ in range(3)]
    lw = -np.exp(r.uniform(np.log(0.05), np.log(-lw_min),
                           (B, S, NH, hs))).astype(np.float32)
    u = (r.standard_normal((NH, hs)) * 0.3).astype(np.float32)
    s0 = (r.standard_normal((B, NH, hs, hs)) * 0.3 if state
          else np.zeros((B, NH, hs, hs))).astype(np.float32)
    return rkv + [lw, u, s0]


def _err(a, b):
    a = np.asarray(a, np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def _against_references(args, chunk):
    """wkv6_chunked_ref at ``chunk`` against wkv6_ref and the JAX model's
    wkv_chunked (at the same chunk) and wkv_scan."""
    t = list(map(torch.from_numpy, args))
    y, s = wkv6_chunked_ref(*t, chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y_ref, s_ref = wkv6_ref(*t)
    assert _err(y_ref, y) < WKV_ATOL and _err(s_ref, s) < WKV_ATOL
    j = list(map(jnp.asarray, args))
    for yj, sj in (JW.wkv_chunked(*j, chunk=chunk), JW.wkv_scan(*j)):
        assert _err(yj, y) < WKV_ATOL and _err(sj, s) < WKV_ATOL


@pytest.mark.parametrize("lw_min", [-3.0, -20.0])
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("B,NH,S,hs", WKV_SWEEP)
def test_chunked_ref_matches_model_from_a_state(B, NH, S, hs, chunk,
                                                lw_min):
    _against_references(_inputs(0, B, NH, S, hs, lw_min), chunk)


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("S", LENGTHS)
def test_chunked_ref_at_every_length(S, chunk):
    """Prompts shorter than a chunk, at its edges and one past them, and
    a 250-token prompt that ends inside its last chunk."""
    _against_references(_inputs(S, 2, 2, S, 16, -20.0), chunk)


@pytest.mark.parametrize("B,NH,S,hs", WKV_SWEEP)
def test_chunked_ref_matches_pallas_where_the_clamp_is_idle(B, NH, S, hs):
    chunk = 32
    r, k, v, lw, u, s0 = _inputs(1, B, NH, S, hs, -40.0 / chunk,
                                 state=False)
    heads_first = [jnp.asarray(np.ascontiguousarray(np.moveaxis(x, 1, 2)))
                   for x in (r, k, v, lw)]
    y_pal, s_pal = pallas_wkv6(*heads_first, jnp.asarray(u), chunk=chunk,
                               interpret=True)
    y, s = wkv6_chunked_ref(*map(torch.from_numpy, (r, k, v, lw, u, s0)),
                            chunk=chunk)
    assert _err(np.moveaxis(np.asarray(y_pal), 1, 2), y) < WKV_ATOL
    assert _err(s_pal, s) < WKV_ATOL


def test_two_factor_form_overflows_where_sub_chunks_do_not():
    """At lw = -20 the Pallas kernel's split of the intra-chunk decay,
    (r e^{cum_prev}) @ (k e^{-cum})^T, overflows inside one chunk of 32
    (e^{-cum} passes float32's range after 5 steps) and its causal mask
    turns inf * 0 into NaN; the sub-chunk factorization keeps every
    exponent <= 0 and stays finite and right."""
    r, k, v, lw, u, s0 = map(torch.from_numpy,
                             _inputs(2, 1, 2, 32, 16, -20.0))
    lw = torch.full_like(lw, -20.0)
    cum = torch.cumsum(lw, dim=1)
    naive = torch.einsum("bcnk,bsnk->bncs", r * torch.exp(cum - lw),
                         k * torch.exp(-cum))
    naive = naive * torch.tril(torch.ones(32, 32), diagonal=-1)
    assert not torch.isfinite(naive).all()
    y, s = wkv6_chunked_ref(r, k, v, lw, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y_ref, s_ref = wkv6_ref(r, k, v, lw, u, s0)
    assert _err(y_ref, y) < WKV_ATOL and _err(s_ref, s) < WKV_ATOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tf32x3_products_stay_within_tolerance(dtype):
    """The kernel's 3xTF32 rounding of every product, at rwkv6-3b's
    256-token prefill (1, 256, 40, 64) on chip_smoke.py's inputs: r, k, v
    standard normal (rounded to bf16 in the bf16 case), lw over
    [-3, -0.05], u and s0 at 0.3 x standard normal."""
    r, k, v, lw, u, s0 = map(torch.from_numpy,
                             _inputs(3, 1, 40, 256, 64, -3.0))
    if dtype == "bfloat16":
        r, k, v = (x.to(torch.bfloat16) for x in (r, k, v))
    y_ref, s_ref = wkv6_ref(r, k, v, lw, u, s0)
    y, s = wkv6_chunked_ref(r, k, v, lw, u, s0, tf32x3=True)
    tol = WKV_ATOL if dtype == "float32" else BF16_ATOL
    assert _err(y_ref, y) < tol and _err(s_ref, s) < tol


def test_tf32_round_is_round_to_nearest_away():
    """``tf32_round`` keeps 10 mantissa bits, ties away from zero, as
    cvt.rna.tf32.f32 does; a bf16 value is already a TF32 value."""
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([one, -one, 1.0, 1.0 + 2.0 ** -9, 3.0])
    assert torch.equal(tf32_round(x), want)
    b = torch.randn(1000).to(torch.bfloat16).float()
    assert torch.equal(tf32_round(b), b)


def test_route_follows_the_sequence_length():
    """The wrapper's route contract: a decode step (S = 1) takes the
    recurrence, any prefill (S > 1) the chunked kernels, whatever the
    other dimensions; the chunk is the kernel source's CHUNK; on a CPU
    tensor both take the plain recurrence."""
    assert not wkv_ops.chunked_route(1)
    assert all(wkv_ops.chunked_route(S) for S in (2, 31, 32, 33, 4096))
    src = CSRC.read_text()
    assert re.search(rf"constexpr int CHUNK = {wkv_ops.CHUNK};", src)
    assert [wkv_ops.n_chunks(S) for S in (1, 32, 33, 256, 250)] == \
        [1, 1, 2, 8, 8]
    for S in (1, 40):
        args = list(map(torch.from_numpy, _inputs(4, 1, 2, S, 8, -3.0)))
        y, s = wkv_ops.wkv6(*args)
        y_ref, s_ref = wkv6_ref(*args)
        assert torch.equal(y, y_ref) and torch.equal(s, s_ref)
