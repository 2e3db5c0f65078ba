"""The split-KV decode algorithm of the port's K2 and its host plan, on
the CPU.

``decode_attention_split_ref`` (``decode_attention/ref.py``) is the CUDA
kernel's algorithm in plain PyTorch: per-chunk partials (m, l, acc) over
fixed chunks of key positions and their merge in fixed split order. It is
held against the port's plain version, JAX's ``decode_attention_jnp`` and
the Pallas kernel in interpret mode, on the sweep of tests/test_kernels.py
and on the edges of the chunking: lens 1 and Smax, lens at a chunk
boundary +- 1, a window whose start falls inside a chunk, chunks with no
valid key, GQA groups of 1 and 32. Tolerances are those of
tests/test_kernels.py: f32 2e-5, bf16 2e-2. ``plan_split`` is held to its
contract: it depends on (B, KVH, Smax, n_sm) only and gives chunks of
whole 32-key tiles that cover the cache, none empty, at one to two waves
of blocks where Smax allows. K1's bf16 path rounds P to bf16 before the
PV product; an emulation of that rounding stays within the bf16
tolerance of the plain version.
"""

import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import \
    decode_attention as pallas_decode  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    NEG_INF, decode_attention_ref, decode_attention_split_ref)
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

DECODE_SWEEP = [                    # tests/test_kernels.py:42-46
    (3, 8, 2, 64, 200, 0),
    (2, 4, 1, 32, 64, 16),
    (1, 16, 16, 128, 300, 0),
]
# (B, H, KVH, hd, Smax, window, lens, chunk): the edges of the chunking
EDGES = [
    (2, 4, 2, 32, 128, 0, [1, 1], 32),                  # lens = 1
    (2, 4, 2, 32, 128, 0, [128, 128], 32),              # lens = Smax
    (3, 4, 2, 32, 160, 0, [63, 64, 65], 64),            # chunk edge +- 1
    (3, 4, 2, 32, 160, 0, [31, 32, 33], 32),
    (2, 4, 1, 64, 256, 40, [150, 200], 64),             # window start in
    (2, 4, 1, 64, 256, 100, [256, 101], 32),            # a chunk
    (2, 8, 2, 16, 512, 0, [3, 40], 32),                 # chunks all masked
    (2, 8, 2, 16, 512, 20, [500, 70], 64),              # on both sides
    (2, 3, 3, 64, 96, 0, [50, 96], 32),                 # G = 1
    (2, 32, 1, 32, 200, 0, [7, 199], 32),               # G = 32
    (1, 32, 1, 64, 300, 33, [300], 96),
]


def _inputs(seed, B, H, KVH, hd, Smax, dtype):
    """Same numbers for both frameworks (numpy normal -> dtype via JAX):
    q (B,1,H,hd) and caches (B,Smax,KVH,hd), as (jax, torch) pairs."""
    r = np.random.default_rng(seed)
    out = []
    for s in ((B, 1, H, hd), (B, Smax, KVH, hd), (B, Smax, KVH, hd)):
        a = jnp.asarray(r.standard_normal(s).astype(np.float32), JDT[dtype])
        out.append((a, torch.from_numpy(np.array(a.astype(jnp.float32)))
                    .to(TDT[dtype])))
    return out


def _err(a, b):
    a = np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()
    b = b.float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


def _split(qt, kt, vt, lens, window, chunk):
    return decode_attention_split_ref(qt[:, 0], kt.transpose(1, 2),
                                      vt.transpose(1, 2),
                                      torch.from_numpy(lens), window=window,
                                      chunk=chunk)


@pytest.mark.parametrize("chunk", [32, 64, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KVH,hd,Smax,window", DECODE_SWEEP)
def test_split_emulation_matches_jax_on_sweep(dtype, chunk, B, H, KVH, hd,
                                              Smax, window):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(11, B, H, KVH, hd, Smax, dtype)
    lens = np.random.default_rng(12).integers(1, Smax + 1, B).astype(
        np.int32)
    out, _ = _split(qt, kt, vt, lens, window, chunk)
    ref = decode_attention_ref(qt[:, 0], kt.transpose(1, 2),
                               vt.transpose(1, 2), torch.from_numpy(lens),
                               window=window)
    assert _err(ref, out) < ATOL[dtype]
    jnp_out = JL.decode_attention_jnp(qj, kj, vj, jnp.asarray(lens),
                                      window=window)
    assert _err(jnp_out[:, 0], out) < ATOL[dtype]
    pal = pallas_decode(qj, kj, vj, jnp.asarray(lens), window=window,
                        block_k=64, interpret=True)
    assert _err(pal[:, 0], out) < ATOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KVH,hd,Smax,window,lens,chunk", EDGES)
def test_split_emulation_edges(dtype, B, H, KVH, hd, Smax, window, lens,
                               chunk):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(13, B, H, KVH, hd, Smax, dtype)
    lens = np.asarray(lens, np.int32)
    out, (m, l, acc) = _split(qt, kt, vt, lens, window, chunk)
    ref = decode_attention_ref(qt[:, 0], kt.transpose(1, 2),
                               vt.transpose(1, 2), torch.from_numpy(lens),
                               window=window)
    assert _err(ref, out) < ATOL[dtype]
    jnp_out = JL.decode_attention_jnp(qj, kj, vj, jnp.asarray(lens),
                                      window=window)
    assert _err(jnp_out[:, 0], out) < ATOL[dtype]
    pal = pallas_decode(qj, kj, vj, jnp.asarray(lens), window=window,
                        block_k=32, interpret=True)
    assert _err(pal[:, 0], out) < ATOL[dtype]
    # a chunk with no valid key contributes exactly (NEG_INF, 0, 0); every
    # other chunk holds a finite max and a positive sum
    n_split = -(-Smax // chunk)
    starts = np.arange(n_split) * chunk
    for b, n in enumerate(lens):
        lo = max(0, n - window) if window else 0
        empty = (starts >= n) | (starts + chunk <= lo)
        e = torch.from_numpy(empty)
        assert torch.all(m[b][:, e] == NEG_INF)
        assert torch.all(l[b][:, e] == 0) and torch.all(acc[b][:, e] == 0)
        assert torch.all(m[b][:, ~e] > NEG_INF) and torch.all(l[b][:, ~e] > 0)


def test_split_output_of_a_row_depends_on_its_own_inputs():
    """Changing another slot's cache and lens leaves a slot's output
    bit-equal: the engine's tokens are held against a model run whose
    other slots hold other contents."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 8, 64, generator=g)
    k = torch.randn(3, 2, 256, 64, generator=g)
    v = torch.randn(3, 2, 256, 64, generator=g)
    lens = torch.tensor([70, 200, 33], dtype=torch.int32)
    a, _ = decode_attention_split_ref(q, k, v, lens, chunk=32)
    k2, v2 = k.clone(), v.clone()
    k2[1] = float("nan")
    v2[2, :, 40:] = float("nan")               # past lens[2]: never read
    b, _ = decode_attention_split_ref(
        q, k2, v2, torch.tensor([70, 5, 33], dtype=torch.int32), chunk=32)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


def test_plan_split_contract():
    assert list(inspect.signature(dec_ops.plan_split).parameters) == [
        "B", "KVH", "Smax", "n_sm"]
    tile = dec_ops.TILE_KEYS
    for n_sm in (1, 8, 66, 132):
        for B in (1, 2, 4, 16):
            for KVH in (1, 2, 8):
                for Smax in (1, 31, 32, 96, 100, 512, 700, 4096):
                    n_split, chunk = dec_ops.plan_split(B, KVH, Smax, n_sm)
                    assert (n_split, chunk) == dec_ops.plan_split(
                        B, KVH, Smax, n_sm)
                    assert chunk >= 1 and chunk % tile == 0
                    assert n_split * chunk >= Smax
                    assert (n_split - 1) * chunk < Smax   # none empty
                    blocks = B * KVH * n_split
                    tiles = -(-Smax // tile)
                    assert blocks >= min(n_sm, B * KVH * tiles)
                    assert blocks < 2 * n_sm + B * KVH


@pytest.mark.parametrize("B,KVH,Smax,want", [
    (4, 2, 512, (16, 32)),      # qwen2.5-3b :full decode: 128 blocks
    (4, 8, 512, (8, 64)),       # qwen3-32b :full: 256 blocks
    (4, 1, 512, (16, 32)),      # recurrentgemma-2b: 64 blocks
    (2, 2, 96, (3, 32)),        # the testbed's smoke rungs
])
def test_plan_split_main_path(B, KVH, Smax, want):
    assert dec_ops.plan_split(B, KVH, Smax, 132) == want


def _flash_p_bf16(q, k, v, *, causal, window):
    """K1's bf16 arithmetic in plain PyTorch: fp32 scores and softmax
    statistics, P rounded to bf16 before the PV product, l over fp32 P.
    q: (B,H,Sq,hd); k, v: (B,KVH,Skv,hd)."""
    B, H, Sq, hd = q.shape
    G = H // k.shape[1]
    kx = k.repeat_interleave(G, dim=1).float()
    vx = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) / math.sqrt(hd)
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(k.shape[2])[None, :]
    mask = torch.ones_like(qp >= kp)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vx)
    return (o / p.sum(-1, keepdim=True).clamp(min=1e-30)).to(q.dtype)


@pytest.mark.parametrize("B,Sq,H,KVH,hd,causal,window", [
    (2, 64, 4, 2, 32, True, 0),
    (1, 100, 4, 1, 64, True, 16),
    (2, 96, 8, 8, 32, False, 0),
    (1, 256, 16, 2, 128, True, 0),          # qwen2.5-3b :full, S=256
    (1, 300, 10, 1, 256, True, 256),        # recurrentgemma heads, window
])
def test_bf16_p_rounding_within_tolerance(B, Sq, H, KVH, hd, causal,
                                          window):
    g = torch.Generator().manual_seed(7)
    q = torch.randn(B, H, Sq, hd, generator=g).bfloat16()
    k = torch.randn(B, KVH, Sq, hd, generator=g).bfloat16()
    v = torch.randn(B, KVH, Sq, hd, generator=g).bfloat16()
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    emu = _flash_p_bf16(q, k, v, causal=causal, window=window)
    assert float((emu.float() - ref.float()).abs().max()) < ATOL["bfloat16"]
