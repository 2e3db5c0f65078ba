"""Prefill (K1) and decode (K2) attention of the port against the JAX
package, on the sweeps of tests/test_kernels.py.

On the CPU the port's ``layers.flash_attention``/``decode_attention`` run
the ports of ``flash_attention_jnp``/``decode_attention_jnp``; they are
held against those functions and against the Pallas kernels run in
interpret mode, as tests/test_kernels.py runs them. The plain versions in
``ref.py`` are held against the JAX oracles. Tolerances are those of
tests/test_kernels.py: f32 2e-5, bf16 2e-2 (one bf16 ulp of an O(1)
output is 2^-7..2^-6). The CUDA kernels against their plain versions run
only on the card, in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import \
    decode_attention as pallas_decode  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as pallas_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

FLASH_SWEEP = [                     # tests/test_kernels.py:18-23
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 100, 100, 4, 1, 64, True, 16),
    (2, 96, 96, 8, 8, 32, False, 0),
    (1, 33, 33, 2, 2, 128, True, 8),
]
DECODE_SWEEP = [                    # tests/test_kernels.py:42-46
    (3, 8, 2, 64, 200, 0),
    (2, 4, 1, 32, 64, 16),
    (1, 16, 16, 128, 300, 0),
]


def _inputs(seed, shapes, dtype):
    """Same numbers for both frameworks: numpy normal -> bf16 via JAX, so
    the torch copy is the exact bf16 value."""
    r = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a = jnp.asarray(r.standard_normal(s).astype(np.float32),
                        JDT[dtype])
        t = torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            TDT[dtype])
        out.append((a, t))
    return out


def _err(a_jax, b_torch):
    a = np.asarray(jnp.asarray(a_jax, jnp.float32))
    b = b_torch.float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,hd,causal,window", FLASH_SWEEP)
def test_flash_attention_cpu_matches_jax(dtype, B, Sq, Skv, H, KVH, hd,
                                         causal, window):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        0, [(B, Sq, H, hd), (B, Skv, KVH, hd), (B, Skv, KVH, hd)], dtype)
    out = TL.flash_attention(qt, kt, vt, causal=causal, window=window)
    blk = min(1024, max(128, Sq))
    jnp_out = JL.flash_attention_jnp(qj, kj, vj, causal=causal,
                                     window=window, kv_block=blk)
    assert _err(jnp_out, out) < ATOL[dtype]
    pal = pallas_flash(qj, kj, vj, causal=causal, window=window,
                       block_q=32, block_k=32, interpret=True)
    assert _err(pal, out) < ATOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KVH,hd,Smax,window", DECODE_SWEEP)
def test_decode_attention_cpu_matches_jax(dtype, B, H, KVH, hd, Smax,
                                          window):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        1, [(B, 1, H, hd), (B, Smax, KVH, hd), (B, Smax, KVH, hd)], dtype)
    lens = np.random.default_rng(2).integers(1, Smax + 1, B).astype(np.int32)
    out = TL.decode_attention(qt, kt, vt, torch.from_numpy(lens),
                              window=window)
    jnp_out = JL.decode_attention_jnp(qj, kj, vj, jnp.asarray(lens),
                                      window=window)
    assert _err(jnp_out, out) < ATOL[dtype]
    pal = pallas_decode(qj, kj, vj, jnp.asarray(lens), window=window,
                        block_k=64, interpret=True)
    assert _err(pal, out) < ATOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,hd,causal,window", FLASH_SWEEP)
def test_flash_ref_matches_jax_ref(dtype, B, Sq, Skv, H, KVH, hd, causal,
                                   window):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        3, [(B, H, Sq, hd), (B, KVH, Skv, hd), (B, KVH, Skv, hd)], dtype)
    out = flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    ref = attention_ref(qj, kj, vj, causal=causal, window=window)
    assert _err(ref, out) < ATOL[dtype]
    # the wrapper's CPU path is that plain version, on the model layout
    wrapped = fa_ops.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                                     vt.transpose(1, 2), causal=causal,
                                     window=window)
    assert torch.equal(wrapped.transpose(1, 2), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KVH,hd,Smax,window", DECODE_SWEEP)
def test_decode_ref_matches_jax_ref(dtype, B, H, KVH, hd, Smax, window):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        4, [(B, H, hd), (B, KVH, Smax, hd), (B, KVH, Smax, hd)], dtype)
    lens = np.random.default_rng(5).integers(1, Smax + 1, B).astype(np.int32)
    out = decode_attention_ref(qt, kt, vt, torch.from_numpy(lens),
                               window=window)
    ref = jax_decode_ref(qj, kj, vj, jnp.asarray(lens), window=window)
    assert _err(ref, out) < ATOL[dtype]
    wrapped = dec_ops.decode_attention(qt[:, None], kt.transpose(1, 2),
                                       vt.transpose(1, 2),
                                       torch.from_numpy(lens), window=window)
    assert torch.equal(wrapped[:, 0], out)


def test_wrappers_reject_bad_input():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 3, 32)                 # 4 heads on 3 kv heads
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), q.half()[:, :, :2],
                               q.half()[:, :, :2])
    with pytest.raises(ValueError):
        dec_ops.decode_attention(q[:, :1], q[:, :, :2], q[:, :, :2],
                                 torch.ones(2, dtype=torch.int32))
