"""K6, the weight-only int8 matmul: the port's plain version and its
quantizer against the JAX package.

``int8_matmul_torch`` (what the wrapper runs on a CPU tensor, and what
K6 is held against on the card) against the JAX kernel in interpret
mode and its jnp oracle, on the sweep of tests/test_kernels.py:102-104,
within 10x the kernel tolerances (f32 2e-4, bf16 0.2); ``quantize_int8``
equal to JAX's bit for bit, codes and scales. The CUDA kernel's split-K
algorithm (``int8_matmul_splitk_ref``) against the same, at the plans
``plan_splitk`` gives; ``plan_splitk`` held to its contract.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.int8_matmul.int8_matmul import \
    quantize_int8 as jax_quantize  # noqa: E402
from repro.kernels.int8_matmul.ops import int8_matmul as jax_int8  # noqa: E402
from repro.kernels.int8_matmul.ref import int8_matmul_ref  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as k6  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import \
    int8_matmul_splitk_ref  # noqa: E402

ATOL10 = {"float32": 2e-4, "bfloat16": 0.2}
SWEEP = [(100, 300, 200), (64, 128, 64), (33, 65, 130)]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(M, K, N, dtype, seed=4):
    """x in ``dtype`` and a quantized w, made with numpy and JAX's
    quantizer; returned as (jax, torch) triples."""
    rng = np.random.default_rng(seed)
    xj = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32),
                     JDT[dtype])
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    wq, sc = jax_quantize(jnp.asarray(w))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(TDT[dtype])
    return ((xj, wq, sc),
            (xt, torch.from_numpy(np.array(wq)), torch.from_numpy(
                np.array(sc))))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a.astype(jnp.float32))
                               - b.float().numpy())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", SWEEP)
def test_plain_version_matches_jax_kernel_and_oracle(dtype, M, K, N):
    (xj, wqj, scj), (xt, wqt, sct) = _inputs(M, K, N, dtype)
    plain = k6.int8_matmul_torch(xt, wqt, sct)
    assert plain.dtype == TDT[dtype] and plain.shape == (M, N)
    kern = jax_int8(xj, wqj, scj, block_m=32, block_n=64, block_k=128,
                    interpret=True)
    assert _err(kern, plain) < ATOL10[dtype]
    assert _err(int8_matmul_ref(xj, wqj, scj), plain) < ATOL10[dtype]
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    n0 = k6.LAUNCHES
    assert torch.equal(k6.int8_matmul(xt, wqt, sct), plain)
    assert k6.LAUNCHES == n0


@pytest.mark.parametrize("shape,scale", [((256, 128), 0.1), ((130, 65), 0.05),
                                         ((7, 300), 3.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_is_bit_equal_to_jax(shape, scale, dtype):
    rng = np.random.default_rng(5)
    w = rng.standard_normal(shape).astype(np.float32) * scale
    w[:, 3] = 0.0                        # an all-zero channel: the 1e-8 floor
    w[0, 5] = 127.5 * (np.abs(w[1:, 5]).max() / 127.0)   # a half-way code
    wj = jnp.asarray(w, JDT[dtype])
    qj, sj = jax_quantize(wj)
    qt, st = k6.quantize_int8(torch.from_numpy(
        np.array(wj.astype(jnp.float32))).to(TDT[dtype]))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.numpy().tobytes() == np.asarray(sj).tobytes()
    assert float(st[3]) == np.float32(1e-8)


def test_quantize_int8_other_axis_matches_jax():
    w = np.random.default_rng(6).standard_normal((40, 24)).astype(
        np.float32)
    qj, sj = jax_quantize(jnp.asarray(w), axis=1)
    qt, st = k6.quantize_int8(torch.from_numpy(w), axis=1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.numpy().tobytes() == np.asarray(sj).tobytes()


def test_wrapper_checks_its_inputs():
    x = torch.zeros((4, 8))
    wq = torch.zeros((8, 16), dtype=torch.int8)
    sc = torch.ones(16)
    assert k6.int8_matmul(x, wq, sc, out_dtype=torch.bfloat16).dtype == \
        torch.bfloat16
    with pytest.raises(ValueError):
        k6.int8_matmul(x, wq[:7], sc)
    with pytest.raises(ValueError):
        k6.int8_matmul(x, wq, sc[:15])
    with pytest.raises(TypeError):
        k6.int8_matmul(x, wq.float(), sc)
    with pytest.raises(TypeError):
        k6.int8_matmul(x.double(), wq, sc)
    with pytest.raises(TypeError):
        k6.int8_matmul(x, wq, sc.double())


def test_plan_splitk_contract():
    assert list(inspect.signature(k6.plan_splitk).parameters) == [
        "M", "N", "K", "n_sm"]
    tile = k6.TILE_K
    for n_sm in (1, 8, 66, 132):
        for M in (1, 4, 16, 17, 256):
            for N in (8, 130, 1024, 5120, 25600):
                for K in (1, 31, 65, 300, 5120, 25600):
                    n, chunk = k6.plan_splitk(M, N, K, n_sm)
                    assert (n, chunk) == k6.plan_splitk(M, N, K, n_sm)
                    assert chunk >= 1 and chunk % tile == 0
                    assert n * chunk >= K and (n - 1) * chunk < K
                    bm, bn = (k6.DECODE_TILE if M <= k6.DECODE_M
                              else k6.PREFILL_TILE)
                    tiles = -(-M // bm) * -(-N // bn)
                    if tiles >= k6.SPLIT_WAVES * n_sm:
                        assert n == 1        # the tiles fill the card
                    if n == 1:
                        continue
                    # each range at least MIN_SPLIT_STEPS stages long, and
                    # no more blocks than the aim needs
                    assert chunk // tile >= k6.MIN_SPLIT_STEPS
                    assert tiles * (n - 1) < k6.SPLIT_WAVES * n_sm
                    assert n <= -(-K // tile)


@pytest.mark.parametrize("M,N,K,want", [
    (4, 25600, 5120, (3, 1728)),     # qwen3-32b gate/up, decode: 600
    (4, 5120, 25600, (14, 1856)),    # down: 560 blocks
    (256, 25600, 5120, (1, 5120)),   # prefill: 800 tiles, one range
    (256, 5120, 25600, (4, 6400)),   # 160 tiles: 640 blocks
    (33, 130, 65, (1, 96)),          # the sweep
])
def test_plan_splitk_main_path(M, N, K, want):
    assert k6.plan_splitk(M, N, K, 132) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", SWEEP + [(4, 5120, 1024), (4, 2048, 130),
                                           (1, 1000, 256), (16, 4096, 640)])
def test_splitk_emulation_matches_jax_kernel(dtype, M, K, N):
    (xj, wqj, scj), (xt, wqt, sct) = _inputs(M, K, N, dtype, seed=7)
    n, chunk = k6.plan_splitk(M, N, K, 132)
    for n_split, k_chunk in {(n, chunk), (1, -(-K // 32) * 32)}:
        emu = int8_matmul_splitk_ref(xt, wqt, sct, n_split, k_chunk)
        assert emu.dtype == TDT[dtype]
        assert _err(int8_matmul_ref(xj, wqj, scj), emu) < ATOL10[dtype]
        assert float((emu.float() - k6.int8_matmul_torch(
            xt, wqt, sct).float()).abs().max()) < ATOL10[dtype]
    if M * K * N <= 4 * 2048 * 130:
        kern = jax_int8(xj, wqj, scj, block_m=32, block_n=64, block_k=128,
                        interpret=True)
        assert _err(kern, int8_matmul_splitk_ref(xt, wqt, sct, n, chunk)) \
            < ATOL10[dtype]
