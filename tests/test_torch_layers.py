"""The port's layers against ``repro.models.layers`` on the same numpy
inputs, at fp32. Tolerance: atol 1e-5 (fp32 transcendental and summation
order differences between XLA:CPU and PyTorch are ~1e-6 here)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _close(a_jax, b_torch, atol=ATOL):
    a = np.asarray(a_jax, np.float32)
    b = b_torch.detach().float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err < atol, err


@pytest.mark.parametrize("shape", [(2, 7, 64), (1, 24, 2048)])
def test_rmsnorm(shape):
    r = _rng(0)
    x = r.standard_normal(shape).astype(np.float32) * 3
    scale = r.standard_normal(shape[-1]).astype(np.float32)
    _close(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6),
           TL.rmsnorm({"scale": torch.from_numpy(scale)},
                      torch.from_numpy(x), 1e-6))


@pytest.mark.parametrize("hd,theta", [(16, 1e6), (128, 1e6), (64, 1e4)])
def test_rope(hd, theta):
    r = _rng(1)
    B, S, H = 2, 24, 3
    x = r.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = (r.integers(0, 200, (B, 1)) + np.arange(S)[None]).astype(np.int32)
    _close(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta),
           TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta))


def test_qkv_with_bias():
    cj = jconfigs.get_smoke("qwen2.5-3b")
    ct = tconfigs.get_smoke("qwen2.5-3b")
    assert cj.qkv_bias and ct.qkv_bias
    r = _rng(2)
    d, h, kv, hd = ct.d_model, ct.num_heads, ct.num_kv_heads, ct.head_dim
    p = {"wq": r.standard_normal((d, h, hd)) / 8,
         "wk": r.standard_normal((d, kv, hd)) / 8,
         "wv": r.standard_normal((d, kv, hd)) / 8,
         "bq": r.standard_normal((h, hd)),
         "bk": r.standard_normal((kv, hd)),
         "bv": r.standard_normal((kv, hd))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.standard_normal((2, 9, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)) + 5
    out_j = JL._qkv({k: jnp.asarray(v) for k, v in p.items()}, cj,
                    jnp.asarray(x), jnp.asarray(pos))
    out_t = TL._qkv({k: torch.from_numpy(v) for k, v in p.items()}, ct,
                    torch.from_numpy(x), torch.from_numpy(np.array(pos)))
    for a, b in zip(out_j, out_t):
        _close(a, b)


def test_swiglu():
    r = _rng(3)
    d, ff = 64, 128
    p = {"w_gate": r.standard_normal((d, ff)) / 8,
         "w_up": r.standard_normal((d, ff)) / 8,
         "w_down": r.standard_normal((ff, d)) / 11}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.standard_normal((2, 5, d)).astype(np.float32)
    _close(JL.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x)),
           TL.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x)))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_embed_unembed(softcap):
    r = _rng(4)
    V, d = 503, 64
    table = (r.standard_normal((V, d)) / 8).astype(np.float32)
    toks = r.integers(0, V, (2, 11)).astype(np.int32)
    ej = JL.embed({"table": jnp.asarray(table)}, jnp.asarray(toks))
    et = TL.embed({"table": torch.from_numpy(table)},
                  torch.from_numpy(toks))
    _close(ej, et)
    x = r.standard_normal((2, 3, d)).astype(np.float32)
    _close(JL.unembed({"table": jnp.asarray(table)}, jnp.asarray(x),
                      softcap),
           TL.unembed({"table": torch.from_numpy(table)},
                      torch.from_numpy(x), softcap))


@pytest.mark.parametrize("shape,eps", [((2, 7, 64), 1e-6), ((1, 9, 2560), 1e-5)])
def test_layernorm(shape, eps):
    r = _rng(5)
    x = r.standard_normal(shape).astype(np.float32) * 3 + 1
    p = {"scale": r.standard_normal(shape[-1]).astype(np.float32),
         "bias": r.standard_normal(shape[-1]).astype(np.float32)}
    _close(JL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), eps),
           TL.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), eps))
    init = TL.init_layernorm(shape[-1], torch.float32, "cpu")
    want = JL.init_layernorm(shape[-1], jnp.float32)
    for k in ("scale", "bias"):
        _close(want[k], init[k])


@pytest.mark.parametrize("S,window,H,KVH,hd,q_block", [
    (40, 8, 4, 1, 16, 16),          # recurrentgemma SMOKE-like, MQA
    (70, 24, 4, 2, 32, 32),         # ragged last q block
    (33, 32, 2, 2, 64, 512),        # one q block (q_block > S)
])
def test_banded_local_attention(S, window, H, KVH, hd, q_block):
    """The port's banded attention against JAX's, and against the windowed
    flash path it stands in for; ``flash_attention`` takes the band on the
    CPU exactly when the window binds."""
    r = _rng(6)
    q = r.standard_normal((2, S, H, hd)).astype(np.float32)
    k = r.standard_normal((2, S, KVH, hd)).astype(np.float32)
    v = r.standard_normal((2, S, KVH, hd)).astype(np.float32)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out = TL.banded_local_attention(qt, kt, vt, window=window,
                                    q_block=q_block)
    _close(JL.banded_local_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), window=window,
                                         q_block=q_block), out)
    windowed = TL.flash_attention_blocked(qt, kt, vt, causal=True,
                                          window=window, kv_block=128)
    assert float((windowed - out).abs().max()) < ATOL
    routed = TL.flash_attention(qt, kt, vt, causal=True, window=window)
    _close(JL.banded_local_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), window=window), routed)
