"""The port's qwen2.5-3b model against the JAX model on bridged params.

JAX's SMOKE params (``repro.models.model.init_params``) go through the
bridge; ``forward``, ``prefill`` and ``decode_step`` logits must agree
at atol 2e-4 (the tolerance of test_archs.py's prefill/decode check),
and the caches they leave must agree too. The port's own model must
also pass test_archs.py::test_smoke_prefill_decode_matches_forward, and
the bridge must round-trip exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.device import generator_for  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCH = "qwen2.5-3b"
ATOL = 2e-4
S, B = 24, 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.detach().float().numpy())))


@pytest.fixture(scope="module")
def bridged():
    cj, ct = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    pj = JM.init_params(jax.random.PRNGKey(0), cj)
    pt = bridge.params_from_jax(_np_tree(pj), "cpu")
    toks = np.random.default_rng(0).integers(
        0, cj.vocab_size, (B, S)).astype(np.int32)
    return cj, ct, pj, pt, toks


def test_param_tree_layout_matches_jax(bridged):
    cj, ct, pj, pt, _ = bridged
    own = TM.init_params(generator_for(torch.device("cpu"), 0), ct,
                         device="cpu")
    shapes_j = jax.tree_util.tree_map(lambda a: tuple(a.shape), _np_tree(pj))
    shapes_t = bridge._map(lambda t: tuple(t.shape), own)
    assert shapes_t == shapes_j
    assert TM.param_count(own) == ct.param_count() == cj.param_count()


def test_forward_matches_jax(bridged):
    cj, ct, pj, pt, toks = bridged
    lj, _ = JM.forward(pj, cj, jnp.asarray(toks))
    lt, _ = TM.forward(pt, ct, torch.from_numpy(toks))
    assert _max_err(lj, lt) < ATOL


def test_prefill_decode_match_jax(bridged):
    cj, ct, pj, pt, toks = bridged
    cache_j = JM.init_cache(cj, B, S + 4)
    cache_t = TM.init_cache(ct, B, S + 4, device="cpu")
    lj, cache_j = JM.prefill(pj, cj, jnp.asarray(toks[:, :S - 2]), cache_j)
    lt, cache_t = TM.prefill(pt, ct, torch.from_numpy(toks[:, :S - 2]),
                             cache_t)
    assert _max_err(lj, lt) < ATOL
    for t in (S - 2, S - 1):
        lj, cache_j = JM.decode_step(pj, cj, jnp.asarray(toks[:, t]),
                                     cache_j)
        lt, cache_t = TM.decode_step(pt, ct, torch.from_numpy(toks[:, t]),
                                     cache_t)
        assert _max_err(lj, lt) < ATOL
    leaves_j = jax.tree_util.tree_leaves(_np_tree(cache_j))
    leaves_t = jax.tree_util.tree_leaves(bridge.params_to_numpy(cache_t))
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        assert a.shape == b.shape
        assert float(np.max(np.abs(a.astype(np.float32) - b))) < ATOL


def test_smoke_prefill_decode_matches_forward():
    """test_archs.py::test_smoke_prefill_decode_matches_forward, for the
    port's own model and params."""
    cfg = tconfigs.get_smoke(ARCH)
    params = TM.init_params(generator_for(torch.device("cpu"), 0), cfg,
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    logits, _ = TM.forward(params, cfg, toks)
    cache = TM.init_cache(cfg, B, S + 4, device="cpu")
    lp, cache = TM.prefill(params, cfg, toks[:, :S - 1], cache)
    ld, cache = TM.decode_step(params, cfg, toks[:, S - 1], cache)
    assert torch.allclose(lp, logits[:, -2], atol=ATOL), \
        float((lp - logits[:, -2]).abs().max())
    assert torch.allclose(ld, logits[:, -1], atol=ATOL), \
        float((ld - logits[:, -1]).abs().max())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bridge_round_trip_is_exact(bridged, dtype):
    _, _, pj, _, _ = bridged
    src = _np_tree(jax.tree_util.tree_map(lambda a: a.astype(dtype), pj))
    pt = bridge.params_from_jax(src, "cpu")
    want = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    assert all(t.dtype == want for t in jax.tree_util.tree_leaves(
        bridge._map(lambda t: t, pt)))
    back = bridge.params_to_numpy(pt)
    leaves_a = jax.tree_util.tree_leaves(src)
    leaves_b = jax.tree_util.tree_leaves(back)
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(a.astype(np.float32), b)


def test_slot_views_write_through():
    cfg = tconfigs.get_smoke(ARCH)
    cache = TM.init_cache(cfg, 3, 8, device="cpu")
    sub = TM.cache_take_slot(cache, 1)
    sub["cycles"][0]["k"].fill_(1.0)
    sub["pos"] = torch.full((1,), 5, dtype=torch.int32)
    TM.cache_put_slot(cache, 1, sub)
    assert cache["pos"].tolist() == [0, 5, 0]
    k = cache["cycles"][0]["k"]
    assert bool((k[:, 1] == 1).all()) and not bool(k[:, 0].any())
