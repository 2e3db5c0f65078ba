"""The port's models (qwen2.5-3b, recurrentgemma-2b, rwkv6-3b, qwen3-32b
with qk_norm, qwen3-moe-30b-a3b with its MoE FFN) against the JAX model on
bridged params.

JAX's SMOKE params (``repro.models.model.init_params``) go through the
bridge; ``forward`` (logits and the MoE aux loss), ``prefill`` and
``decode_step`` logits must agree at atol 2e-4 (the tolerance of
test_archs.py's prefill/decode check), greedy decoding must give the same
tokens, and the caches they leave (KV buffers and recurrent states) must
agree too. The port's own model must also pass
test_archs.py::test_smoke_prefill_decode_matches_forward, and the bridge
must round-trip exactly, keeping the fp32 leaves of a bf16 model fp32.
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

ARCHS = ["qwen2.5-3b", "recurrentgemma-2b", "rwkv6-3b", "qwen3-32b",
         "qwen3-moe-30b-a3b"]
# archs whose bf16 models keep fp32 leaves (recurrent params and states,
# the MoE router)
MIXED_DTYPE_ARCHS = ["recurrentgemma-2b", "rwkv6-3b", "qwen3-moe-30b-a3b"]
ATOL = 2e-4
S, B = 24, 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.detach().float().numpy())))


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    cj, ct = jconfigs.get_smoke(request.param), \
        tconfigs.get_smoke(request.param)
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
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(_np_tree(pj)))
    assert TM.param_count(own) == n_jax
    assert ct.param_count() == cj.param_count()
    if set(ct.block_pattern) == {"global"}:      # the analytic count is exact
        assert TM.param_count(own) == ct.param_count()


def test_forward_matches_jax(bridged):
    cj, ct, pj, pt, toks = bridged
    lj, aux_j = JM.forward(pj, cj, jnp.asarray(toks))
    lt, aux_t = TM.forward(pt, ct, torch.from_numpy(toks))
    assert _max_err(lj, lt) < ATOL
    assert abs(float(aux_j) - float(aux_t)) < 2e-5
    assert (float(aux_t) > 0) == ("moe" in ct.block_pattern)


def test_greedy_tokens_match_jax(bridged):
    """Prefill, then greedy decoding fed by each side's own argmax: the
    same tokens at every step."""
    cj, ct, pj, pt, toks = bridged
    P, N = 12, 8
    cache_j = JM.init_cache(cj, B, P + N + 1)
    cache_t = TM.init_cache(ct, B, P + N + 1, device="cpu")
    lj, cache_j = JM.prefill(pj, cj, jnp.asarray(toks[:, :P]), cache_j)
    lt, cache_t = TM.prefill(pt, ct, torch.from_numpy(toks[:, :P]), cache_t)
    got_j, got_t = [], []
    for _ in range(N):
        tj = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        tt = torch.argmax(lt, dim=-1).to(torch.int32)
        got_j.append(tj.tolist())
        got_t.append(tt.tolist())
        lj, cache_j = JM.decode_step(pj, cj, jnp.asarray(tj), cache_j)
        lt, cache_t = TM.decode_step(pt, ct, tt, cache_t)
    assert got_t == got_j


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


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_decode_matches_forward(arch):
    """test_archs.py::test_smoke_prefill_decode_matches_forward, for the
    port's own model and params."""
    cfg = tconfigs.get_smoke(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_views_write_through(arch):
    cfg = tconfigs.get_smoke(arch)
    cache = TM.init_cache(cfg, 3, 8, device="cpu")
    sub = TM.cache_take_slot(cache, 1)
    bridge._map(lambda t: t.fill_(1), sub["cycles"])
    bridge._map(lambda t: t.fill_(2), sub["tail"])
    sub["pos"] = torch.full((1,), 5, dtype=torch.int32)
    TM.cache_put_slot(cache, 1, sub)
    assert cache["pos"].tolist() == [0, 5, 0]
    for part, val, ax in (("cycles", 1, 1), ("tail", 2, 0)):
        for t in jax.tree_util.tree_leaves(bridge._map(lambda t: t,
                                                       cache[part])):
            t = t.movedim(ax, 0)
            assert bool((t[1] == val).all())
            assert not bool(t[0].any()) and not bool(t[2].any())
    # zeroing a slot view clears that slot only
    TM.cache_zero(TM.cache_take_slot(cache, 1))
    assert cache["pos"].tolist() == [0, 0, 0]
    assert not any(bool(t.any()) for t in jax.tree_util.tree_leaves(
        bridge._map(lambda t: t, cache)))


def test_ring_buffer_wraps_like_jax():
    """recurrentgemma SMOKE (window 8): a 12-token prompt fills the local
    layers' ring from slot 12 % 8, and 10 decode steps wrap it again; the
    logits follow JAX's and the port's own full forward."""
    arch = "recurrentgemma-2b"
    cj, ct = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    assert ct.window_size == 8 and "local" in ct.block_pattern
    pj = JM.init_params(jax.random.PRNGKey(1), cj)
    pt = bridge.params_from_jax(_np_tree(pj), "cpu")
    P, N = 12, 10
    toks = np.random.default_rng(2).integers(
        0, cj.vocab_size, (B, P + N)).astype(np.int32)
    cache_j = JM.init_cache(cj, B, 32)
    cache_t = TM.init_cache(ct, B, 32, device="cpu")
    assert cache_t["cycles"][2]["k"].shape[2] == 8      # the ring, not 32
    lj, cache_j = JM.prefill(pj, cj, jnp.asarray(toks[:, :P]), cache_j)
    lt, cache_t = TM.prefill(pt, ct, torch.from_numpy(toks[:, :P]), cache_t)
    full, _ = TM.forward(pt, ct, torch.from_numpy(toks))
    assert _max_err(lj, lt) < ATOL
    assert float((lt - full[:, P - 1]).abs().max()) < ATOL
    for t in range(P, P + N):
        lj, cache_j = JM.decode_step(pj, cj, jnp.asarray(toks[:, t]),
                                     cache_j)
        lt, cache_t = TM.decode_step(pt, ct, torch.from_numpy(toks[:, t]),
                                     cache_t)
        assert _max_err(lj, lt) < ATOL
        assert float((lt - full[:, t]).abs().max()) < ATOL
    kj = np.asarray(cache_j["cycles"][2]["k"], np.float32)
    assert float(np.max(np.abs(kj - cache_t["cycles"][2]["k"].numpy()))) \
        < ATOL


@pytest.mark.parametrize("arch", MIXED_DTYPE_ARCHS)
def test_bridge_keeps_fp32_leaves_of_a_bf16_model(arch):
    """A bf16 model's param and cache trees cross the bridge with each
    leaf's dtype kept (log_lambda, the rwkv mix/decay/bonus params, ln_x,
    the recurrent states and the MoE router stay fp32) and come back
    exactly; the port allocates the same dtypes itself."""
    cj = jconfigs.get_smoke(arch).replace(param_dtype="bfloat16",
                                          activation_dtype="bfloat16")
    ct = tconfigs.get_smoke(arch).replace(param_dtype="bfloat16",
                                          activation_dtype="bfloat16")
    cpu = torch.device("cpu")
    pairs = ((JM.init_params(jax.random.PRNGKey(0), cj),
              TM.init_params(generator_for(cpu, 0), ct, device=cpu)),
             (JM.init_cache(cj, 2, 16), TM.init_cache(ct, 2, 16, device=cpu)))
    for i, (tree_j, own) in enumerate(pairs):
        src = _np_tree(tree_j)
        pt = bridge.params_from_jax(src, cpu)
        want = jax.tree_util.tree_map(lambda a: str(a.dtype), src)
        for t in (pt, own):
            got = bridge._map(lambda x: str(x.dtype).replace("torch.", ""), t)
            assert got == want
        if i == 0 or "moe" not in ct.block_pattern:   # an MoE cache is KV
            assert "float32" in jax.tree_util.tree_leaves(want)
        for a, b in zip(jax.tree_util.tree_leaves(src),
                        jax.tree_util.tree_leaves(bridge.params_to_numpy(pt))):
            np.testing.assert_array_equal(a.astype(np.float32), b)
