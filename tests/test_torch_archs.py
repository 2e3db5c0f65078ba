"""The five archs outside the testbed's default list — qwen1.5-4b (MHA,
QKV bias), gemma3-27b (5:1 local:global, qk_norm, local RoPE theta,
scaled and tied embeddings), llava-next-mistral-7b (a prefix of patch
embeddings), arctic-480b (MoE with a dense residual, G = 7 at full
width) and whisper-medium (encoder-decoder) — against the JAX model on
bridged SMOKE params, and test_archs.py's per-arch checks over all ten
archs on the port alone.

``forward``, ``prefill`` and ``decode_step`` logits agree at atol 2e-4
(tests/test_archs.py:106), greedy decoding gives the same tokens, and the
caches agree. Frame embeddings (whisper) and patch embeddings (llava,
``prefix_embeds``) come from a numpy seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import variants as jvariants  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import variants as tvariants  # noqa: E402
from repro_torch.device import generator_for  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

NEW_ARCHS = ["qwen1.5-4b", "gemma3-27b", "llava-next-mistral-7b",
             "arctic-480b", "whisper-medium"]
ATOL = 2e-4
S, B = 24, 2
CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.detach().float().numpy())))


def _extra(cfg, seed=1):
    """(B, P, d) frame (encoder-decoder) or patch embeddings from a numpy
    seed; None for a text-only arch."""
    n = (cfg.encoder_seq_len if cfg.is_encoder_decoder
         else cfg.num_patch_tokens)
    if not n:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)


def _both(a):
    return (None, None) if a is None else (jnp.asarray(a),
                                           torch.from_numpy(a))


@pytest.fixture(scope="module", params=NEW_ARCHS)
def bridged(request):
    cj, ct = jconfigs.get_smoke(request.param), \
        tconfigs.get_smoke(request.param)
    pj = JM.init_params(jax.random.PRNGKey(0), cj)
    pt = bridge.params_from_jax(_np_tree(pj), "cpu")
    toks = np.random.default_rng(0).integers(
        0, cj.vocab_size, (B, S)).astype(np.int32)
    return cj, ct, pj, pt, toks


@pytest.mark.parametrize("which", ["get_config", "get_smoke"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_is_a_copy(arch, which):
    a = getattr(jconfigs, which)(arch)
    b = getattr(tconfigs, which)(arch)
    assert {f: getattr(a, f) for f in a.__dataclass_fields__} == \
        {f: getattr(b, f) for f in b.__dataclass_fields__}
    ja = [(v.name, v.mem_bytes, v.accuracy) for v in
          jvariants.build_ladder(a)]
    ta = [(v.name, v.mem_bytes, v.accuracy) for v in
          tvariants.build_ladder(b)]
    assert ja == ta


def test_param_tree_layout_matches_jax(bridged):
    cj, ct, pj, pt, _ = bridged
    own = TM.init_params(generator_for(CPU, 0), ct, device="cpu")
    shapes_j = jax.tree_util.tree_map(lambda a: tuple(a.shape), _np_tree(pj))
    assert bridge._map(lambda t: tuple(t.shape), own) == shapes_j
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(_np_tree(pj)))
    assert TM.param_count(own) == n_jax
    assert ct.param_count() == cj.param_count()


def test_bridge_round_trip_is_exact(bridged):
    """Params, and a cache a JAX prefill filled (whisper's ``self`` and
    ``cross`` K/V included), go through the bridge and back bit for bit."""
    cj, _, pj, pt, toks = bridged
    cache = JM.init_cache(cj, B, S)
    _, cache = JM.prefill(pj, cj, jnp.asarray(toks[:, :8]), cache,
                          _both(_extra(cj))[0])
    for tree, torch_tree in ((pj, pt), (cache, None)):
        tree = _np_tree(tree)
        torch_tree = torch_tree or bridge.params_from_jax(tree, "cpu")
        back = bridge.params_to_numpy(torch_tree)
        assert jax.tree_util.tree_structure(tree) == \
            jax.tree_util.tree_structure(back)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(back)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_forward_matches_jax(bridged):
    cj, ct, pj, pt, toks = bridged
    ej, et = _both(_extra(cj))
    lj, aux_j = JM.forward(pj, cj, jnp.asarray(toks), ej)
    lt, aux_t = TM.forward(pt, ct, torch.from_numpy(toks), et)
    assert tuple(lt.shape) == tuple(lj.shape)
    assert _max_err(lj, lt) < ATOL
    assert abs(float(aux_j) - float(aux_t)) < 2e-5
    if cj.num_patch_tokens:                 # and without its prefix
        lj, _ = JM.forward(pj, cj, jnp.asarray(toks))
        lt, _ = TM.forward(pt, ct, torch.from_numpy(toks))
        assert _max_err(lj, lt) < ATOL


def test_prefill_decode_match_jax(bridged):
    """Logits within 2e-4 and the caches (KV, cross K/V, pos) equal up to
    the same tolerance."""
    _check_prefill_decode(*bridged, _extra(bridged[0]))


def test_llava_without_prefix_matches_jax():
    """llava served as the engine serves it: text tokens, no prefix."""
    cj = jconfigs.get_smoke("llava-next-mistral-7b")
    pj = JM.init_params(jax.random.PRNGKey(5), cj)
    pt = bridge.params_from_jax(_np_tree(pj), "cpu")
    toks = np.random.default_rng(6).integers(
        0, cj.vocab_size, (B, S)).astype(np.int32)
    _check_prefill_decode(cj, tconfigs.get_smoke("llava-next-mistral-7b"),
                          pj, pt, toks, None)


def _check_prefill_decode(cj, ct, pj, pt, toks, extra):
    """Prefill S - 2 tokens (after ``extra``), decode two: the logits of
    each call, and then the caches, as JAX's."""
    ej, et = _both(extra)
    P = 0 if extra is None or cj.is_encoder_decoder else extra.shape[1]
    cache_j = JM.init_cache(cj, B, S + 4 + P)
    cache_t = TM.init_cache(ct, B, S + 4 + P, device="cpu")
    lj, cache_j = JM.prefill(pj, cj, jnp.asarray(toks[:, :S - 2]), cache_j,
                             ej)
    lt, cache_t = TM.prefill(pt, ct, torch.from_numpy(toks[:, :S - 2]),
                             cache_t, et)
    errs = [_max_err(lj, lt)]
    for t in (S - 2, S - 1):
        lj, cache_j = JM.decode_step(pj, cj, jnp.asarray(toks[:, t]),
                                     cache_j)
        lt, cache_t = TM.decode_step(pt, ct, torch.from_numpy(toks[:, t]),
                                     cache_t)
        errs.append(_max_err(lj, lt))
    assert max(errs) < ATOL, errs
    leaves_j = jax.tree_util.tree_leaves(_np_tree(cache_j))
    leaves_t = jax.tree_util.tree_leaves(bridge.params_to_numpy(cache_t))
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        assert a.shape == b.shape
        assert np.max(np.abs(a.astype(np.float32) - b)) < ATOL
    assert cache_t["pos"].tolist() == [P + S] * B


def test_greedy_tokens_match_jax(bridged):
    """Prefill, then greedy decoding fed by each side's own argmax: the
    same tokens at every step (gemma3's window of 8 binds and its ring
    wraps)."""
    cj, ct, pj, pt, toks = bridged
    ej, et = _both(_extra(cj))
    P = cj.num_patch_tokens if not cj.is_encoder_decoder else 0
    Pr, N = 12, 8
    cache_j = JM.init_cache(cj, B, P + Pr + N + 1)
    cache_t = TM.init_cache(ct, B, P + Pr + N + 1, device="cpu")
    lj, cache_j = JM.prefill(pj, cj, jnp.asarray(toks[:, :Pr]), cache_j, ej)
    lt, cache_t = TM.prefill(pt, ct, torch.from_numpy(toks[:, :Pr]),
                             cache_t, et)
    got_j, got_t = [], []
    for _ in range(N):
        tj = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        tt = torch.argmax(lt, dim=-1).to(torch.int32)
        got_j.append(tj.tolist())
        got_t.append(tt.tolist())
        lj, cache_j = JM.decode_step(pj, cj, jnp.asarray(tj), cache_j)
        lt, cache_t = TM.decode_step(pt, ct, tt, cache_t)
    assert got_t == got_j


def test_gemma3_local_layers_use_local_theta():
    """A gemma3 ``local`` layer rotates at ``rope_theta_local`` (1e4), not
    ``rope_theta`` (1e6): the port's layer equals JAX's, and differs from
    the same layer rotated at the global theta."""
    cj, ct = jconfigs.get_smoke("gemma3-27b"), tconfigs.get_smoke(
        "gemma3-27b")
    assert ct.rope_theta_local == 1e4 and ct.rope_theta == 1e6
    lp = JM.init_layer(jax.random.PRNGKey(3), cj, "local")
    lt = bridge.params_from_jax(_np_tree(lp), "cpu")
    x = np.random.default_rng(2).standard_normal(
        (B, 6, cj.d_model)).astype(np.float32)
    pos = np.arange(6)[None, :]
    yj, _, _ = JM.layer_forward(lp, cj, "local", jnp.asarray(x),
                                jnp.asarray(pos))
    yt, _ = TM.layer_forward(lt, ct, "local", torch.from_numpy(x),
                             torch.from_numpy(pos))
    assert _max_err(yj, yt) < 1e-5
    y_global_theta, _ = TM.layer_forward(
        lt, ct.replace(rope_theta_local=0.0), "local", torch.from_numpy(x),
        torch.from_numpy(pos))
    assert float((y_global_theta - yt).abs().max()) > 1e-3
    q_loc, k_loc, _ = TL._qkv(lt["attn"], ct, torch.from_numpy(x),
                              torch.from_numpy(pos), theta=1e4)
    qj, kj, _ = JL._qkv(lp["attn"], cj, jnp.asarray(x), jnp.asarray(pos),
                        theta=1e4)
    assert _max_err(qj, q_loc) < 1e-5 and _max_err(kj, k_loc) < 1e-5
    q_none, _, _ = TL._qkv(lt["attn"], ct, torch.from_numpy(x),
                           torch.from_numpy(pos), rope_on=False)
    qj_none, _, _ = JL._qkv(lp["attn"], cj, jnp.asarray(x),
                            jnp.asarray(pos), rope_on=False)
    assert _max_err(qj_none, q_none) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax_tanh_gelu(dtype):
    """``gelu_mlp`` is ``jax.nn.gelu``'s default (tanh) form on an fp32
    upcast, then back to the activation dtype."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    pj = JL.init_gelu_mlp(jax.random.PRNGKey(1), 32, 96, jdt)
    pj = {**pj, "b_in": jnp.linspace(-1, 1, 96).astype(jdt),
          "b_out": jnp.linspace(1, -1, 32).astype(jdt)}
    pt = bridge.params_from_jax(_np_tree(pj), "cpu")
    x = np.random.default_rng(4).standard_normal((2, 5, 32)).astype(
        np.float32) * 3
    yj = JL.gelu_mlp(pj, jnp.asarray(x).astype(jdt))
    yt = TL.gelu_mlp(pt, torch.from_numpy(x).to(tdt))
    assert yt.dtype == tdt
    assert _max_err(yj, yt) < (1e-5 if dtype == "float32" else 3e-2)
    h = torch.linspace(-6, 6, 101)
    exact = torch.nn.functional.gelu(h)
    tanh = torch.nn.functional.gelu(h, approximate="tanh")
    assert np.allclose(np.asarray(jax.nn.gelu(jnp.asarray(h.numpy()))),
                       tanh.numpy(), atol=1e-6)
    assert float((exact - tanh).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# tests/test_archs.py's checks over all ten archs, on the port alone
# ---------------------------------------------------------------------------

def _port_batch(cfg):
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         dtype=torch.int32)
    extra = _extra(cfg)
    return toks, None if extra is None else torch.from_numpy(extra)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_smoke_forward_shapes(arch):
    cfg = tconfigs.get_smoke(arch)
    params = TM.init_params(generator_for(CPU, 0), cfg, device="cpu")
    toks, extra = _port_batch(cfg)
    logits, aux = TM.forward(params, cfg, toks, extra)
    exp = S + (0 if cfg.is_encoder_decoder else cfg.num_patch_tokens)
    assert tuple(logits.shape) == (B, exp, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any())
    assert not bool(torch.isnan(aux))


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_smoke_prefill_decode_matches_forward(arch):
    cfg = tconfigs.get_smoke(arch)
    params = TM.init_params(generator_for(CPU, 0), cfg, device="cpu")
    toks, extra = _port_batch(cfg)
    P = 0 if cfg.is_encoder_decoder else cfg.num_patch_tokens
    logits, _ = TM.forward(params, cfg, toks, extra)
    cache = TM.init_cache(cfg, B, S + 4 + P, device="cpu")
    lp, cache = TM.prefill(params, cfg, toks[:, :S - 1], cache, extra)
    ld, cache = TM.decode_step(params, cfg, toks[:, S - 1], cache)
    assert float((lp - logits[:, -2]).abs().max()) < ATOL
    assert float((ld - logits[:, -1]).abs().max()) < ATOL


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_param_count_sane(arch):
    cfg = tconfigs.get_config(arch)
    n = cfg.param_count()
    assert n > 1e8, f"{arch}: {n}"
    a = cfg.active_param_count()
    assert a <= n
    if cfg.num_experts:
        assert a < n
    assert n == jconfigs.get_config(arch).param_count()
