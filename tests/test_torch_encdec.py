"""The port's encoder-decoder backbone (``repro_torch.models.encdec``,
whisper-medium) piece by piece against ``repro/models/encdec.py`` on
bridged SMOKE params; its slot cache views; the engine's handling of an
encoder-decoder model (warmup without a prefill, a request refused by
name); llava's prefix prefill; and a CPU testbed run of the four
decoder-only archs outside the testbed's default list whose failover
choices equal the JAX simulator's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.experiment import ExperimentSpec as JaxSpec  # noqa: E402
from repro.experiment import run_experiment as run_jax  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.device import generator_for  # noqa: E402
from repro_torch.experiment import ExperimentSpec, run_experiment  # noqa: E402
from repro_torch.experiment.cli import main as cli_main  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.engine import InferenceEngine, Request  # noqa: E402

ARCH = "whisper-medium"
ATOL = 2e-4
B, S = 2, 10
CPU = torch.device("cpu")
DECODER_ONLY = ["qwen1.5-4b", "gemma3-27b", "llava-next-mistral-7b",
                "arctic-480b"]
TESTBED = dict(scenario="single-server", app_mix="arch", archs=DECODER_ONLY,
               n_sites=3, servers_per_site=2, headroom=0.35, client_hz=20.0,
               time_scale=0.25, settle_s=25.0, seed=1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.detach().float().numpy())))


@pytest.fixture(scope="module")
def whisper():
    cj, ct = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    pj = JM.init_params(jax.random.PRNGKey(0), cj)
    pt = bridge.params_from_jax(_np_tree(pj), "cpu")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal(
        (B, cj.encoder_seq_len, cj.d_model)).astype(np.float32)
    x = rng.standard_normal((B, S, cj.d_model)).astype(np.float32)
    return cj, ct, pj, pt, frames, x


def _layer_j(pj, i):
    return jax.tree_util.tree_map(lambda t: t[i], pj["dec_layers"])


def test_encode_and_cross_kv_match_jax(whisper):
    cj, ct, pj, pt, frames, _ = whisper
    ej = JE.encode(pj, cj, jnp.asarray(frames))
    et = TE.encode(pt, ct, torch.from_numpy(frames))
    assert _err(ej, et) < 1e-5
    for i in range(cj.num_decoder_layers):
        kj, vj = JE._cross_kv(_layer_j(pj, i), cj, ej)
        kt, vt = TE._cross_kv(TE._layer(pt["dec_layers"], i), ct, et)
        assert tuple(kt.shape) == (B, cj.encoder_seq_len, cj.num_kv_heads,
                                   cj.head_dim)
        assert _err(kj, kt) < 1e-5 and _err(vj, vt) < 1e-5


def test_decoder_layer_matches_jax(whisper):
    """A decoder layer over a full sequence (cross K/V from the encoder
    output), then one step at ragged positions against the cache it left;
    outputs and caches as JAX's."""
    cj, ct, pj, pt, frames, x = whisper
    enc_j = JE.encode(pj, cj, jnp.asarray(frames))
    enc_t = TE.encode(pt, ct, torch.from_numpy(frames))
    pos = np.arange(S)[None, :]
    lj, lt = _layer_j(pj, 1), TE._layer(pt["dec_layers"], 1)
    yj, _ = JE._dec_layer_fwd(lj, cj, jnp.asarray(x), jnp.asarray(pos),
                              enc_out=enc_j)
    yt = TE._dec_layer_fwd(lt, ct, torch.from_numpy(x),
                           torch.from_numpy(pos), enc_out=enc_t)
    assert _err(yj, yt) < 1e-5
    # prefill S - 2 tokens into a cache of S slots, then a step each
    cache_j = {"k": jnp.zeros((B, S, cj.num_kv_heads, cj.head_dim)),
               "v": jnp.zeros((B, S, cj.num_kv_heads, cj.head_dim))}
    cache_t = {k: torch.zeros(tuple(v.shape)) for k, v in cache_j.items()}
    kvj = JE._cross_kv(lj, cj, enc_j)
    kvt = TE._cross_kv(lt, ct, enc_t)
    n = S - 2
    yj, cache_j = JE._dec_layer_fwd(lj, cj, jnp.asarray(x[:, :n]),
                                    jnp.asarray(pos[:, :n]), cross_kv=kvj,
                                    cache=cache_j)
    yt = TE._dec_layer_fwd(lt, ct, torch.from_numpy(x[:, :n]),
                           torch.from_numpy(pos[:, :n]), cross_kv=kvt,
                           cache=cache_t)
    assert _err(yj, yt) < 1e-5
    step = np.array([n, n - 3], np.int32)          # ragged decode positions
    xs = x[:, n:n + 1]
    yj, cache_j = JE._dec_layer_fwd(lj, cj, jnp.asarray(xs),
                                    jnp.asarray(step[:, None]),
                                    cross_kv=kvj, cache=cache_j,
                                    decode_pos=jnp.asarray(step))
    yt = TE._dec_layer_fwd(lt, ct, torch.from_numpy(xs),
                           torch.from_numpy(step[:, None]), cross_kv=kvt,
                           cache=cache_t, decode_pos=torch.from_numpy(step))
    assert _err(yj, yt) < 1e-5
    for name in ("k", "v"):
        assert _err(cache_j[name], cache_t[name]) < 1e-5


def test_whisper_cache_slot_views():
    """A slot view cuts axis 1 of ``self`` and ``cross`` (axis 0 is the
    decoder layer) and axis 0 of ``pos``; writes through it land in the
    cache, ``cache_zero`` clears only that slot, and ``cache_put_slot``
    copies a view that is not one."""
    cfg = tconfigs.get_smoke(ARCH)
    cache = TM.init_cache(cfg, 3, 16, device="cpu")
    n_dec, kvh, hd = cfg.num_decoder_layers, cfg.num_kv_heads, cfg.head_dim
    assert tuple(cache["self"]["k"].shape) == (n_dec, 3, 16, kvh, hd)
    assert tuple(cache["cross"]["v"].shape) == (n_dec, 3, cfg.encoder_seq_len,
                                                kvh, hd)
    TM._tree_map(lambda t: t.fill_(1), cache)
    sub = TM.cache_take_slot(cache, 1)
    assert tuple(sub["self"]["k"].shape) == (n_dec, 1, 16, kvh, hd)
    assert tuple(sub["cross"]["k"].shape) == (n_dec, 1, cfg.encoder_seq_len,
                                              kvh, hd)
    assert tuple(sub["pos"].shape) == (1,)
    TM.cache_zero(sub)
    for leaf in (cache["self"]["k"], cache["self"]["v"],
                 cache["cross"]["k"], cache["cross"]["v"]):
        assert float(leaf[:, 1].abs().sum()) == 0
        assert bool((leaf[:, [0, 2]] == 1).all())
    assert cache["pos"].tolist() == [1, 0, 1]
    other = TM._tree_map(lambda t: torch.full_like(t, 7), sub)
    TM.cache_put_slot(cache, 2, other)
    assert bool((cache["cross"]["k"][:, 2] == 7).all())
    assert bool((cache["self"]["v"][:, 2] == 7).all())
    assert cache["pos"].tolist() == [1, 0, 7]
    assert bool((cache["self"]["k"][:, 0] == 1).all())


def test_whisper_slot_prefill_matches_batched(whisper):
    """A prefill through a slot view of a batched cache, then a batched
    decode step: the slot's logits as those of the same request alone."""
    cj, ct, pj, pt, frames, _ = whisper
    toks = np.random.default_rng(3).integers(0, ct.vocab_size, (B, S))
    toks = torch.from_numpy(toks.astype(np.int32))
    fr = torch.from_numpy(frames)
    alone = TM.init_cache(ct, 1, S + 2, device="cpu")
    la, alone = TM.prefill(pt, ct, toks[1:, :S - 1], alone, fr[1:])
    da, _ = TM.decode_step(pt, ct, toks[1:, S - 1], alone)
    cache = TM.init_cache(ct, B, S + 2, device="cpu")
    sub = TM.cache_zero(TM.cache_take_slot(cache, 1))
    ls, sub = TM.prefill(pt, ct, toks[1:, :S - 1], sub, fr[1:])
    TM.cache_put_slot(cache, 1, sub)
    ds, _ = TM.decode_step(pt, ct, toks[:, S - 1], cache)
    assert float((ls - la).abs().max()) < 1e-5
    assert float((ds[1] - da[0]).abs().max()) < 1e-5


def test_engine_warmup_skips_prefill_and_refuses_encdec_requests(
        monkeypatch):
    cfg = tconfigs.get_smoke(ARCH)
    params = TM.init_params(generator_for(CPU, 0), cfg, device="cpu")
    calls = []
    for name in ("prefill", "decode_step"):
        fn = getattr(TM, name)
        monkeypatch.setattr(TM, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    eng = InferenceEngine(cfg, params, batch_slots=2, max_len=16,
                          device="cpu")
    eng.warmup()
    assert calls == ["decode_step"]
    with pytest.raises(NotImplementedError, match="frame embeddings"):
        eng.try_admit(Request(id="r", prompt=np.arange(4, dtype=np.int32)))
    assert eng.active_count() == 0
    # a decoder-only model warms up with both
    calls.clear()
    qcfg = tconfigs.get_smoke("qwen1.5-4b")
    InferenceEngine(qcfg, TM.init_params(generator_for(CPU, 0), qcfg,
                                         device="cpu"),
                    batch_slots=2, max_len=16, device="cpu").warmup()
    assert calls == ["decode_step", "prefill"]


def test_llava_prefix_prefill_advances_pos_past_the_prefix():
    cfg = tconfigs.get_smoke("llava-next-mistral-7b")
    params = TM.init_params(generator_for(CPU, 0), cfg, device="cpu")
    P = cfg.num_patch_tokens
    prefix = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, P, cfg.d_model)).astype(np.float32))
    toks = torch.arange(5, dtype=torch.int32)[None]
    cache = TM.init_cache(cfg, 1, P + 8, device="cpu")
    logits, cache = TM.prefill(params, cfg, toks, cache, prefix)
    assert cache["pos"].tolist() == [P + 5]
    full, _ = TM.forward(params, cfg, toks, prefix)
    assert tuple(full.shape) == (1, P + 5, cfg.vocab_size)
    assert float((logits - full[:, -1]).abs().max()) < ATOL
    # the first decoded token lands after the prefix and the prompt
    nxt = torch.argmax(logits, -1).to(torch.int32)
    step, cache = TM.decode_step(params, cfg, nxt, cache)
    full2, _ = TM.forward(params, cfg, torch.cat([toks, nxt[:, None]], 1),
                          prefix)
    assert float((step - full2[:, -1]).abs().max()) < ATOL
    assert cache["pos"].tolist() == [P + 6]


def test_testbed_serves_the_new_decoder_archs_like_the_jax_sim(capsys):
    """The live testbed on the CPU, qwen1.5-4b, gemma3-27b,
    llava-next-mistral-7b and arctic-480b served by worker threads
    (``python -m repro_torch run --backend testbed --device cpu --archs
    ...``): the same failover choices as the JAX simulator, no load error
    (exit 0), every app's clients answered."""
    jax_sim = run_jax(JaxSpec(backend="sim", **TESTBED))
    rc = cli_main(["run", "--backend", "testbed", "--device", "cpu",
                   "--archs", ",".join(DECODER_ONLY), "--scenario",
                   "single-server", "--sites", "3", "--servers-per-site",
                   "2", "--headroom", "0.35", "--client-hz", "20",
                   "--time-scale", "0.25", "--settle", "25", "--seed", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    for app, (ok, mode, variant) in jax_sim.recovery_by_app().items():
        assert any(app in ln and ("ok " if ok else "DOWN") in ln
                   and mode in ln and ln.endswith(variant)
                   for ln in out.splitlines()), (app, out)
    tb = run_experiment(ExperimentSpec(backend="testbed", device="cpu",
                                       **TESTBED))
    assert tb.recovery_by_app() == jax_sim.recovery_by_app()
    assert tb.overall["recovery_rate"] == 1.0
    assert tb.extras["load_errors"] == []
    stats = tb.extras["client_stats"]
    assert {a.split("-app")[0] for a in stats} == set(DECODER_ONLY)
    assert all(st.ok > 0 for st in stats.values())


def test_prefill_with_other_frame_counts_matches_jax(whisper):
    """Frames other than ``encoder_seq_len`` (the dry run's prefill_32k
    feeds S frames): the cross cache takes their length, as the JAX
    prefill's new cache does; logits and a decode step after it within
    ``ATOL`` of JAX's."""
    cj, ct, pj, pt, _, _ = whisper
    rng = np.random.default_rng(7)
    toks = rng.integers(0, ct.vocab_size, (B, S)).astype(np.int32)
    for T in (cj.encoder_seq_len // 2, cj.encoder_seq_len + 8):
        frames = rng.standard_normal((B, T, cj.d_model)).astype(np.float32)
        cache_j = JM.init_cache(cj, B, S + 2)
        lj, cache_j = JM.prefill(pj, cj, jnp.asarray(toks[:, :S - 1]),
                                 cache_j, jnp.asarray(frames))
        dj, _ = JM.decode_step(pj, cj, jnp.asarray(toks[:, S - 1]), cache_j)
        cache_t = TM.init_cache(ct, B, S + 2, device="cpu")
        lt, cache_t = TM.prefill(pt, ct, torch.from_numpy(toks[:, :S - 1]),
                                 cache_t, torch.from_numpy(frames))
        dt, _ = TM.decode_step(pt, ct, torch.from_numpy(toks[:, S - 1]),
                               cache_t)
        assert tuple(cache_t["cross"]["k"].shape) == \
            tuple(cache_j["cross"]["k"].shape) == \
            (cj.num_decoder_layers, B, T, cj.num_kv_heads, cj.head_dim)
        assert _err(lj, lt) < ATOL and _err(dj, dt) < ATOL
