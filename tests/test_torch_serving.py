"""The port's serving runtime on the CPU: engine consistency (mirrors of
tests/test_serving.py), greedy tokens equal to the JAX engine's at fp32 on
bridged params (qwen2.5-3b), a reused slot giving the JAX model's fresh
tokens (the recurrent archs, where the JAX engine leaks state between
requests), and a WorkerServer pair that fails over from the full model to
its warm w050 replica."""

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.heartbeat import FailureDetector, WallClock  # noqa: E402
from repro_torch.core.variants import Application, build_ladder  # noqa: E402
from repro_torch.device import generator_for  # noqa: E402
from repro_torch.models import model as MDL  # noqa: E402
from repro_torch.serving.engine import InferenceEngine, Request  # noqa: E402
from repro_torch.serving.router import Router  # noqa: E402
from repro_torch.serving.server import WorkerServer  # noqa: E402

ARCH = "qwen2.5-3b"
ARCHS = [ARCH, "recurrentgemma-2b", "rwkv6-3b"]
CPU = torch.device("cpu")


def _params(cfg, seed=0):
    return MDL.init_params(generator_for(CPU, seed), cfg, device=CPU)


def _drain(eng):
    while eng.active_count():
        eng.step()


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_forward(arch):
    cfg = configs.get_smoke(arch)
    params = _params(cfg)
    eng = InferenceEngine(cfg, params, batch_slots=2, max_len=48,
                          device=CPU)
    prompt = np.arange(1, 9, dtype=np.int32)
    req = Request(id="r", prompt=prompt, max_new_tokens=3)
    assert eng.try_admit(req)
    _drain(eng)
    assert len(req.tokens) == 1 + 3
    # greedy decode must match the model's own prefill+decode
    cache = MDL.init_cache(cfg, 1, 48, device=CPU)
    logits, cache = MDL.prefill(params, cfg, torch.from_numpy(prompt)[None],
                                cache)
    toks = [int(torch.argmax(logits[0]))]
    for _ in range(3):
        logits, cache = MDL.decode_step(
            params, cfg, torch.tensor([toks[-1]], dtype=torch.int32), cache)
        toks.append(int(torch.argmax(logits[0])))
    assert req.tokens == toks


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_slot_reuse_and_concurrency(arch):
    cfg = configs.get_smoke(arch)
    eng = InferenceEngine(cfg, _params(cfg), batch_slots=2, max_len=48,
                          device=CPU)
    reqs = [Request(id=f"r{i}", prompt=np.arange(1, 9, dtype=np.int32),
                    max_new_tokens=2) for i in range(4)]
    assert eng.try_admit(reqs[0])
    assert eng.try_admit(reqs[1])
    assert not eng.try_admit(reqs[2])       # slots full
    _drain(eng)
    assert eng.try_admit(reqs[2])           # slot freed
    assert eng.try_admit(reqs[3])
    _drain(eng)
    for r in reqs:
        assert len(r.tokens) == 3
    # same prompt, same params -> identical greedy outputs across slots
    assert reqs[0].tokens == reqs[1].tokens == reqs[2].tokens


def test_engine_tokens_equal_jax_engine():
    """Same bridged fp32 params, same requests: same greedy tokens."""
    cj, ct = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    pj = JM.init_params(jax.random.PRNGKey(3), cj)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), CPU)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cj.vocab_size, n).astype(np.int32)
               for n in (5, 11, 8, 16)]
    jeng = JaxEngine(cj, pj, batch_slots=2, max_len=48)
    teng = InferenceEngine(ct, pt, batch_slots=2, max_len=48, device=CPU)
    outs = []
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        reqs = [req_cls(id=f"r{i}", prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for pair in (reqs[:2], reqs[2:]):
            for r in pair:
                assert eng.try_admit(r)
            _drain(eng)
        outs.append([r.tokens for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_reused_slot_tokens_equal_jax_model(arch):
    """Each request's greedy tokens, served on slots that earlier requests
    used and that sat through decode steps while empty, equal the JAX
    model's own prefill + decode from a fresh cache. (The JAX engine does
    not pass this: it resets only ``pos`` on admission.)"""
    cj, ct = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    pj = JM.init_params(jax.random.PRNGKey(0), cj)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), CPU)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cj.vocab_size, n).astype(np.int32)
               for n in (5, 11, 8, 16, 3)]
    n_new = (8, 3, 6, 5, 6)
    eng = InferenceEngine(ct, pt, batch_slots=2, max_len=48, device=CPU)
    reqs = [Request(id=f"r{i}", prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    for group in (reqs[:2], reqs[2:4], reqs[4:]):
        for r in group:
            assert eng.try_admit(r)
        _drain(eng)
    prefill = jax.jit(JM.prefill, static_argnums=1)
    decode = jax.jit(JM.decode_step, static_argnums=1)
    for r in reqs:
        cache = JM.init_cache(cj, 1, 48)
        logits, cache = prefill(pj, cj, jax.numpy.asarray(r.prompt[None]),
                                cache)
        want = [int(np.argmax(logits[0]))]
        for _ in range(r.max_new_tokens):
            logits, cache = decode(
                pj, cj, jax.numpy.asarray([want[-1]], np.int32), cache)
            want.append(int(np.argmax(logits[0])))
        assert r.tokens == want, r.id


def _wait(pred, timeout=60.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.005)
    return True


@pytest.mark.parametrize("arch", ARCHS)
def test_worker_pair_fails_over_to_warm_replica(arch):
    cfg = configs.get_smoke(arch)
    ladder = build_ladder(cfg)
    app = Application(id="app0", family=cfg.name, variants=ladder)
    full, w050 = app.full, app.variant_by_name(f"{cfg.name}:w050")
    det = FailureDetector(WallClock(), interval=0.020)
    router = Router()
    a = WorkerServer("a", det, batch_slots=2, max_len=48, device=CPU).start()
    b = WorkerServer("b", det, batch_slots=2, max_len=48, device=CPU).start()
    try:
        assert a.load(app, full) > 0 and b.load(app, w050) > 0
        assert a.has(full.name) and b.has(w050.name)
        router.set_route(app.id, "a", full.name)
        router.set_backup(app.id, "b", w050.name)
        servers = {"a": a, "b": b}

        def serve(tag):
            sid, variant = router.lookup(app.id)
            reqs = [Request(id=f"{tag}{i}",
                            prompt=np.arange(1, 6 + i, dtype=np.int32),
                            max_new_tokens=4) for i in range(2)]
            for r in reqs:
                assert servers[sid].submit(variant, r)
            assert _wait(lambda: all(r.done_at for r in reqs))
            assert all(len(r.tokens) == 1 + 4 for r in reqs)
            return reqs

        serve("before")
        a.kill()
        assert not a.has(full.name)
        assert not a.submit(full.name, Request(id="x", prompt=np.ones(3)))
        newly = []
        assert _wait(lambda: newly.extend(det.sweep()) or "a" in newly,
                     timeout=5.0)
        assert "b" not in det.failed
        router.set_route(app.id, *router.lookup_backup(app.id))
        assert router.lookup(app.id) == ("b", w050.name)
        serve("after")
    finally:
        for w in (a, b):
            w.kill()
            w.join()
    assert not any(t.is_alive() for w in (a, b) for t in w._threads)


def test_concurrent_submits_match_sequential_tokens():
    """Many client threads admit (prefill) while the worker thread decodes
    on the same in-place cache. A lost or torn slot update would change
    some request's greedy tokens away from its sequential reference."""
    cfg = configs.get_smoke(ARCH)
    params = _params(cfg, seed=5)
    prompts = [np.arange(1, 4 + i % 5, dtype=np.int32) * (1 + i % 3)
               for i in range(12)]

    ref_eng = InferenceEngine(cfg, params, batch_slots=2, max_len=48,
                              device=CPU)
    ref = {}
    for p in prompts:
        if p.tobytes() not in ref:
            r = Request(id="ref", prompt=p, max_new_tokens=4)
            assert ref_eng.try_admit(r)
            _drain(ref_eng)
            ref[p.tobytes()] = r.tokens

    det = FailureDetector(WallClock())
    w = WorkerServer("w", det, batch_slots=2, max_len=48, device=CPU).start()
    w.install("m", InferenceEngine(cfg, params, batch_slots=2, max_len=48,
                                   device=CPU))
    reqs = [Request(id=f"c{i}", prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]

    def client(mine):
        for r in mine:
            while not w.submit("m", r):
                time.sleep(0.0005)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(reqs[i::6],))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert _wait(lambda: all(r.done_at for r in reqs), timeout=60)
    finally:
        sys.setswitchinterval(old)
        w.kill()
        w.join()
    for r in reqs:
        assert r.tokens == ref[r.prompt.tobytes()], r.id
