#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; no arguments

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

0. device: the card's name and power limit, TF32 off;
1. build: both CUDA kernels from ``src/repro_torch/kernels/*/csrc``;
2. kernels: K1 (prefill flash attention) and K2 (decode attention)
   against their plain PyTorch versions on the sweeps of
   tests/test_kernels.py (f32 2e-5, bf16 2e-2) and at the main path's
   bf16 shapes, timed beside the plain version and beside PyTorch's
   ``scaled_dot_product_attention`` (a yardstick the port never calls);
3. model parity: qwen2.5-3b at full width, 2 layers, fp32 — prefill and
   two decode steps on the card (kernels) against the CPU (plain path);
4. serve and fail over: worker A serves qwen2.5-3b:full (36 layers, bf16)
   to 4 requests, its tokens are held against the model's own
   prefill/decode, A is killed, the heartbeat detector reports it, the
   router moves the app to worker B's warm qwen2.5-3b:w050 and B serves
   the same requests. Kernel launch counters are zeroed before and read
   after each serving run.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches, error, times and bound.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): HBM rate and bf16 tensor-core rate;
# the main path's kernels run in bf16
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_ATOL = 1e-3          # fp32 model parity, card vs CPU
SEED = 0

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
# (variant, H, KVH) of the qwen2.5-3b ladder rungs served on the main path
MAIN_HEADS = [("full", 16, 2), ("w075", 12, 2), ("w050", 8, 1)]
PREFILL_LENS = (128, 256, 512)
SLOTS, MAX_LEN, NEW_TOKENS = 4, 512, 32
# name -> (source, TPU kernel it replaces, headline shape of the JSON line:
# prefill at the top of the main path's prompt range, decode over 4 slots)
KERNELS = {
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:29",
        ("full", 256)),
    "decode_attention": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:27",
        ("full", MAX_LEN)),
}


def log(*a):
    print(*a, flush=True)


def eager_ms(fn, n=30, warmup=5):
    """Median time of one eager call in ms, from a CUDA event before it to
    one after it: the device time, or the host's time to issue the call
    when that is longer (Python, checks, launch)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


def graph_ms(fn, reps=20, n=20, warmup=3):
    """Device time of one call in ms: ``reps`` calls captured in one CUDA
    graph, the graph replayed ``n`` times between CUDA events, the median
    replay divided by ``reps``. No host work lies between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)


def bound(nbytes, flops):
    """Least time in ms for the card to move ``nbytes`` and do ``flops``
    bf16 operations, and which of the two bounds it."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else
            "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels():
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_ref as fa_ref

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def rnd(shape, dt):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    def flash_plain(q, k, v, causal, window):
        return fa_ref(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal,
                      window=window).transpose(1, 2)

    def dec_plain(q, kc, vc, lens, window):
        return dec_ref(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2),
                       lens, window=window)[:, None]

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    for name, dt in dts.items():
        for B, Sq, Skv, H, KVH, hd, causal, window in FLASH_SWEEP:
            q, k, v = (rnd((B, Sq, H, hd), dt), rnd((B, Skv, KVH, hd), dt),
                       rnd((B, Skv, KVH, hd), dt))
            e = err(fa_ops.flash_attention(q, k, v, causal=causal,
                                           window=window),
                    flash_plain(q, k, v, causal, window))
            log(f"  sweep flash_attention {name} B={B} S={Sq} H={H} "
                f"KVH={KVH} hd={hd} causal={causal} window={window}: "
                f"max_abs_err {e:.3g}")
            if not e < ATOL[name]:
                raise AssertionError(f"flash_attention sweep err {e}")
        for B, H, KVH, hd, Smax, window in DECODE_SWEEP:
            q, kc, vc = (rnd((B, 1, H, hd), dt), rnd((B, Smax, KVH, hd), dt),
                         rnd((B, Smax, KVH, hd), dt))
            lens = torch.randint(1, Smax + 1, (B,), generator=g, device=dev,
                                 dtype=torch.int32)
            e = err(dec_ops.decode_attention(q, kc, vc, lens, window=window),
                    dec_plain(q, kc, vc, lens, window))
            log(f"  sweep decode_attention {name} B={B} H={H} KVH={KVH} "
                f"hd={hd} Smax={Smax} window={window}: max_abs_err {e:.3g}")
            if not e < ATOL[name]:
                raise AssertionError(f"decode_attention sweep err {e}")

    # main-path shapes, bf16
    bf16, hd = torch.bfloat16, 128
    rows = {"flash_attention": {}, "decode_attention": {}}
    for variant, H, KVH in MAIN_HEADS:
        for S in PREFILL_LENS:
            q, k, v = (rnd((1, S, H, hd), bf16), rnd((1, S, KVH, hd), bf16),
                       rnd((1, S, KVH, hd), bf16))
            out = fa_ops.flash_attention(q, k, v, causal=True)
            e = err(out, flash_plain(q, k, v, True, 0))
            if not e < ATOL["bfloat16"]:
                raise AssertionError(f"flash_attention {variant} S={S}: {e}")
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), \
                v.transpose(1, 2)
            kern = functools.partial(fa_ops.flash_attention, q, k, v,
                                     causal=True)
            ms, eager = graph_ms(kern), eager_ms(kern)
            plain = graph_ms(lambda: flash_plain(q, k, v, True, 0))
            lib = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            flops = 4 * hd * H * S * (S + 1) // 2
            b_ms, b_by = bound(nbytes, flops)
            rows["flash_attention"][(variant, S)] = dict(
                shape=f"q (1,{S},{H},{hd}) k/v (1,{S},{KVH},{hd}) bf16 "
                      "causal", max_abs_err=e, ms=ms, eager_ms=eager,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        # decode: 4 slots against a 512-token cache, ragged lens
        q = rnd((SLOTS, 1, H, hd), bf16)
        kc, vc = (rnd((SLOTS, MAX_LEN, KVH, hd), bf16),
                  rnd((SLOTS, MAX_LEN, KVH, hd), bf16))
        lens = torch.tensor([97, 161, 288, 512], dtype=torch.int32,
                            device=dev)
        out = dec_ops.decode_attention(q, kc, vc, lens)
        e = err(out, dec_plain(q, kc, vc, lens, 0))
        if not e < ATOL["bfloat16"]:
            raise AssertionError(f"decode_attention {variant}: {e}")
        mask = (torch.arange(MAX_LEN, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        kern = functools.partial(dec_ops.decode_attention, q, kc, vc,
                                 lens)
        ms, eager = graph_ms(kern), eager_ms(kern)
        plain = graph_ms(lambda: dec_plain(q, kc, vc, lens, 0))
        lib = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        n_keys = int(lens.sum())
        nbytes = 2 * (2 * q.numel() + 2 * n_keys * KVH * hd) + 4 * SLOTS
        flops = 4 * hd * H * n_keys
        b_ms, b_by = bound(nbytes, flops)
        rows["decode_attention"][(variant, MAX_LEN)] = dict(
            shape=f"q ({SLOTS},1,{H},{hd}) cache ({SLOTS},{MAX_LEN},{KVH},"
                  f"{hd}) bf16 lens {lens.tolist()}", max_abs_err=e, ms=ms,
            eager_ms=eager, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib)
    for kname, by_shape in rows.items():
        for (variant, S), r in by_shape.items():
            log(f"  {kname} {variant} [{r['shape']}]: device ms kernel "
                f"{r['ms']:.5f}, plain {r['plain_ms']:.5f}, library "
                f"{r['library_ms']:.5f}, bound {r['bound_ms']:.5f} "
                f"({r['bound_by']}); eager call {r['eager_ms']:.5f} ms; "
                f"max_abs_err {r['max_abs_err']:.3g}")
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# Phase 3: fp32 model parity, card (kernels) vs CPU (plain path)
# ---------------------------------------------------------------------------

def phase_parity():
    from repro_torch import bridge
    from repro_torch.configs.qwen2_5_3b import CONFIG
    from repro_torch.device import generator_for
    from repro_torch.models import model as MDL

    cfg = CONFIG.replace(num_layers=2, param_dtype="float32",
                         activation_dtype="float32")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    params = MDL.init_params(generator_for(cuda, SEED), cfg, device=cuda)
    params_cpu = bridge.params_from_jax(bridge.params_to_numpy(params), cpu)
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    caches = {d: MDL.init_cache(cfg, 2, 32, device=d) for d in (cuda, cpu)}
    worst = 0.0
    with torch.inference_mode():
        lg, _ = MDL.prefill(params, cfg, torch.from_numpy(toks).to(cuda),
                            caches[cuda])
        lc, _ = MDL.prefill(params_cpu, cfg, torch.from_numpy(toks),
                            caches[cpu])
        for step in range(3):
            e = float((lg.cpu() - lc).abs().max())
            worst = max(worst, e)
            tg, tc = lg.argmax(-1).cpu(), lc.argmax(-1)
            log(f"  {'prefill' if step == 0 else f'decode {step}'}: logits "
                f"max_abs_err {e:.3g}, greedy card {tg.tolist()} "
                f"cpu {tc.tolist()}")
            if not e < LOGIT_ATOL or not torch.equal(tg, tc):
                raise AssertionError("card and CPU disagree")
            if step == 2:
                break
            lg, _ = MDL.decode_step(params, cfg, tg.to(cuda), caches[cuda])
            lc, _ = MDL.decode_step(params_cpu, cfg, tc, caches[cpu])
    torch.cuda.synchronize()
    return worst


# ---------------------------------------------------------------------------
# Phase 4: serve on the full model, kill it, fail over to the warm w050
# ---------------------------------------------------------------------------


def serve(server, variant, prompts, timeout=600.0):
    """Submit every prompt to ``server`` and wait for all of them."""
    from repro_torch.serving.engine import Request

    reqs = []
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        r = Request(id=f"{server.id}-{i}", prompt=p,
                    max_new_tokens=NEW_TOKENS, submitted_at=time.monotonic())
        if not server.submit(variant, r):
            raise AssertionError(f"{server.id} refused request {i}")
        reqs.append(r)
    while not all(r.done_at for r in reqs):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{server.id}: requests did not finish")
        time.sleep(0.002)
    for r in reqs:
        if len(r.tokens) != 1 + NEW_TOKENS:
            raise AssertionError(f"{r.id}: {len(r.tokens)} tokens")
    return reqs, t0


def mirror_tokens(MDL, eng, prompt):
    """The model's own prefill + decode_step for one request, batched over
    the engine's slots as the engine batches it (row 0 holds the request),
    so the matrix products have the engine's shapes."""
    cfg, dev = eng.cfg, eng.device
    with torch.inference_mode():
        cache = MDL.init_cache(cfg, eng.batch_slots, eng.max_len, device=dev)
        sub = MDL.cache_take_slot(cache, 0)
        sub["pos"] = torch.zeros((1,), dtype=torch.int32, device=dev)
        logits, sub = MDL.prefill(eng.params, cfg,
                                  torch.as_tensor(prompt, device=dev)[None],
                                  sub)
        MDL.cache_put_slot(cache, 0, sub)
        toks = [int(torch.argmax(logits[0]))]
        for _ in range(NEW_TOKENS):
            tok = torch.zeros((eng.batch_slots,), dtype=torch.int32,
                              device=dev)
            tok[0] = toks[-1]
            logits, cache = MDL.decode_step(eng.params, cfg, tok, cache)
            toks.append(int(torch.argmax(logits[0])))
    return toks


def step_breakdown(MDL, eng, prompt_len=256, n=10):
    """Where a serving step's time goes, on the engine's own params: the
    host wall of an eager call (ending in a synchronize) against the device
    time of the same call replayed from a CUDA graph. Decode runs over all
    slots at ragged positions; prefill is one prompt of ``prompt_len``."""
    cfg, dev = eng.cfg, eng.device
    out = {}
    with torch.inference_mode():
        cache = MDL.init_cache(cfg, SLOTS, MAX_LEN, device=dev)
        cache["pos"].copy_(torch.tensor([97, 161, 288, 400]))
        tok = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)
        sub = MDL.cache_take_slot(cache, 0)
        sub["pos"] = torch.zeros((1,), dtype=torch.int32, device=dev)
        prompt = torch.zeros((1, prompt_len), dtype=torch.int32, device=dev)
        calls = {
            "decode_step": functools.partial(MDL.decode_step, eng.params,
                                             cfg, tok, cache),
            f"prefill_{prompt_len}": functools.partial(
                MDL.prefill, eng.params, cfg, prompt, sub)}
        for name, fn in calls.items():
            walls = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            out[f"{name}_wall_ms"] = statistics.median(walls)
            out[f"{name}_device_ms"] = graph_ms(fn, reps=1, n=n,
                                                warmup=1)
    return out


def phase_serve():
    from repro_torch.configs.qwen2_5_3b import CONFIG as cfg
    from repro_torch.core.heartbeat import FailureDetector, WallClock
    from repro_torch.core.variants import Application, build_ladder
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as MDL
    from repro_torch.serving.router import Router
    from repro_torch.serving.server import WorkerServer

    app = Application(id="qwen2.5-3b/app0", family=cfg.name,
                      variants=build_ladder(cfg))
    full, w050 = app.full, app.variant_by_name(f"{cfg.name}:w050")
    det = FailureDetector(WallClock(), interval=0.020)
    router = Router()
    workers = {sid: WorkerServer(sid, det, batch_slots=SLOTS,
                                 max_len=MAX_LEN).start()
               for sid in ("A", "B")}
    res = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        res["load_s_A_full"] = workers["A"].load(app, full)
        res["load_s_B_w050"] = workers["B"].load(app, w050)
        log(f"  load: A {full.name} {res['load_s_A_full']:.3f} s, "
            f"B {w050.name} {res['load_s_B_w050']:.3f} s")
        eng_a = workers["A"].engines[full.name]
        eng_b = workers["B"].engines[w050.name]
        n_params = MDL.param_count(eng_a.params)
        log(f"  {full.name}: {n_params} params, {cfg.num_layers} layers, "
            f"d_model {cfg.d_model}, vocab {cfg.vocab_size}")
        if (cfg.num_layers, cfg.d_model, cfg.vocab_size) != (36, 2048,
                                                              151936):
            raise AssertionError("not the full-width qwen2.5-3b")
        router.set_route(app.id, "A", full.name)
        router.set_backup(app.id, "B", w050.name)

        rng = np.random.default_rng(SEED)
        lens = rng.integers(64, 257, SLOTS)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
        launches = {}

        def run(tag, eng):
            sid, variant = router.lookup(app.id)
            steps0 = eng.steps
            fa_ops.LAUNCHES = 0
            dec_ops.LAUNCHES = 0
            reqs, t0 = serve(workers[sid], variant, prompts)
            k1, k2 = fa_ops.LAUNCHES, dec_ops.LAUNCHES
            steps = eng.steps - steps0
            n_layers = eng.cfg.num_layers
            log(f"  {tag}: served {len(reqs)} requests on {sid} {variant}; "
                f"launches flash_attention {k1}, decode_attention {k2}, "
                f"decode steps {steps}")
            if k1 != n_layers * len(reqs) or k2 != n_layers * steps \
                    or steps < NEW_TOKENS:
                raise AssertionError(f"{tag}: launches do not match the "
                                     "path (once per layer per prefill / "
                                     "decode step)")
            launches[tag] = {"flash_attention": k1, "decode_attention": k2}
            wall = max(r.done_at for r in reqs) - t0
            res[f"tokens_per_s_{tag}"] = sum(len(r.tokens)
                                             for r in reqs) / wall
            return reqs

        reqs_a = run("A", eng_a)
        mirror = mirror_tokens(MDL, eng_a, prompts[0])
        if reqs_a[0].tokens != mirror:
            raise AssertionError(f"engine tokens {reqs_a[0].tokens} != "
                                 f"model prefill+decode {mirror}")
        log(f"  A's engine tokens for request 0 equal the model's own "
            f"prefill + decode_step ({len(mirror)} tokens)")
        res["A_steps"] = step_breakdown(MDL, eng_a)
        log(f"  A {full.name} step breakdown: {json.dumps(res['A_steps'])}")

        t_kill = time.monotonic()
        workers["A"].kill()
        detected = []
        while "A" not in detected:
            if time.monotonic() - t_kill > 5.0:
                raise TimeoutError("the detector never reported A")
            detected += det.sweep()
            time.sleep(0.001)
        res["detect_s"] = time.monotonic() - t_kill
        if detected != ["A"]:
            log(f"  note: the sweep also reported {detected}")
        router.set_route(app.id, *router.lookup_backup(app.id))
        if router.lookup(app.id) != ("B", w050.name):
            raise AssertionError("router did not move the app to B")
        reqs_b = run("B", eng_b)
        res["failover_ttft_s"] = min(r.first_token_at for r in reqs_b) \
            - t_kill
        res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        log(f"  detection latency {res['detect_s'] * 1e3:.2f} ms; kill to "
            f"B's first token {res['failover_ttft_s'] * 1e3:.2f} ms; "
            f"tokens/s A {res['tokens_per_s_A']:.1f}, B "
            f"{res['tokens_per_s_B']:.1f}; max_memory_allocated "
            f"{res['max_memory_allocated_bytes'] / 2**30:.3f} GiB")
    finally:
        for w in workers.values():
            w.kill()
            w.join()
    return res, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    t_start = time.monotonic()
    log("phase 0: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    log("phase 1: build")
    t0 = time.monotonic()
    secs = _build.build(list(KERNELS))
    log(f"  built {sorted(secs)} in {time.monotonic() - t0:.2f} s "
        f"(per kernel {json.dumps({k: round(v, 2) for k, v in secs.items()})})")

    log("phase 2: kernels against their plain versions")
    rows = phase_kernels()

    log("phase 3: fp32 model parity, card vs CPU (qwen2.5-3b, 2 layers)")
    worst = phase_parity()
    log(f"  worst logits max_abs_err {worst:.3g} (< {LOGIT_ATOL})")

    log("phase 4: serve qwen2.5-3b:full, kill it, fail over to w050")
    res, launches = phase_serve()
    log("  " + json.dumps({"serve": res}))
    st = res["A_steps"]
    for name in ("decode_step", "prefill_256"):
        wall, devt = st[f"{name}_wall_ms"], st[f"{name}_device_ms"]
        log(f"  {name} on qwen2.5-3b:full: host wall {wall:.3f} ms, device "
            f"{devt:.3f} ms, device idle share {1 - devt / wall:.3f}")

    kernels = []
    for name, (src, replaces, headline) in KERNELS.items():
        r = rows[name][headline]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches["A"][name],
            "max_abs_err": max(x["max_abs_err"] for x in rows[name].values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    log(f"  total {time.monotonic() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
