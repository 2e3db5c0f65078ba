"""The port's CUDA kernels against their plain versions, and the model on
the card against the model on the CPU. Every test here needs the card
(marker ``cuda``) and skips without one; the file imports neither jax nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: K1/K2 f32 2e-5, bf16 2e-2 and K3 1e-5, K4 5e-4 (those of
tests/test_kernels.py), both of its routes (the chunked prefill and the
recurrent decode step); K4 in bf16 2e-2; K3's gated route 1e-5 of the
largest |h| (its scan rounds a chunk's carry relative to the state);
fp32 model logits 1e-3; K6 (the int8 matmul, f32 scalar and bf16
tensor-core routes, split-K at decode) 10x those, as
tests/test_kernels.py:117. The backward kernels of K1, K3's gated
route and K4 within 1e-4 of each gradient's largest |reference| in f32
(K4's dlw 1e-3: its intra-chunk pairs cancel) and 2e-2 in bf16, and
bit-equal on a repeat. K5 (the
planner's masked argmax and its round kernel, with and without a latency
mask) and the torch planner backend, the sharded planner on it included,
are exact. The last tests run the live testbed's smoke spec on the card,
with monoliths and with tensor-parallel groups, whose gathered weights
are bit-equal to a monolith load's.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.device import generator_for  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_gated_scan_ref, rglru_scan_ref)
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref  # noqa: E402
from repro_torch.models import model as MDL  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SCAN_ATOL, WKV_ATOL, LOGIT_ATOL = 1e-5, 5e-4, 1e-3

FLASH_SWEEP = [                     # tests/test_kernels.py:18-23
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 100, 100, 4, 1, 64, True, 16),
    (2, 96, 96, 8, 8, 32, False, 0),
    (1, 33, 33, 2, 2, 128, True, 8),
    (1, 300, 300, 10, 1, 256, True, 256),   # recurrentgemma heads, window
    (2, 33, 33, 8, 2, 16, True, 0),         # the testbed's smoke rungs
    (1, 40, 40, 6, 2, 16, True, 0),
    (2, 17, 17, 1, 1, 16, True, 8),
    (2, 33, 33, 4, 4, 16, True, 0),         # qwen1.5-4b's (G = 1) and
    (2, 33, 33, 4, 2, 16, True, 8),         # gemma3-27b's local smoke
    (2, 77, 77, 16, 2, 128, True, 0),       # ragged Sq (not a multiple
    (1, 150, 150, 4, 1, 256, True, 0),      # of the 64-row query tile)
    (2, 1, 1500, 16, 16, 64, False, 0),     # Sq != Skv, non-causal:
    (1, 64, 1500, 16, 16, 64, False, 0),    # whisper's cross attention
    (2, 33, 77, 8, 2, 128, False, 0),       # and a ragged pair
]
DECODE_SWEEP = [                    # tests/test_kernels.py:42-46
    (3, 8, 2, 64, 200, 0),
    (2, 4, 1, 32, 64, 16),
    (1, 16, 16, 128, 300, 0),
    (4, 10, 1, 256, 512, 0),                # recurrentgemma heads
    (2, 8, 2, 16, 96, 0),                   # the testbed's smoke rungs
    (2, 2, 1, 16, 96, 8),
    (2, 4, 4, 16, 96, 0),                   # qwen1.5-4b's and
    (2, 4, 2, 16, 8, 8),                    # gemma3-27b's local smoke
    (2, 4, 4, 128, 300, 0),                 # G = 1
    (4, 5, 1, 256, 512, 100),               # G = 5, window inside chunks
    (4, 16, 2, 128, 512, 0),                # G = 8
    (2, 32, 1, 64, 700, 0),                 # G = 32
    (2, 56, 8, 128, 300, 0),                # G = 7, arctic-480b's
    (4, 28, 4, 128, 512, 0),                # G = 7 at its :w050
]
# K2 at the main path's decode shape: 4 slots x 512 positions; plus lens at
# the 32-key tile and chunk edges (1, 32, 33) and the whole cache
DECODE_LENS = ([97, 161, 288, 512], [1, 32, 33, 512])
SCAN_SWEEP = [(2, 100, 256), (1, 64, 128), (3, 17, 256),     # :64-68
              (1, 256, 2560), (4, 1, 2560),
              (2, 33, 100), (1, 300, 64), (3, 1, 100),       # ragged W,
              (1, 2100, 2560)]                               # long prompt
GATED_RTOL = 1e-5
WKV_SWEEP = [(2, 3, 70, 16), (1, 2, 64, 32), (2, 1, 33, 8),  # :82-86
             (1, 40, 256, 64), (4, 40, 1, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_cuda(cuda, dtype):
    """K1 and K2 against their plain versions on the card."""
    dt = TDT[dtype]
    g = torch.Generator(device=cuda).manual_seed(0)
    for B, Sq, Skv, H, KVH, hd, causal, window in FLASH_SWEEP:
        q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dt)
        k = torch.randn(B, Skv, KVH, hd, generator=g, device=cuda).to(dt)
        v = torch.randn(B, Skv, KVH, hd, generator=g, device=cuda).to(dt)
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window).transpose(1, 2)
        assert _max_err(out, ref) < ATOL[dtype]
    for B, H, KVH, hd, Smax, window in DECODE_SWEEP:
        q = torch.randn(B, 1, H, hd, generator=g, device=cuda).to(dt)
        kc = torch.randn(B, Smax, KVH, hd, generator=g, device=cuda).to(dt)
        vc = torch.randn(B, Smax, KVH, hd, generator=g, device=cuda).to(dt)
        lens = torch.randint(1, Smax + 1, (B,), generator=g, device=cuda,
                             dtype=torch.int32)
        out = dec_ops.decode_attention(q, kc, vc, lens, window=window)
        ref = decode_attention_ref(q[:, 0], kc.transpose(1, 2),
                                   vc.transpose(1, 2), lens, window=window)
        assert _max_err(out[:, 0], ref) < ATOL[dtype]
    torch.cuda.synchronize()


def _full_width_attention_shapes():
    """(H, KVH, hd, window) of every rung phases 4 and 6 serve at full
    width: the ladders of every attention arch but the MoE testbed arch
    (whose heads qwen3-32b's cover)."""
    from repro_torch.core.variants import build_ladder
    from repro_torch.models.model import ATTN_KINDS
    out = set()
    for arch in ("qwen2.5-3b", "recurrentgemma-2b", "qwen3-32b",
                 "qwen1.5-4b", "gemma3-27b", "llava-next-mistral-7b",
                 "arctic-480b", "whisper-medium"):
        for v in build_ladder(configs.get_config(arch)):
            c = v.config
            kinds = set(c.layer_kinds())
            if kinds & set(ATTN_KINDS):
                out.add((c.num_heads, c.num_kv_heads, c.head_dim,
                         c.window_size if "local" in kinds else 0))
    return sorted(out)


@pytest.mark.cuda
def test_attention_kernels_at_full_width_rungs(cuda):
    """K1 and K2 in bf16 at every full-width rung shape: K1 on a 256-token
    prompt (and 2100 where the window binds), K2 over 4 slots x 512
    positions, also held against the split-KV emulation of the plan the
    wrapper launches."""
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_split_ref
    dt = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(3)
    n_sm = dec_ops.sm_count(torch.cuda.current_device())
    for H, KVH, hd, window in _full_width_attention_shapes():
        for S in (256,) + ((2100,) if window else ()):
            q = torch.randn(1, S, H, hd, generator=g, device=cuda).to(dt)
            k = torch.randn(1, S, KVH, hd, generator=g, device=cuda).to(dt)
            v = torch.randn(1, S, KVH, hd, generator=g, device=cuda).to(dt)
            out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
            ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=True,
                                      window=window).transpose(1, 2)
            assert _max_err(out, ref) < ATOL["bfloat16"], (H, KVH, hd, S)
        q = torch.randn(4, 1, H, hd, generator=g, device=cuda).to(dt)
        kc = torch.randn(4, 512, KVH, hd, generator=g, device=cuda).to(dt)
        vc = torch.randn(4, 512, KVH, hd, generator=g, device=cuda).to(dt)
        _, chunk = dec_ops.plan_split(4, KVH, 512, n_sm)
        for lens in DECODE_LENS:
            lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
            out = dec_ops.decode_attention(q, kc, vc, lens, window=window)
            args = (q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), lens)
            ref = decode_attention_ref(*args, window=window)
            split, _ = decode_attention_split_ref(*args, window=window,
                                                  chunk=chunk)
            assert _max_err(out[:, 0], ref) < ATOL["bfloat16"], (H, KVH)
            assert _max_err(out[:, 0], split) < ATOL["bfloat16"], (H, KVH)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_deterministic(cuda, dtype):
    """Two calls of K1 and of K2 (split-KV, several chunks) on the same
    inputs are bit-equal."""
    dt = TDT[dtype]
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(1, 300, 16, 128, generator=g, device=cuda).to(dt)
    k = torch.randn(1, 300, 2, 128, generator=g, device=cuda).to(dt)
    v = torch.randn(1, 300, 2, 128, generator=g, device=cuda).to(dt)
    a = fa_ops.flash_attention(q, k, v, causal=True, window=0)
    b = fa_ops.flash_attention(q, k, v, causal=True, window=0)
    assert torch.equal(a, b)
    q = torch.randn(4, 1, 16, 128, generator=g, device=cuda).to(dt)
    kc = torch.randn(4, 512, 2, 128, generator=g, device=cuda).to(dt)
    vc = torch.randn(4, 512, 2, 128, generator=g, device=cuda).to(dt)
    lens = torch.tensor([97, 161, 288, 512], dtype=torch.int32, device=cuda)
    assert dec_ops.plan_split(4, 2, 512, dec_ops.sm_count(
        torch.cuda.current_device()))[0] > 1
    a = dec_ops.decode_attention(q, kc, vc, lens)
    b = dec_ops.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_rglru_kernel_matches_plain_on_cuda(cuda):
    """K3 against its plain version on the card, h_last aliasing h0."""
    r = np.random.default_rng(7)
    for B, S, W in SCAN_SWEEP:
        a = 1 / (1 + np.exp(-r.standard_normal((B, S, W)))) * 0.2 + 0.8
        b = r.standard_normal((B, S, W)) * 0.1
        h0 = r.standard_normal((B, W))
        a, b, h0 = (torch.from_numpy(x.astype(np.float32)).to(cuda)
                    for x in (a, b, h0))
        h_ref, hl_ref = rglru_scan_ref(a, b, h0)
        state = h0.clone()
        h, hl = rglru_ops.rglru_scan(a, b, state, h_last=state)
        torch.cuda.synchronize()
        assert hl is state
        assert _max_err(h, h_ref) < SCAN_ATOL
        assert _max_err(state, hl_ref) < SCAN_ATOL


def _gated_case(r, B, S, W, dt, dev):
    """ga, gx, xb (B,S,W) in ``dt``, log_lambda as the model draws it (a
    in [0.9, 0.999] at r = 1), h0 (B,W) fp32, from numpy."""
    ga, gx, xb = (torch.from_numpy(r.standard_normal((B, S, W)).astype(
        np.float32)).to(dev).to(dt) for _ in range(3))
    a_init = r.uniform(0.9, 0.999, W)
    lam = np.log(np.expm1(-np.log(a_init) / 8.0))
    h0 = r.standard_normal((B, W))
    return ga, gx, xb, *(torch.from_numpy(x.astype(np.float32)).to(dev)
                         for x in (lam, h0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_gated_kernel_matches_plain_on_cuda(cuda, dtype):
    """K3's gated route (the gates' tail fused into the scan) against its
    plain version, ``_gates``' arithmetic then the sequential scan, on the
    sweep, a ragged width, the smoke width 64, S = 1 and a 2100-token
    prompt; h_last aliasing h0; one launch a call, counted as gated."""
    r = np.random.default_rng(8)
    rglru_ops.LAUNCHES = rglru_ops.GATED_LAUNCHES = 0
    for B, S, W in SCAN_SWEEP + [(2, 8, 64), (2, 1, 64)]:
        ga, gx, xb, lam, h0 = _gated_case(r, B, S, W, TDT[dtype], cuda)
        h_ref, hl_ref = rglru_gated_scan_ref(ga, gx, xb, lam, h0)
        state = h0.clone()
        h, hl = rglru_ops.rglru_gated_scan(ga, gx, xb, lam, state,
                                           h_last=state)
        torch.cuda.synchronize()
        assert hl is state and h.dtype == torch.float32
        scale = max(1.0, float(h_ref.abs().max()))
        assert _max_err(h, h_ref) < GATED_RTOL * scale, (B, S, W)
        assert _max_err(state, hl_ref) < GATED_RTOL * scale, (B, S, W)
    n = len(SCAN_SWEEP) + 2
    assert rglru_ops.LAUNCHES == rglru_ops.GATED_LAUNCHES == n


@pytest.mark.cuda
def test_rglru_and_int8_kernels_deterministic(cuda):
    """Two launches of K3 (both routes, a chunked prefill and a decode
    step) and of K6's tensor-core routes (split K at decode and at a
    narrow prefill, one range at a wide one) on the same inputs give the
    same bits."""
    from repro_torch.kernels.int8_matmul import ops as k6
    r = np.random.default_rng(9)
    for B, S in ((1, 256), (4, 1), (1, 2100)):
        ga, gx, xb, lam, h0 = _gated_case(r, B, S, 2560, torch.bfloat16,
                                          cuda)
        runs = [rglru_ops.rglru_gated_scan(ga, gx, xb, lam, h0)
                for _ in range(2)]
        a = torch.rand(B, S, 2560, device=cuda)
        b = torch.randn(B, S, 2560, device=cuda)
        runs += [rglru_ops.rglru_scan(a, b, h0) for _ in range(2)]
        torch.cuda.synchronize()
        for x, y in (runs[:2], runs[2:]):
            assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
    g = torch.Generator(device=cuda).manual_seed(9)
    n_sm = k6.sm_count(torch.cuda.current_device())
    for M, K, N, split in ((4, 5120, 1024, True), (256, 1024, 2048, True),
                           (256, 512, 25600, False)):
        x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
        wq, sc = k6.quantize_int8(torch.randn(K, N, generator=g,
                                              device=cuda) * 0.05)
        assert (k6.plan_splitk(M, N, K, n_sm)[0] > 1) == split
        a, b = (k6.int8_matmul(x, wq, sc) for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_kernel_matches_plain_on_cuda(cuda, dtype):
    """K4 against its plain version on the card, from a nonzero state
    (s_out aliasing s0), lw down to -3."""
    dt = TDT[dtype]
    tol = WKV_ATOL if dtype == "float32" else ATOL[dtype]
    r = np.random.default_rng(4)
    for B, NH, S, hs in WKV_SWEEP:
        rkv = [torch.from_numpy(r.standard_normal((B, S, NH, hs))
                                .astype(np.float32)).to(cuda).to(dt)
               for _ in range(3)]
        lw = -np.exp(r.uniform(np.log(0.05), np.log(3.0), (B, S, NH, hs)))
        u = r.standard_normal((NH, hs)) * 0.3
        s0 = r.standard_normal((B, NH, hs, hs)) * 0.3
        lw, u, s0 = (torch.from_numpy(x.astype(np.float32)).to(cuda)
                     for x in (lw, u, s0))
        y_ref, s_ref = wkv6_ref(*rkv, lw, u, s0)
        state = s0.clone()
        y, s = wkv_ops.wkv6(*rkv, lw, u, state, s_out=state)
        torch.cuda.synchronize()
        assert s is state
        assert _max_err(y, y_ref) < tol
        assert _max_err(state, s_ref) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b",
                                  "rwkv6-3b"])
def test_model_on_card_matches_cpu(cuda, arch):
    """SMOKE widths (head_dim 32, which the attention kernels take), fp32:
    a 12-token prefill and 10 decode steps on the card (kernels; the
    recurrentgemma window of 8 binds and its ring wraps) against the CPU
    (plain path), and one kernel launch per layer of its kind."""
    cfg = configs.get_smoke(arch)
    if cfg.num_heads:
        cfg = cfg.replace(head_dim=32)
    cpu = torch.device("cpu")
    params = MDL.init_params(generator_for(cpu, 0), cfg, device=cpu)
    params_g = MDL._tree_map(lambda t: t.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 22)).astype(np.int32))
    cache_c = MDL.init_cache(cfg, 2, 32, device=cpu)
    cache_g = MDL.init_cache(cfg, 2, 32, device=cuda)
    kinds = cfg.layer_kinds()
    mods = {"attn": (fa_ops, dec_ops), "rglru": (rglru_ops, rglru_ops),
            "rwkv": (wkv_ops, wkv_ops)}
    for m in (fa_ops, dec_ops, rglru_ops, wkv_ops):
        m.LAUNCHES = 0
    rglru_ops.GATED_LAUNCHES = 0
    with torch.inference_mode():
        lc, _ = MDL.prefill(params, cfg, toks[:, :12], cache_c)
        lg, _ = MDL.prefill(params_g, cfg, toks[:, :12].to(cuda), cache_g)
        for t in range(12, 22):
            assert _max_err(lg.cpu(), lc) < LOGIT_ATOL
            assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1))
            lc, _ = MDL.decode_step(params, cfg, toks[:, t], cache_c)
            lg, _ = MDL.decode_step(params_g, cfg, toks[:, t].to(cuda),
                                    cache_g)
        assert _max_err(lg.cpu(), lc) < LOGIT_ATOL
    torch.cuda.synchronize()
    want = {m: 0 for m in (fa_ops, dec_ops, rglru_ops, wkv_ops)}
    for kind in kinds:
        pre, dec = mods["attn" if kind in ("global", "local") else kind]
        want[pre] += 1
        want[dec] += 10
    assert {m: m.LAUNCHES for m in want} == want
    # the model's RG-LRU layers take K3's gated route only
    assert rglru_ops.GATED_LAUNCHES == rglru_ops.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [None, 32])
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma3-27b",
                                  "llava-next-mistral-7b", "arctic-480b",
                                  "whisper-medium"])
def test_other_archs_on_card_match_cpu(cuda, arch, head_dim):
    """SMOKE widths (the smoke head_dim 16 the testbed serves, and 32),
    fp32, the model's entry points with llava's patch embeddings and
    whisper's frames from a numpy seed: a 12-token prefill and 6 decode
    steps on the card (kernels; gemma3's window of 8 binds and its ring
    wraps) against the CPU (plain path), and K1/K2 launched once per
    attention a call."""
    cfg = configs.get_smoke(arch)
    if head_dim is not None:
        cfg = cfg.replace(head_dim=head_dim)
    cpu = torch.device("cpu")
    params = MDL.init_params(generator_for(cpu, 0), cfg, device=cpu)
    params_g = MDL._tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 18)).astype(np.int32))
    n = (cfg.encoder_seq_len if cfg.is_encoder_decoder
         else cfg.num_patch_tokens)
    extra = torch.from_numpy(rng.standard_normal(
        (2, n, cfg.d_model)).astype(np.float32)) if n else None
    P = 0 if cfg.is_encoder_decoder else cfg.num_patch_tokens
    cache_c = MDL.init_cache(cfg, 2, P + 24, device=cpu)
    cache_g = MDL.init_cache(cfg, 2, P + 24, device=cuda)
    fa_ops.LAUNCHES = dec_ops.LAUNCHES = 0
    with torch.inference_mode():
        lc, _ = MDL.prefill(params, cfg, toks[:, :12], cache_c, extra)
        lg, _ = MDL.prefill(params_g, cfg, toks[:, :12].to(cuda), cache_g,
                            None if extra is None else extra.to(cuda))
        for t in range(12, 18):
            assert _max_err(lg.cpu(), lc) < LOGIT_ATOL
            assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1))
            lc, _ = MDL.decode_step(params, cfg, toks[:, t], cache_c)
            lg, _ = MDL.decode_step(params_g, cfg, toks[:, t].to(cuda),
                                    cache_g)
        assert _max_err(lg.cpu(), lc) < LOGIT_ATOL
    torch.cuda.synchronize()
    if cfg.is_encoder_decoder:
        n_enc, n_dec = cfg.num_encoder_layers, cfg.num_decoder_layers
        want = (n_enc + 2 * n_dec + 6 * n_dec, 6 * n_dec)
    else:
        want = (cfg.num_layers, 6 * cfg.num_layers)
    assert (fa_ops.LAUNCHES, dec_ops.LAUNCHES) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_planner_argmax_matches_plain_on_cuda(cuda, dtype):
    """K5 equals its plain version exactly (index and value): random,
    tied and all-equal values under sparse, dense, empty and full masks,
    one row and (V, S) rows sharing one column."""
    from repro_torch.kernels.planner_argmax import ops as k5
    dt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    g = torch.Generator(device=cuda).manual_seed(0)
    k5.LAUNCHES = 0
    n_calls = 0
    for S in (1, 6, 513, 1000, 10000):
        x = torch.randn(S, generator=g, device=cuda).to(dt)
        for v in (x, x.round(), torch.full_like(x, 0.5)):
            for mask in (torch.rand(S, generator=g, device=cuda) < 0.1,
                         torch.rand(S, generator=g, device=cuda) < 0.7,
                         torch.zeros(S, dtype=torch.bool, device=cuda),
                         torch.ones(S, dtype=torch.bool, device=cuda)):
                i, val = k5.masked_argmax(v, mask)
                pi, pv = k5.masked_argmax_torch(v, mask)
                assert torch.equal(i, pi) and torch.equal(val, pv)
                rows = torch.rand((8, S), generator=g, device=cuda) < 0.5
                rows[2] = False
                i, val = k5.masked_argmax(v.expand(8, S), rows)
                pi, pv = k5.masked_argmax_torch(v.expand(8, S), rows)
                assert torch.equal(i, pi) and torch.equal(val, pv)
                n_calls += 2
    torch.cuda.synchronize()
    assert k5.LAUNCHES == n_calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_torch_planner_on_card_matches_numpy(cuda, dtype):
    """plan_greedy_torch on the card equals the port's numpy planner:
    assignments, their order and the Eq. 1 objective bits."""
    import random

    from repro_torch.core.cluster import make_cluster
    from repro_torch.core.planner import PlannerState, plan_greedy
    from repro_torch.core.planner.torch_backend import (TorchPlanContext,
                                                        plan_greedy_torch)
    from repro_torch.core.variants import Application, synthetic_family
    from repro_torch.kernels.planner_argmax import ops as k5

    ctx = TorchPlanContext(cuda)
    for seed in range(6):
        rng = random.Random(seed)
        cluster = make_cluster(4, 25, mem=24e9)
        apps = [Application(
            id=f"a{i}", family=f"f{i}",
            variants=synthetic_family(f"f{i}", rng.uniform(0.3e9, 6e9),
                                      n_variants=rng.randint(2, 6),
                                      spread=rng.uniform(1.5, 12.0)),
            request_rate=rng.uniform(0.2, 3.0), critical=rng.random() < 0.5)
            for i in range(rng.randint(50, 400))]
        sids = list(cluster.servers)
        exclude = {a.id: {rng.choice(sids)} for a in apps}
        for sid in rng.sample(sids, 10):
            cluster.fail_server(sid)
        kw = dict(exclude=exclude, alpha=rng.choice([0.0, 0.1]))
        r_np = plan_greedy(apps, cluster, state=PlannerState(
            cluster, subscribe=False, dtype=dtype), **kw)
        k5.LAUNCHES = k5.ROUND_LAUNCHES = 0
        r_t = plan_greedy_torch(apps, cluster, state=PlannerState(
            cluster, subscribe=False, dtype=dtype), ctx=ctx, **kw)
        assert k5.ROUND_LAUNCHES == k5.LAUNCHES == 1     # one per round
        assert {k: (v.name, s) for k, (v, s) in r_np.assignment.items()} \
            == {k: (v.name, s) for k, (v, s) in r_t.assignment.items()}
        assert list(r_np.assignment) == list(r_t.assignment)
        assert r_np.unplaced == r_t.unplaced
        assert r_np.objective == r_t.objective


# K4's chunked route: prompts no multiple of the 32-step chunk and shorter
# than it, and rwkv6-3b's full width
WKV_CHUNKED = [(2, 3, 70, 16), (1, 2, 64, 32), (2, 1, 33, 8), (1, 2, 2, 32),
               (1, 2, 31, 64), (2, 3, 95, 16), (1, 40, 256, 64),
               (1, 40, 250, 64)]


def _wkv_case(r, B, NH, S, hs, lw_min, dt, dev):
    """chip_smoke.py's K4 inputs: r, k, v standard normal, lw over
    [lw_min, -0.05], u and s0 at 0.3 x standard normal."""
    rkv = [torch.from_numpy(r.standard_normal((B, S, NH, hs))
                            .astype(np.float32)).to(dev).to(dt)
           for _ in range(3)]
    lw = -np.exp(r.uniform(np.log(0.05), np.log(-lw_min), (B, S, NH, hs)))
    u = r.standard_normal((NH, hs)) * 0.3
    s0 = r.standard_normal((B, NH, hs, hs)) * 0.3
    return rkv + [torch.from_numpy(x.astype(np.float32)).to(dev)
                  for x in (lw, u, s0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_chunked_kernel_matches_plain_on_cuda(cuda, dtype):
    """K4's chunked route (every S > 1) against the recurrence's plain
    version, from a nonzero state written over s0 itself, lw spread to -3
    and down to -20 (below the TPU kernel's clamp)."""
    dt = TDT[dtype]
    tol = WKV_ATOL if dtype == "float32" else ATOL[dtype]
    r = np.random.default_rng(6)
    for (B, NH, S, hs), lw_min in [(c, m) for c in WKV_CHUNKED
                                   for m in (-3.0, -20.0)]:
        *rkv, lw, u, s0 = _wkv_case(r, B, NH, S, hs, lw_min, dt, cuda)
        y_ref, s_ref = wkv6_ref(*rkv, lw, u, s0)
        state = s0.clone()
        wkv_ops.LAUNCHES = wkv_ops.CHUNKED_LAUNCHES = 0
        y, s = wkv_ops.wkv6(*rkv, lw, u, state, s_out=state)
        torch.cuda.synchronize()
        assert wkv_ops.LAUNCHES == wkv_ops.CHUNKED_LAUNCHES == 1
        assert s is state
        assert torch.isfinite(y).all()
        assert _max_err(y, y_ref) < tol, (B, NH, S, hs, lw_min)
        assert _max_err(state, s_ref) < tol, (B, NH, S, hs, lw_min)


def _round_cases(dtype, cuda):
    """Planning rounds as ``prepare_round`` builds them (random clusters
    with dead servers, server and site exclusions, up to six variants),
    and, for an f32 state, rounds built on rounding edges."""
    import random

    from repro_torch.core.cluster import make_cluster
    from repro_torch.core.planner import PlannerState
    from repro_torch.core.planner.torch_backend import (TorchPlanContext,
                                                        _cmp_thresholds,
                                                        prepare_round)
    from repro_torch.core.variants import Application, synthetic_family

    ctx = TorchPlanContext(cuda)
    for seed in range(5):
        rng = random.Random(seed)
        cluster = make_cluster(4, 25, mem=rng.uniform(4e9, 24e9))
        apps = [Application(
            id=f"a{i}", family=f"f{i}",
            variants=synthetic_family(f"f{i}", rng.uniform(0.3e9, 6e9),
                                      n_variants=rng.randint(2, 6),
                                      spread=rng.uniform(1.5, 12.0)),
            request_rate=rng.uniform(0.2, 3.0), critical=rng.random() < 0.5)
            for i in range(rng.randint(50, 400))]
        sids = list(cluster.servers)
        for sid in rng.sample(sids, 10):
            cluster.fail_server(sid)
        exclude = {a.id: {rng.choice(sids)} for a in apps
                   if rng.random() < 0.7}
        site_exclude = {a.id: {f"site{rng.randrange(4)}"} for a in apps
                        if rng.random() < 0.3}
        st = PlannerState(cluster, subscribe=False, dtype=dtype)
        st.sync()
        yield prepare_round(apps, cluster, st, exclude, site_exclude,
                            rng.choice([0.0, 0.1]), ctx)[3].args()
    if dtype != "float32":
        return
    g = np.random.default_rng(21)
    for _ in range(10):               # tests/test_torch_planner.py's edges
        S, A, V = 8, 24, 4
        cap = np.stack([g.uniform(8e9, 24e9, S), g.uniform(0.5, 2.0, S)],
                       axis=1).astype(np.float32)
        free = (cap * g.uniform(0.1, 0.6, (S, 2))).astype(np.float32)
        dm = np.empty((A, V, 2))
        for i in range(A):
            mem = g.uniform(0.3e9, 4e9) * (
                g.uniform(1.5, 12.0) ** (-np.arange(V) / (V - 1)))
            dm[i] = np.stack([mem, mem / 32e9], axis=1)
            if g.random() < 0.5:
                s, j = g.integers(S), g.integers(V)
                f = np.float64(free[s, 0])
                dm[i, j, 0] = f + g.integers(-2, 3) * np.spacing(f)
                dm[i, j, 1] = 0.0
        budget = free.astype(np.float64).sum(axis=0) * g.uniform(0.6, 1.0)
        allowed = g.random((A, S)) < 0.85
        rows = [np.flatnonzero(~allowed[i]) for i in range(A)]
        off = np.concatenate([[0], np.cumsum([r.size for r in rows])])
        yield tuple(torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
                    for x in (free, (free / cap).min(axis=1), budget, cap,
                              np.ones(S, bool), off.astype(np.int32),
                              np.concatenate(rows).astype(np.int32), dm,
                              _cmp_thresholds(dm, np.float32),
                              g.integers(0, V, A).astype(np.int32),
                              np.full(A, V, np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_planner_round_kernel_matches_plain_on_cuda(cuda, dtype):
    """K5's round kernel, one launch per round, bit-equal to its plain
    version (``place_chunk`` + ``upgrade_chunk``, on the CPU): placements,
    upgrades and the free/head/budget tensors after the round."""
    from repro_torch.core.planner.kernels import plan_round_plain
    from repro_torch.kernels.planner_argmax import ops as k5

    n = 0
    for args in _round_cases(dtype, cuda):
        card = [t.clone() for t in args]
        cpu = [t.to("cpu", copy=True) for t in args]
        k5.ROUND_LAUNCHES = 0
        out = k5.plan_round(*card)
        torch.cuda.synchronize()
        assert k5.ROUND_LAUNCHES == 1
        want = plan_round_plain(*cpu)
        assert torch.equal(out.cpu(), want)
        for a, b in zip(card[:3], cpu[:3]):
            assert torch.equal(a.cpu(), b)
        n += 1
    assert n == (15 if dtype == "float32" else 5)


@pytest.mark.cuda
def test_chunked_and_round_kernels_deterministic(cuda):
    """Two launches of K4's chunked route (bf16, rwkv6-3b's prefill) and
    of K5's round kernel on the same inputs give the same bits: fixed
    reduction orders, no atomics."""
    from repro_torch.kernels.planner_argmax import ops as k5

    r = np.random.default_rng(7)
    *rkv, lw, u, s0 = _wkv_case(r, 1, 40, 256, 64, -3.0, torch.bfloat16,
                                cuda)
    (y1, s1), (y2, s2) = (wkv_ops.wkv6(*rkv, lw, u, s0) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    for dtype in ("float32", "float64"):
        args = next(iter(_round_cases(dtype, cuda)))
        runs = []
        for _ in range(2):
            work = [t.clone() for t in args]
            runs.append([k5.plan_round(*work)] + work[:3])
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs))


def _slo_lat(app, v, srv):
    """A latency over the apps' SLO of 0.02 on about half the (variant,
    server) pairs, NaN (allowed, as in numpy) on one pair in seven."""
    import zlib
    h = zlib.crc32(f"{v.name}|{srv.id}".encode()) % 97
    return float("nan") if h % 7 == 3 else 0.04 * h / 97.0


def _latency_instances(dtype):
    """Random planning rounds with a latency SLO on every app, dead
    servers and server and site exclusions: (apps, cluster, keywords)."""
    import random

    from repro_torch.core.cluster import make_cluster
    from repro_torch.core.variants import Application, synthetic_family

    for seed in range(6):
        rng = random.Random(100 + seed)
        cluster = make_cluster(4, 25, mem=rng.uniform(4e9, 24e9))
        apps = [Application(
            id=f"a{i}", family=f"f{i}",
            variants=synthetic_family(f"f{i}", rng.uniform(0.3e9, 6e9),
                                      n_variants=rng.randint(2, 6),
                                      spread=rng.uniform(1.5, 12.0)),
            request_rate=rng.uniform(0.2, 3.0), critical=rng.random() < 0.5,
            latency_slo=0.02) for i in range(rng.randint(30, 200))]
        sids = list(cluster.servers)
        for sid in rng.sample(sids, 10):
            cluster.fail_server(sid)
        kw = dict(exclude={a.id: {rng.choice(sids)} for a in apps
                           if rng.random() < 0.7},
                  site_exclude={a.id: {f"site{rng.randrange(4)}"}
                                for a in apps if rng.random() < 0.3},
                  alpha=rng.choice([0.0, 0.1]))
        yield apps, cluster, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_planner_masked_round_matches_plain_on_cuda(cuda, dtype):
    """K5's round kernel with a latency mask bit-equal to its plain
    version on the CPU (placements, upgrades, free/head/budget), an
    all-true mask equal to no mask, and plan_greedy_torch with a
    latency_fn on the card equal to numpy's plan_greedy(latency_fn=...)."""
    from repro_torch.core.planner import PlannerState, plan_greedy
    from repro_torch.core.planner.kernels import plan_round_plain
    from repro_torch.core.planner.torch_backend import (TorchPlanContext,
                                                        plan_greedy_torch,
                                                        prepare_round)
    from repro_torch.kernels.planner_argmax import ops as k5

    ctx = TorchPlanContext(cuda)
    n_masked = 0
    for apps, cluster, kw in _latency_instances(dtype):
        st = PlannerState(cluster, subscribe=False, dtype=dtype)
        st.sync()
        inp = prepare_round(apps, cluster, st, kw["exclude"],
                            kw["site_exclude"], kw["alpha"], ctx,
                            _slo_lat)[3]
        lat = inp.lat
        assert lat.dtype == torch.uint8 and 0 < int(lat.sum()) < lat.numel()
        card = [t.clone() for t in inp.args()]
        cpu = [t.to("cpu", copy=True) for t in inp.args()]
        k5.ROUND_LAUNCHES = k5.MASKED_LAUNCHES = 0
        out = k5.plan_round(*card, lat=lat)
        torch.cuda.synchronize()
        assert k5.ROUND_LAUNCHES == k5.MASKED_LAUNCHES == 1
        assert torch.equal(out.cpu(), plan_round_plain(*cpu, lat=lat.cpu()))
        for a, b in zip(card[:3], cpu[:3]):
            assert torch.equal(a.cpu(), b)
        ones = [t.clone() for t in inp.args()]
        bare = [t.clone() for t in inp.args()]
        o1 = k5.plan_round(*ones, lat=torch.ones_like(lat, dtype=torch.bool))
        o0 = k5.plan_round(*bare)
        assert torch.equal(o1, o0) and all(
            torch.equal(a, b) for a, b in zip(ones[:3], bare[:3]))
        r_t = plan_greedy_torch(apps, cluster, state=PlannerState(
            cluster, subscribe=False, dtype=dtype), ctx=ctx,
            latency_fn=_slo_lat, **kw)
        r_np = plan_greedy(apps, cluster, state=PlannerState(
            cluster, subscribe=False, dtype=dtype), latency_fn=_slo_lat,
            **kw)
        assert [(k, v.name, s) for k, (v, s) in r_t.assignment.items()] \
            == [(k, v.name, s) for k, (v, s) in r_np.assignment.items()]
        assert r_t.unplaced == r_np.unplaced
        assert r_t.objective == r_np.objective
        n_masked += 1
    assert n_masked == 6
    with pytest.raises(ValueError, match="lat"):
        k5.plan_round(*[t.clone() for t in inp.args()],
                      lat=lat[:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="uint8 or bool"):
        k5.plan_round(*[t.clone() for t in inp.args()], lat=lat.float())


@pytest.mark.cuda
def test_sharded_planner_on_card_matches_greedy(cuda):
    """The sharded planner on the torch backend (one round-kernel launch a
    round) against the greedy planner on the card and the numpy sharded
    planner with coordinators: equal assignments, order, unplaced list
    and objective bits (tests/test_scale.py's instances)."""
    import random

    from repro_torch.core.cluster import Cluster, Server
    from repro_torch.core.planner import PlanRequest, get_planner
    from repro_torch.core.variants import Application, synthetic_family
    from repro_torch.kernels.planner_argmax import ops as k5

    for seed in range(3):
        g = np.random.default_rng(seed)
        cluster = Cluster([Server(
            id=f"s{si}-{sj}", site=f"site{si}",
            capacity={"mem": float(g.uniform(8e9, 32e9)),
                      "compute": float(g.uniform(0.5, 2.0))})
            for si in range(6) for sj in range(8)])
        rng = random.Random(seed)
        apps = [Application(
            id=f"a{i}", family=f"f{i}",
            variants=synthetic_family(f"f{i}", rng.uniform(0.5e9, 4e9),
                                      n_variants=4),
            request_rate=rng.uniform(0.5, 2.0), critical=rng.random() < 0.5)
            for i in range(120)]
        req = PlanRequest(apps=apps, cluster=cluster, alpha=0.1)
        plans = {}
        for name, kw in (("sharded", {"device": cuda}),
                         ("greedy", {"device": cuda}),
                         ("sharded", {"backend": "numpy",
                                      "coordinators": 4})):
            k5.ROUND_LAUNCHES = 0
            p = get_planner(name, **kw)
            res = p.plan(req)
            torch.cuda.synchronize()
            assert k5.ROUND_LAUNCHES == (0 if "backend" in kw else 1)
            plans[(name, kw.get("backend", "torch"))] = (
                [(k, v.name, s) for k, (v, s) in res.assignment.items()],
                res.unplaced, res.objective)
        assert len(set(map(repr, plans.values()))) == 1, plans.keys()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_plain_on_cuda(cuda, dtype):
    """K6 against its plain version: the sweep of tests/test_kernels.py
    (ragged M, N, K; an int8 row of 130 bytes), x contiguous and as a view
    with an unaligned row, a w_q whose N is not a multiple of 4, and the
    decode (split-K in bf16) and prefill M at reduced widths."""
    from repro_torch.kernels.int8_matmul import ops as k6
    dt = TDT[dtype]
    g = torch.Generator(device=cuda).manual_seed(4)
    k6.LAUNCHES = 0
    n = 0
    for M, K, N in ((100, 300, 200), (64, 128, 64), (33, 65, 130),
                    (4, 5120, 1030), (256, 512, 2048), (4, 2048, 130),
                    (16, 4096, 640), (1, 1000, 256)):
        w = torch.randn(K, N, generator=g, device=cuda) * 0.05
        wq, sc = k6.quantize_int8(w)
        for off, out_dtype in itertools.product((3, 0), (None,
                                                         torch.float32)):
            x = torch.randn(M, K + off, generator=g, device=cuda).to(dt)[
                :, off:]
            out = k6.int8_matmul(x, wq, sc, out_dtype=out_dtype)
            ref = k6.int8_matmul_torch(x, wq, sc, out_dtype=out_dtype)
            assert out.dtype == ref.dtype
            assert _max_err(out, ref) < 10 * ATOL[dtype], (M, K, N)
            n += 1
    torch.cuda.synchronize()
    assert k6.LAUNCHES == n


@pytest.mark.cuda
def test_testbed_smoke_spec_on_the_card(cuda):
    """The live testbed's smoke spec on the card, through the experiment
    entry point: every engine and the planner on the card, the failover
    recovered, no error other than a dead server, and the attention
    kernels launched by the workers."""
    from repro_torch.experiment import ExperimentSpec, run_experiment
    from repro_torch.kernels.planner_argmax import ops as k5
    for m in (fa_ops, dec_ops, wkv_ops, k5):
        m.LAUNCHES = 0
    res = run_experiment(ExperimentSpec.smoke("testbed"))
    assert res.overall["recovery_rate"] == 1.0
    assert res.extras["load_errors"] == []
    assert 0.0 < res.detect_latency_s < 1.0
    assert res.traffic.n_offered > 0
    assert fa_ops.LAUNCHES and dec_ops.LAUNCHES and wkv_ops.LAUNCHES
    assert k5.LAUNCHES


@pytest.mark.cuda
def test_tp_gathered_tree_is_a_monolith_load_on_the_card(cuda):
    """The shard plane's slices, drawn and gathered on the card, are
    bit-equal to the tree `WorkerServer.load` draws there, and an engine
    on them gives the monolith engine's greedy tokens."""
    from repro_torch.core.heartbeat import FailureDetector, WallClock
    from repro_torch.experiment.workload import testbed_ladder
    from repro_torch.serving import shard as S
    from repro_torch.serving.engine import InferenceEngine, Request
    from repro_torch.serving.server import WorkerServer

    def tokens(eng, prompt):
        r = Request(id="t", prompt=prompt, max_new_tokens=8)
        assert eng.try_admit(r)
        while eng.active_count():
            eng.step()
        return r.tokens

    for arch in ("qwen2.5-3b", "rwkv6-3b"):
        full = testbed_ladder(arch)[0]
        w = WorkerServer("w", FailureDetector(WallClock()), device=cuda)
        w.load(None, full)
        mono = w.engines[full.name]
        ckpt = S.checkpoint_params(full, cuda)
        for k in (2, 3):
            axes = S.split_axes(ckpt, k)
            parts = [S.rank_slice(ckpt, axes, k, r) for r in range(k)]
            got = S.gather(parts, axes)
            pairs = zip(_leaves(got), _leaves(mono.params),
                        strict=True)
            assert all(a.device == b.device and torch.equal(a, b)
                       for a, b in pairs)
            eng = InferenceEngine(full.config, got, batch_slots=2,
                                  max_len=96, device=cuda)
            prompt = np.arange(3, 15, dtype=np.int32)
            assert tokens(eng, prompt) == tokens(mono, prompt)


def _leaves(tree):
    from repro_torch.parallel.sharding import _tree_paths
    return [leaf for _p, leaf in _tree_paths(tree)]


@pytest.mark.cuda
def test_tp_testbed_smoke_spec_on_the_card(cuda):
    """The smoke testbed spec with tensor-parallel groups on the card:
    recovered, no error other than a dead server, the shard summary
    reported, and the attention kernels launched by the gathered
    engines."""
    from repro_torch.experiment import ExperimentSpec, run_experiment
    for m in (fa_ops, dec_ops, wkv_ops):
        m.LAUNCHES = 0
    res = run_experiment(ExperimentSpec.smoke("testbed").with_(
        n_sites=3, tp_degree=2, shard_policy="reshard"))
    assert res.overall["recovery_rate"] == 1.0
    assert res.extras["load_errors"] == []
    assert res.extras["shard"]["measured"]["deploy_build_s"]["n"] == 2
    assert fa_ops.LAUNCHES and dec_ops.LAUNCHES and wkv_ops.LAUNCHES


# K1's backward: the shapes of a smoke train step (phase 8 (b)) and a few
# at the main path's widths, (B, Sq, Skv, H, KVH, hd, causal, window)
BWD_SWEEP = [
    (2, 24, 24, 4, 2, 16, True, 0),          # smoke, G = 2
    (2, 24, 24, 4, 4, 16, True, 0),          # qwen1.5-4b / whisper, G = 1
    (2, 24, 24, 8, 2, 16, True, 0),          # qwen3-32b smoke, G = 4
    (2, 24, 24, 4, 2, 16, True, 8),          # gemma3 local smoke
    (2, 24, 24, 4, 4, 16, False, 0),         # whisper smoke encoder/cross
    (2, 32, 32, 4, 2, 16, True, 0),          # llava smoke, 8 patches
    (2, 100, 100, 16, 2, 128, True, 0),      # qwen2.5-3b heads, ragged
    (1, 77, 77, 14, 2, 64, True, 0),         # G = 7
    (1, 130, 130, 10, 1, 256, True, 64),     # hd 256, window binds
    (1, 33, 150, 4, 4, 32, False, 0),        # non-causal, Sq != Skv
    # both sides of plan_bwd's split of the GQA group on a 132-SM card
    (2, 256, 256, 16, 2, 128, True, 0),      # qwen2.5-3b B=2 S=256: split
    (5, 1024, 1024, 16, 2, 128, True, 0),    # 160 dK/dV blocks: split
    (1, 256, 256, 14, 2, 256, True, 0),      # G = 7, hd 256: split
    (8, 1024, 1024, 16, 2, 128, True, 0),    # 256 dK/dV blocks: no split
]
BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the four rows above and whether plan_bwd splits them: 16, 160, 16 and
# 256 unsplit dK/dV blocks, so on any card of 107 to 170 SMs
BWD_SPLIT_SIDES = {BWD_SWEEP[-4]: True, BWD_SWEEP[-3]: True,
                   BWD_SWEEP[-2]: True, BWD_SWEEP[-1]: False}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_matches_plain_on_cuda(cuda, dtype):
    """K1's backward kernel against ``flash_attention_bwd_ref`` on the
    same (q, k, v, o, lse, dO), K1's lse against the plain forward's,
    and two runs bit-equal (no atomics). Tolerance relative to the
    largest |gradient|: f32 1e-4, bf16 2e-2."""
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    dt = TDT[dtype]
    g = torch.Generator(device=cuda).manual_seed(8)
    for B, Sq, Skv, H, KVH, hd, causal, window in BWD_SWEEP:
        q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dt)
        k = torch.randn(B, Skv, KVH, hd, generator=g, device=cuda).to(dt)
        v = torch.randn(B, Skv, KVH, hd, generator=g, device=cuda).to(dt)
        do = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dt)
        kw = dict(causal=causal, window=window)
        o, lse = fa_ops._forward(q, k, v, causal, window, True)
        t = [x.transpose(1, 2) for x in (q, k, v, o, do)]
        _, lse_ref = flash_attention_ref(*t[:3], return_lse=True, **kw)
        assert _max_err(lse, lse_ref) < 1e-4 * float(lse_ref.abs().max())
        got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        ref = flash_attention_bwd_ref(*t[:4], lse, t[4], **kw)
        for a, b in zip(got, ref):
            assert _max_err(a, b.transpose(1, 2)) < \
                BWD_RTOL[dtype] * float(b.abs().max().float()), \
                (B, Sq, Skv, H, KVH, hd, causal, window)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_flash_attention_bwd_sweep_covers_both_sides_of_the_split(cuda):
    """BWD_SWEEP's last four rows fall where they are meant to on this
    card: plan_bwd splits the GQA group at qwen2.5-3b's S=256, at 160
    unsplit dK/dV blocks and at G = 7 hd 256, and not at 256 unsplit
    blocks."""
    from repro_torch.kernels._build import sm_count
    n_sm = sm_count(cuda.index or 0)
    assert 107 <= n_sm <= 170
    for (B, Sq, Skv, H, KVH, hd, _, _), split in BWD_SPLIT_SIDES.items():
        plan = fa_ops.plan_bwd(B, H, KVH, Sq, Skv, hd, n_sm)
        assert plan.split == split, (B, Sq, H, KVH, hd, plan)


# the archs whose SMOKE train step test_model_backward_on_card_reaches_
# every_leaf drives: attention only (K1), RG-LRU + local attention (K1,
# K3's gated route), RWKV-6 (K4)
BACKWARD_ARCHS = ("qwen2.5-3b", "recurrentgemma-2b", "rwkv6-3b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", BACKWARD_ARCHS)
def test_model_backward_on_card_reaches_every_leaf(cuda, arch):
    """The fault this guards: on the card the kernels were ctypes launches
    autograd never saw, so ``loss.backward()`` left wq/wk/wv/bq/bk/bv and
    every leaf before the first attention without a gradient (and
    recurrentgemma-2b's and rwkv6-3b's train steps raised). Through
    ``FlashAttentionFn``, ``RGLRUGatedScanFn`` and ``WKV6Fn`` every leaf
    of the SMOKE tree gets one, within 1e-4 x max(1, max|g|) of the
    CPU's, and each layer's kernel launches its forward and its backward
    once."""
    from repro_torch.launch.steps import batch_to
    from repro_torch.models.lm import lm_loss
    from repro_torch.training.tree import tree_leaves
    cfg = configs.get_smoke(arch)
    kinds = cfg.layer_kinds()
    cpu = torch.device("cpu")
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 24))
             .astype(np.int32)}
    grads = {}
    for m in (fa_ops, rglru_ops, wkv_ops):
        m.LAUNCHES = m.BWD_LAUNCHES = 0
    for dev in (cuda, cpu):
        params = MDL.init_params(generator_for(cpu, 0), cfg, device=cpu)
        params = MDL._tree_map(lambda t: t.to(dev).requires_grad_(), params)
        loss, _ = lm_loss(params, cfg, batch_to(batch, dev))
        loss.backward()
        grads[dev.type] = [p.grad for p in tree_leaves(params)]
    n_attn = sum(kind in MDL.ATTN_KINDS for kind in kinds)
    assert fa_ops.LAUNCHES == fa_ops.BWD_LAUNCHES == n_attn
    assert rglru_ops.LAUNCHES == rglru_ops.BWD_LAUNCHES == kinds.count("rglru")
    assert wkv_ops.LAUNCHES == wkv_ops.BWD_LAUNCHES == kinds.count("rwkv")
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert a is not None and bool(torch.any(a != 0))
        assert _max_err(a.cpu(), b) < 1e-4 * max(1.0, float(b.abs().max()))


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_grad_on_cuda(cuda):
    """K2, K3's (a, b) route, K5 and K6 raise a RuntimeError naming the
    missing backward kernel when autograd would record a launch, instead
    of dropping the gradient. (K3's gated route and K4 have backward
    kernels: test_recurrent_backward_kernels_differentiate_on_cuda.)"""
    from repro_torch.kernels.int8_matmul import ops as k6
    from repro_torch.kernels.planner_argmax import ops as k5
    f = torch.float32

    def rnd(*shape):
        return torch.randn(*shape, device=cuda, dtype=f).requires_grad_()

    lens = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    calls = {
        "K2": lambda: dec_ops.decode_attention(rnd(2, 1, 4, 16),
                                               rnd(2, 8, 2, 16),
                                               rnd(2, 8, 2, 16), lens),
        "K3": lambda: rglru_ops.rglru_scan(rnd(1, 4, 8), rnd(1, 4, 8),
                                           torch.zeros(1, 8, device=cuda)),
        "K5 (masked argmax)": lambda: k5.masked_argmax(
            rnd(6), torch.ones(6, dtype=torch.bool, device=cuda)),
        "K6": lambda: k6.int8_matmul(
            rnd(2, 16), torch.ones(16, 8, dtype=torch.int8, device=cuda),
            torch.ones(8, device=cuda)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=r"no backward kernel") as e:
            call()
        assert name in str(e.value) and "ROADMAP Queue 2" in str(e.value)
        with torch.no_grad():
            call()                       # no grad recorded: it launches
    torch.cuda.synchronize()


# K3's gated backward: (B, S, W, extreme gates) at the smoke width, a
# ragged width (odd: one bf16 channel a thread), S = 1 and 7, S no
# multiple of the chunks and past the steps kept in registers (a chunk in
# segments, ga and dh read twice), recurrentgemma-2b's width at S = 256
# and 2100, grids under one wave of the card (B = 1 at W = 64); ``extreme``
# pushes some gates to a -> 1, where mult reaches the clamp
RGLRU_BWD_SWEEP = [(2, 24, 64, False), (3, 17, 100, False),
                   (2, 1, 64, False), (1, 33, 2560, False),
                   (2, 300, 256, False), (1, 2100, 512, False),
                   (2, 64, 256, True), (1, 7, 64, False), (1, 7, 63, True),
                   (1, 256, 2560, False), (2, 256, 2560, True),
                   (1, 2100, 2560, False), (1, 256, 64, False)]
# K4's backward: (B, NH, S, hs): every head size at S = 1, 16, 33 and 256,
# a partial chunk, rwkv6-3b's heads
WKV_BWD_SWEEP = [(2, 3, 70, 16), (1, 2, 64, 32), (2, 1, 33, 8),
                 (1, 2, 1, 64), (1, 40, 100, 64)] + [
                     (2, 3, S, hs) for hs in (8, 16, 32, 64)
                     for S in (1, 16, 33, 256)]


def _close(got, ref, rtol):
    """Each gradient within ``rtol`` of its largest |reference|."""
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _max_err(a, b) <= rtol * max(float(b.abs().max().float()),
                                            1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_gated_bwd_matches_plain_on_cuda(cuda, dtype):
    """K3's gated backward kernel against ``rglru_gated_scan_bwd_ref`` on
    the same inputs and forward output h, nonzero dh and dh_last, two runs
    bit-equal (no atomics); one launch counted a call."""
    from repro_torch.kernels.rglru_scan.ref import rglru_gated_scan_bwd_ref
    r = np.random.default_rng(23)
    rglru_ops.BWD_LAUNCHES = 0
    for B, S, W, extreme in RGLRU_BWD_SWEEP:
        ga, gx, xb, lam, h0 = _gated_case(r, B, S, W, TDT[dtype], cuda)
        if extreme:
            ga = (ga.float() * 4 - 10).to(ga.dtype)
        h, _ = rglru_ops.rglru_gated_scan(ga, gx, xb, lam, h0)
        dh = torch.randn(B, S, W, device=cuda)
        dh_last = torch.randn(B, W, device=cuda)
        args = (ga, gx, xb, lam, h0, h, dh, dh_last)
        got = rglru_ops.rglru_gated_scan_bwd(*args)
        again = rglru_ops.rglru_gated_scan_bwd(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        _close(got, rglru_gated_scan_bwd_ref(*args), BWD_RTOL[dtype])
    assert rglru_ops.BWD_LAUNCHES == 2 * len(RGLRU_BWD_SWEEP)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_bwd_matches_plain_on_cuda(cuda, dtype):
    """K4's backward kernels against ``wkv6_chunked_bwd_ref`` on the same
    inputs, its algorithm (``sub=16``, 3xTF32 rounding) and every pair
    exact (``sub=None``), from the states the forward kept (either
    route), lw spread to -3 and down to -20, a carried s0 and nonzero dy
    and ds_out; two runs bit-equal (no atomics). dlw within 1e-3 of its
    largest |reference| in f32 (the pairs' terms cancel in it)."""
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_chunked_bwd_ref
    dt = TDT[dtype]
    r = np.random.default_rng(24)
    for (B, NH, S, hs), lw_min in [(c, m) for c in WKV_BWD_SWEEP
                                   for m in (-3.0, -20.0)]:
        *rkv, lw, u, s0 = _wkv_case(r, B, NH, S, hs, lw_min, dt, cuda)
        y, _, states = wkv_ops._forward(*rkv, lw, u, s0)
        dy = torch.randn_like(y)
        ds_out = torch.randn_like(s0)
        wkv_ops.BWD_LAUNCHES = 0
        got = wkv_ops.wkv6_bwd(*rkv, lw, u, s0, states, dy, ds_out)
        again = wkv_ops.wkv6_bwd(*rkv, lw, u, s0, states, dy, ds_out)
        assert wkv_ops.BWD_LAUNCHES == 2
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        rtol = BWD_RTOL[dtype]
        for sub, tf32x3 in ((16, True), (None, False)):
            ref = wkv6_chunked_bwd_ref(*rkv, lw, u, s0, dy, ds_out, sub=sub,
                                       tf32x3=tf32x3)
            _close(got[:3] + got[4:], ref[:3] + ref[4:], rtol)
            _close(got[3:4], ref[3:4], max(rtol, 1e-3))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_recurrent_backward_kernels_differentiate_on_cuda(cuda):
    """``RGLRUGatedScanFn`` and ``WKV6Fn`` on the card (the forward
    kernels, then the backward kernels) against autograd through the
    plain forwards on the card, for every input that has a gradient, and
    the launches counted once each way."""
    from repro_torch.kernels.rglru_scan.ref import rglru_gated_scan_ref
    r = np.random.default_rng(25)
    ga, gx, xb, lam, h0 = (t.requires_grad_() for t in _gated_case(
        r, 2, 40, 64, torch.float32, cuda))
    dh = torch.randn(2, 40, 64, device=cuda)
    rglru_ops.GATED_LAUNCHES = rglru_ops.BWD_LAUNCHES = 0
    leaves = (ga, gx, xb, lam, h0)
    h, h_last = rglru_ops.RGLRUGatedScanFn.apply(*leaves)
    got = torch.autograd.grad((h * dh).sum() + h_last.sum(), leaves)
    assert rglru_ops.GATED_LAUNCHES == rglru_ops.BWD_LAUNCHES == 1
    h, h_last = rglru_gated_scan_ref(*leaves)
    _close(got, torch.autograd.grad((h * dh).sum() + h_last.sum(), leaves),
           1e-4)
    for S in (1, 45):
        leaves = [t.requires_grad_() for t in _wkv_case(
            r, 2, 3, S, 16, -20.0, torch.float32, cuda)]
        wkv_ops.LAUNCHES = wkv_ops.BWD_LAUNCHES = 0
        y, s = wkv_ops.WKV6Fn.apply(*leaves)
        dy, ds = torch.randn_like(y), torch.randn_like(s)
        got = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
        assert wkv_ops.LAUNCHES == wkv_ops.BWD_LAUNCHES == 1
        y, s = wkv6_ref(*leaves)
        ref = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
        _close(got[:3] + got[4:], ref[:3] + ref[4:], 1e-4)
        _close(got[3:4], ref[3:4], 1e-3)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_local_mesh_on_card(cuda):
    """``make_local_mesh()``: a (1, 1) ("data", "model") mesh over cuda:0
    with its process group of one; ``current_mesh`` is it inside ``with``
    and None outside."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as SH
    mesh = make_local_mesh()
    assert mesh.device_type == "cuda"
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    assert tuple(mesh.mesh.shape) == (1, 1)
    assert SH.current_mesh() is None
    with mesh:
        assert SH.current_mesh() is mesh
    assert SH.current_mesh() is None


@pytest.mark.cuda
def test_sharded_restore_on_card_is_bit_equal(cuda, tmp_path):
    """A SMOKE qwen2.5-3b checkpoint (params and AdamW state after one
    step) restored through ``shardings=`` onto the local mesh: DTensors on
    the card whose local shards are the saved leaves, bit for bit."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as SH
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.optimizer import AdamW, state_shardings
    from repro_torch.training.tree import tree_leaves, tree_map
    cfg = configs.get_smoke("qwen2.5-3b")
    params = MDL.init_params(generator_for(cuda, 3), cfg, device=cuda)
    opt = AdamW()
    grads = tree_map(lambda p: p * 0.5 + 0.25, params)
    params, state, _ = opt.update(grads, opt.init(params), params)
    CKPT.save_checkpoint(tmp_path, 1, params, state)
    mesh = make_local_mesh()
    tmpl_p = MDL.param_shapes(cfg)
    tmpl_o = opt.state_shapes(tmpl_p)
    step, got_p, got_o, _ = CKPT.restore_checkpoint(
        tmp_path, 1, tmpl_p, tmpl_o,
        shardings=SH.param_shardings(tmpl_p, mesh),
        opt_shardings=state_shardings(tmpl_o, mesh))
    assert step == 1
    for a, b in zip(tree_leaves((params, state.m, state.v)),
                    tree_leaves((got_p, got_o.m, got_o.v))):
        assert isinstance(b, DTensor) and b.to_local().is_cuda
        assert torch.equal(a, b.to_local())
    local = CKPT.local_tree(got_p)
    assert all(type(t) is torch.Tensor for t in tree_leaves(local))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_lower_cell_argument_bytes_match_allocated(cuda, kind):
    """The dry run's per-device argument bytes on a (1, 1) mesh against
    the caching allocator's growth when the same params, AdamW state or
    cache, and batch are placed on the card: the requested bytes equal,
    ``torch.cuda.memory_allocated`` within its rounding, 512 bytes a
    tensor (every SMOKE tensor is under 1 MiB)."""
    from repro_torch.configs.shapes import ShapeCell, input_specs
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.tree import tree_leaves
    cfg = configs.get_smoke("qwen2.5-3b")
    cell = ShapeCell(f"smoke_{kind}", kind, 64, 8)
    rec = D.lower_cell("qwen2.5-3b", cell, AbstractMesh((1, 1), ("data",
                                                                 "model")),
                       cfg_override=cfg)
    params = MDL.param_shapes(cfg)
    state = (AdamW().state_shapes(params) if kind == "train" else
             MDL.init_cache(cfg, 8, 64, device="meta"))
    metas = D._leaves((params, state, input_specs(cfg, cell)))
    def now():
        torch.cuda.synchronize()
        return (torch.cuda.memory_allocated(),
                torch.cuda.memory_stats()["requested_bytes.all.current"])

    a0, r0 = now()
    held = [torch.empty(t.shape, dtype=t.dtype, device=cuda) for t in metas]
    a1, r1 = now()
    want = rec["memory"]["argument_bytes"]
    assert want == sum(t.numel() * t.element_size() for t in held)
    assert r1 - r0 == want
    assert 0 <= (a1 - a0) - want <= 512 * len(held), (a1 - a0, want)
    del held
