"""The port's CUDA kernels against their plain versions, and the model on
the card against the model on the CPU. Every test here needs the card
(marker ``cuda``) and skips without one; the file imports neither jax nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: K1/K2 f32 2e-5, bf16 2e-2 and K3 1e-5, K4 5e-4 (those of
tests/test_kernels.py); K4 in bf16 2e-2; fp32 model logits 1e-3; K6
(the int8 matmul) 10x those, as tests/test_kernels.py:117. K5 (the
planner's masked argmax) and the torch planner backend are exact. The
last test runs the live testbed's smoke spec on the card.
"""

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
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
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
]
DECODE_SWEEP = [                    # tests/test_kernels.py:42-46
    (3, 8, 2, 64, 200, 0),
    (2, 4, 1, 32, 64, 16),
    (1, 16, 16, 128, 300, 0),
    (4, 10, 1, 256, 512, 0),                # recurrentgemma heads
    (2, 8, 2, 16, 96, 0),                   # the testbed's smoke rungs
    (2, 2, 1, 16, 96, 8),
]
SCAN_SWEEP = [(2, 100, 256), (1, 64, 128), (3, 17, 256),     # :64-68
              (1, 256, 2560), (4, 1, 2560)]
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
        k5.LAUNCHES = 0
        r_t = plan_greedy_torch(apps, cluster, state=PlannerState(
            cluster, subscribe=False, dtype=dtype), ctx=ctx, **kw)
        assert k5.LAUNCHES == len(apps)
        assert {k: (v.name, s) for k, (v, s) in r_np.assignment.items()} \
            == {k: (v.name, s) for k, (v, s) in r_t.assignment.items()}
        assert list(r_np.assignment) == list(r_t.assignment)
        assert r_np.unplaced == r_t.unplaced
        assert r_np.objective == r_t.objective


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_plain_on_cuda(cuda, dtype):
    """K6 against its plain version: the sweep of tests/test_kernels.py
    (ragged M, N, K; an int8 row of 130 bytes), a view of x with a row
    stride, a w_q whose N is not a multiple of 4, and the decode and
    prefill M at a qwen3-32b MLP shape."""
    from repro_torch.kernels.int8_matmul import ops as k6
    dt = TDT[dtype]
    g = torch.Generator(device=cuda).manual_seed(4)
    k6.LAUNCHES = 0
    n = 0
    for M, K, N in ((100, 300, 200), (64, 128, 64), (33, 65, 130),
                    (4, 5120, 1030), (256, 512, 2048)):
        x = torch.randn(M, K + 3, generator=g, device=cuda).to(dt)[:, 3:]
        w = torch.randn(K, N, generator=g, device=cuda) * 0.05
        wq, sc = k6.quantize_int8(w)
        for out_dtype in (None, torch.float32):
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
