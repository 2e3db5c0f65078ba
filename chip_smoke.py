#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; no arguments

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

0. device: the card's name and power limit, TF32 off;
1. build: the six CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
   one ``nvcc`` each, all at once;
2. kernels: each against its plain PyTorch version on the card —
   K1 (prefill flash attention) and K2 (decode attention) on the sweeps of
   tests/test_kernels.py (f32 2e-5, bf16 2e-2), K3 (RG-LRU scan, f32 1e-5)
   and K4 (WKV-6, f32 5e-4, bf16 2e-2) on the sweeps of
   tests/test_kernels.py, and each at the shapes of every ladder rung that
   phases 4 and 6 serve (heads, KV heads, head_dim and window of each
   attention rung, one prompt where recurrentgemma-2b's window binds; the
   LRU width and the WKV heads of each recurrent rung; from a nonzero
   state), the testbed's smoke rungs (head_dim 16) in f32. The main-path
   shapes are timed in bf16 (the smoke rungs in f32) beside the plain
   version, the bound, and, for K1/K2, PyTorch's
   ``scaled_dot_product_attention`` (a yardstick the port never calls).
   K6 (the weight-only int8 matmul, which no model calls, as in the JAX
   package) on the sweep of tests/test_kernels.py:102-104 in f32 and bf16
   and at qwen3-32b's MLP shapes in bf16, within 10x the K1 tolerances,
   timed beside its plain version, the bound and
   ``torch._weight_int8pack_mm`` (a yardstick); its launches are counted
   on a standalone int8 SwiGLU over qwen3-32b's quantized MLP weights;
3. model parity, fp32, card (kernels) against CPU (plain path): qwen2.5-3b
   (2 layers), recurrentgemma-2b (one (rglru, rglru, local) cycle plus an
   (rglru, rglru) tail, a 2100-token prompt so the local layer's window
   binds and its ring buffer wraps), rwkv6-3b (2 layers, 250 tokens),
   qwen3-32b (2 layers, qk_norm) and qwen3-moe-30b-a3b (2 layers, 128
   experts top-8), all at full width, prefill and three decode steps;
4. serve and fail over, for each of qwen2.5-3b, recurrentgemma-2b,
   rwkv6-3b and qwen3-32b (32 of its 64 layers: two full-width copies do
   not fit 80 GB at full depth) in turn: worker A serves the ladder's
   ``:full`` rung (bf16) to
   4 requests, its tokens are held against the model's own prefill/decode,
   a fifth request on a reused slot against a fresh engine, A is killed,
   the heartbeat detector reports it, the router moves the app to worker
   B's warm ``:w050`` and B serves the same requests, its tokens held
   against the model's own prefill/decode on B's params. Kernel launch
   counters are zeroed before and read after each serving run and must
   show one launch per layer of each kind per prefill and per decode step.
   Each arch is unloaded before the next one loads;
5. the simulator's failover planning (the greedy planner's ``torch``
   backend, whose worst-fit reduction is K5, the masked argmax): K5
   exactly equal to its plain version (index and value) for S in
   ``ARGMAX_SIZES`` x float32/float64 x empty/sparse/dense/all-tied masks,
   one row and (8, S) rows over one shared column, the dense ones timed
   beside the plain version, the bound and ``torch.where`` +
   ``torch.argmax`` (a yardstick, printed only); ``plan_greedy_torch`` on
   the card equal to the port's numpy planner (assignments, their order,
   the unplaced list, the objective bits) on 20 random instances per
   state dtype; and tools/bench_scale.py's 1000-server x 10,000-app cell
   through ``Simulation(SimConfig(planner="greedy",
   planner_backend=...)).setup().run_named_scenario("site-outage")`` on
   the torch backend and on numpy in this process from one seed, their
   recovery records, placements and traffic summaries equal. It prints
   each backend's plan wall, peak failover plan phase, rounds and K5
   launches per round, all from these two unprofiled runs, and the
   device idle share of one failover round from a third, profiled torch
   run that replays the round before planning it. K5's counter is
   zeroed just before the first torch run and read after it;
6. the live failover testbed through the port's entry points, on the
   card: (a) ``run_experiment(ExperimentSpec(backend="testbed", ...))``
   on tests/test_experiment.py:185's spec with the default arch list
   (all five testbed archs on their smoke ladders, 3 sites x 2 servers),
   then the same spec on the ``sim`` backend: equal failover choices
   (``recovery_by_app()``), recovery rate 1, detection under 1 s, a
   finite client MTTR, no error other than a dead server, and K1-K5 each
   launched during the testbed run (counters zeroed just before it, read
   just after); (b) a ``MiniTestbed`` of two critical apps at full width
   (qwen2.5-3b's published config, qwen3-32b's published widths at 8
   layers) whose qwen3-32b primary is killed: that app recovers and its
   clients are served after the kill; it prints the recovered variant,
   detection, client downtime, the measured load seconds, the plan wall
   and the peak memory allocated.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches, error, times and bound.
"""

from __future__ import annotations

import functools
import gc
import json
import re
import shutil
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
DEV = torch.device("cuda")

# H100 SXM data-sheet peaks (dense): HBM rate, bf16 tensor-core rate (K1
# and K2 at the main path's bf16 shapes) and fp32 rate outside the tensor
# cores (K3 and K4 compute in fp32 FMAs)
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_ATOL = 1e-5           # K3, tests/test_kernels.py:77-78
WKV_ATOL = 5e-4            # K4 in f32, tests/test_kernels.py:99-100
LOGIT_ATOL = 1e-3          # fp32 model parity, card vs CPU
SEED = 0

FLASH_SWEEP = [                     # tests/test_kernels.py:18-23
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 100, 100, 4, 1, 64, True, 16),
    (2, 96, 96, 8, 8, 32, False, 0),
    (1, 33, 33, 2, 2, 128, True, 8),
    (2, 77, 77, 16, 2, 128, True, 0),       # ragged, tests/test_torch_cuda
    (1, 150, 150, 4, 1, 256, True, 0),
]
DECODE_SWEEP = [                    # tests/test_kernels.py:42-46
    (3, 8, 2, 64, 200, 0),
    (2, 4, 1, 32, 64, 16),
    (1, 16, 16, 128, 300, 0),
    (2, 4, 4, 128, 300, 0),                 # G = 1, 5, 8, 32 as
    (4, 5, 1, 256, 512, 100),               # tests/test_torch_cuda.py
    (4, 16, 2, 128, 512, 0),
    (2, 32, 1, 64, 700, 0),
]
SCAN_SWEEP = [(2, 100, 256), (1, 64, 128), (3, 17, 256)]    # :64-68
WKV_SWEEP = [(2, 3, 70, 16), (1, 2, 64, 32), (2, 1, 33, 8)]  # :82-86
# ladder rungs whose kernel shapes phase 2 checks and times: the :full and
# :w050 that phase 4 serves, and qwen2.5-3b's w075 as a reference row
RUNGS = {"qwen2.5-3b": ("full", "w075", "w050"),
         "recurrentgemma-2b": ("full", "w050"),
         "rwkv6-3b": ("full", "w050"),
         "qwen3-32b": ("full", "w050")}
PREFILL_LENS = (128, 256, 512)
RAGGED_LEN = 333            # K1 rows whose prompt ends inside a query tile
RAGGED_TAGS = ("qwen2.5-3b full", "recurrentgemma-2b full")
BINDING_LEN = 2100          # a prompt past recurrentgemma-2b's window 2048
SLOTS, MAX_LEN, NEW_TOKENS = 4, 512, 32
DECODE_LENS = [97, 161, 288, 512]
ARCHS = ("qwen2.5-3b", "recurrentgemma-2b", "rwkv6-3b", "qwen3-32b")
# phase 4's depth cuts: qwen3-32b's :full at 64 layers is ~65.5 GB of bf16
# weights and its :w050 ~17 GB more, which do not fit 80 GB together
SERVE_LAYERS = {"qwen3-32b": 32}
# phase 6: tests/test_experiment.py:185's testbed spec with the default
# arch list, and the full-width testbed's depth of qwen3-32b (the card
# holds up to four copies of the largest rung at once: primary, warm
# backup, the re-protection load and the killed worker's engine)
TESTBED_SPEC = dict(scenario="single-server", app_mix="arch", archs=None,
                    n_sites=3, servers_per_site=2, headroom=0.35,
                    client_hz=20.0, time_scale=0.25, settle_s=25.0, seed=1)
FULL_TESTBED_LAYERS = {"qwen2.5-3b": None, "qwen3-32b": 8}
# the testbed's smoke ladders serve f32 engines of 2 slots x 96 positions
# with 8-token prompts (serving/server.py, serving/workload.py)
SMOKE_SLOTS, SMOKE_MAX_LEN, SMOKE_PROMPT = 2, 96, 8
# K6 at qwen3-32b's MLP: gate/up (M, 5120) x (5120, 25600) and down
# (M, 25600) x (25600, 5120), at decode (4 slots) and a 256-token prefill
INT8_SWEEP = [(100, 300, 200), (64, 128, 64), (33, 65, 130)]  # :102-104
INT8_MLP = {"gate/up": (5120, 25600), "down": (25600, 5120)}
INT8_M = (SLOTS, 256)
# name -> (source, TPU kernel it replaces, headline row of the JSON line)
KERNELS = {
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:29",
        "qwen2.5-3b full S=256"),
    "decode_attention": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:27",
        "qwen2.5-3b full decode"),
    "rglru_scan": (
        "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan/rglru_scan.py:25",
        "recurrentgemma-2b full S=256"),
    "rwkv6_scan": (
        "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
        "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:26",
        "rwkv6-3b full S=256"),
    "planner_argmax": (
        "src/repro_torch/kernels/planner_argmax/csrc/planner_argmax.cu",
        "src/repro/kernels/planner_argmax/planner_argmax.py:29",
        "(8,1000) float64 dense"),
    "int8_matmul": (
        "src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu",
        "src/repro/kernels/int8_matmul/int8_matmul.py:24",
        "qwen3-32b gate/up M=4"),
}
INT8_PATH = "standalone (no JAX caller): int8 SwiGLU at qwen3-32b's MLP"
# the smoke :full rungs whose K1/K2 shapes phase 2 times (the attention
# archs of the testbed's default list)
TESTBED_SMOKE_TIMED = ("qwen2.5-3b", "qwen3-32b", "recurrentgemma-2b",
                       "qwen3-moe-30b-a3b")
# the serving kernels' device names, as torch.profiler reports them: K1's
# tensor-core (bf16) and scalar (f32) kernels, K2's split and combine
# passes, K3, K4
PORT_KERNEL_NAMES = ("fa_tc_kernel", "fa_kernel", "dec_split_kernel",
                     "dec_combine_kernel", "rglru_kernel", "wkv_kernel")
NO_LIBRARY = {
    "rglru_scan": "none: no single PyTorch call computes this recurrence",
    "rwkv6_scan": "none: no single PyTorch call computes this recurrence",
    "planner_argmax": "none (no single PyTorch call)",
}
# phase 5: K5 at the planner's column lengths (servers) and past them, one
# row and the (V, S) rows the planner asks for at once
ARGMAX_SIZES = (6, 1000, 10000, 100000)
ARGMAX_ROWS = 8
PLANNER_INSTANCES = 20             # random instances per state dtype
# the simulator's first full scale cell (tools/bench_scale.py:56-58): 1000
# servers in 20 sites of 50, ~10,000 apps, server memory sized so the
# primaries fill half the cluster, headroom 0.2, traffic at rate scale 2.0
# in 0.5 s chunks, the epoch drain, the site-outage scenario
SIM_CELL = dict(n_servers=1000, n_apps=10000, per_site=50, rate_scale=2.0,
                chunk_s=0.5, scenario="site-outage")
AVG_FULL_MEM, PRIMARY_UTIL = 2.3e9, 0.5     # tools/bench_scale.py:46-47


def log(*a):
    print(*a, flush=True)


def all_ops():
    """Every kernel's wrapper module, by kernel name."""
    from repro_torch.kernels.int8_matmul import ops as k6
    from repro_torch.kernels.planner_argmax import ops as k5
    return {**ops_modules(), "planner_argmax": k5, "int8_matmul": k6}


def ops_modules():
    """The four serving kernels' wrapper modules, by kernel name."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru_scan import ops as rg
    from repro_torch.kernels.rwkv6_scan import ops as wkv
    return {"flash_attention": fa, "decode_attention": dec,
            "rglru_scan": rg, "rwkv6_scan": wkv}


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
    del graph
    return statistics.median(out)


def peak_for(dtype):
    """The operation rate a kernel's dtype runs at: K1/K2's bf16 paths on
    the tensor cores (K2 is bound by bytes either way), their f32 paths
    in scalar fp32 FMAs."""
    return PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS


def bound(nbytes, flops, peak):
    """Least time in ms for the card to move ``nbytes`` and do ``flops``
    operations at ``peak`` per second, and which of the two bounds it."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else
            "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def err(a, b):
    return float((a.float() - b.float()).abs().max())


def timed_row(shape, e, kern, plain, lib, n_bytes, flops, peak,
              plain_reps=20):
    """Device ms of the kernel, its plain version and the library call
    (None when there is none), beside the bound for these inputs."""
    b_ms, b_by = bound(n_bytes, flops, peak)
    return dict(shape=shape, max_abs_err=e, ms=graph_ms(kern),
                eager_ms=eager_ms(kern),
                plain_ms=graph_ms(plain, reps=plain_reps),
                library_ms=None if lib is None else graph_ms(lib),
                bound_ms=b_ms, bound_by=b_by,
                peak=("bf16 tensor core" if peak == PEAK_BF16_FLOPS
                      else "fp32 non-tensor"))


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_args(c):
    """The serving kernels' shapes for one model config: ``{kernel: args}``
    with args (H, KVH, hd, window) for K1/K2, the LRU width for K3 and
    (heads, head size) for K4."""
    from repro_torch.models.model import ATTN_KINDS

    kinds = set(c.layer_kinds())
    out = {}
    if kinds & set(ATTN_KINDS):
        window = c.window_size if "local" in kinds else 0
        out["flash_attention"] = out["decode_attention"] = (
            c.num_heads, c.num_kv_heads, c.head_dim, window)
    if "rglru" in kinds:
        out["rglru_scan"] = c.rnn_width
    if "rwkv" in kinds:
        hs = c.rwkv_head_size
        out["rwkv6_scan"] = (c.d_model // hs, hs)
    return out


def smoke_full_config(arch):
    """The config of the testbed's smoke ``:full`` rung of ``arch``."""
    from repro_torch.experiment.workload import testbed_ladder
    return testbed_ladder(arch)[0].config


def rung_shapes():
    """Each kernel's shapes on the rungs of ``RUNGS``, from the ladder the
    workers load: ``{kernel: [(tag, args), ...]}``."""
    from repro_torch import configs
    from repro_torch.core.variants import build_ladder

    out = {k: [] for k in KERNELS}
    for arch, rungs in RUNGS.items():
        ladder = {v.name: v.config
                  for v in build_ladder(configs.get_config(arch))}
        for rung in rungs:
            for k, args in kernel_args(ladder[f"{arch}:{rung}"]).items():
                out[k].append((f"{arch} {rung}", args))
    return out


def testbed_rung_shapes():
    """Each serving kernel's distinct shapes on every rung phase 6 can
    load: ``(smoke, full)``, each ``{kernel: sorted args}`` — the smoke
    ladders of the five testbed archs (f32, head_dim 16) and the
    full-width ladders of phase 6 (b). Rungs whose query heads do not
    divide among their KV heads (ROADMAP R8: the smoke :w075 of qwen2.5-3b
    and qwen3-moe-30b-a3b) are left out: no model of either package
    builds them, so no worker loads them."""
    from repro_torch import configs
    from repro_torch.core.variants import build_ladder
    from repro_torch.experiment.workload import TESTBED_ARCHS, testbed_ladder

    def collect(ladders):
        out = {k: set() for k in ops_modules()}
        for ladder in ladders:
            for v in ladder:
                c = v.config
                if c.num_heads and c.num_heads % c.num_kv_heads:
                    continue
                for k, args in kernel_args(c).items():
                    out[k].add(args)
        return {k: sorted(v) for k, v in out.items()}

    smoke = collect(testbed_ladder(a) for a in TESTBED_ARCHS)
    full = collect(build_ladder(configs.get_config(a)) for a in
                   FULL_TESTBED_LAYERS)
    return smoke, full


def phase_kernels():
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_ref as dec_ref
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_ref as fa_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

    ops = ops_modules()
    fa_ops, dec_ops = ops["flash_attention"], ops["decode_attention"]
    rg_ops, wkv_ops = ops["rglru_scan"], ops["rwkv6_scan"]
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(SEED)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def rnd(shape, dt=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    def flash_plain(q, k, v, causal, window):
        return fa_ref(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal,
                      window=window).transpose(1, 2)

    def dec_plain(q, kc, vc, lens, window):
        return dec_ref(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2),
                       lens, window=window)[:, None]

    def check(name, e, tol, what):
        log(f"  {name} {what}: max_abs_err {e:.3g}")
        if not e < tol:
            raise AssertionError(f"{name} {what}: err {e} >= {tol}")

    def scan_inputs(B, S, W):
        a = torch.sigmoid(rnd((B, S, W))) * 0.2 + 0.8
        return a, rnd((B, S, W)) * 0.1, rnd((B, W))

    def wkv_inputs(B, NH, S, hs, dt):
        r, k, v = (rnd((B, S, NH, hs), dt) for _ in range(3))
        # lw spread over [-3, -0.05], as rwkv6-3b's decay_base reaches
        lw = -torch.exp(torch.empty((B, S, NH, hs), device=dev).uniform_(
            float(np.log(0.05)), float(np.log(3.0)), generator=g))
        return r, k, v, lw, rnd((NH, hs)) * 0.3, rnd((B, NH, hs, hs)) * 0.3

    shapes = rung_shapes()
    smoke, full6 = testbed_rung_shapes()
    attn = sorted({a for _, a in shapes["flash_attention"]}
                  | set(full6["flash_attention"]))
    flash_rungs = [(1, S, S, H, KVH, hd, True, window)
                   for H, KVH, hd, window in attn
                   for S in (256,) + ((BINDING_LEN,) if window else ())]
    decode_rungs = [(SLOTS, H, KVH, hd, MAX_LEN, 0)
                    for H, KVH, hd, _w in attn]
    wkv_rungs = [(B, NH, S, hs) for _, (NH, hs) in shapes["rwkv6_scan"]
                 for B, S in ((1, 256), (SLOTS, 1))]
    scan_rungs = [(B, S, W) for _, W in shapes["rglru_scan"]
                  for B, S in ((1, 256), (SLOTS, 1))]
    # the testbed's smoke rungs, in f32 as they are served: an 8-token
    # prompt, a longer one where the local window (8) binds, and decode
    # over 2 slots of the 96-position cache (the local ring: its window)
    smoke_flash = [(SMOKE_SLOTS, S, S, H, KVH, hd, True, window)
                   for H, KVH, hd, window in smoke["flash_attention"]
                   for S in (SMOKE_PROMPT, 33)]
    smoke_decode = [(SMOKE_SLOTS, H, KVH, hd,
                     min(window, SMOKE_MAX_LEN) if window else SMOKE_MAX_LEN,
                     0) for H, KVH, hd, window in smoke["decode_attention"]]
    smoke_wkv = [(B, NH, S, hs) for NH, hs in smoke["rwkv6_scan"]
                 for B, S in ((1, SMOKE_PROMPT), (SMOKE_SLOTS, 1))]
    smoke_scan = [(B, S, W) for W in smoke["rglru_scan"]
                  for B, S in ((1, SMOKE_PROMPT), (SMOKE_SLOTS, 1))]
    log(f"  the testbed's smoke rungs: K1/K2 (H, KVH, hd, window) "
        f"{smoke['flash_attention']}, K3 widths {smoke['rglru_scan']}, K4 "
        f"(heads, head size) {smoke['rwkv6_scan']}; phase 6 (b)'s "
        f"full-width rungs {full6['flash_attention']}")

    # -- sweeps and every rung's shapes, both dtypes where the kernel takes
    # them ------------------------------------------------------------------
    for name, dt in dts.items():
        smoke_only = name == "float32"
        for B, Sq, Skv, H, KVH, hd, causal, window in FLASH_SWEEP + \
                flash_rungs + (smoke_flash if smoke_only else []):
            q, k, v = (rnd((B, Sq, H, hd), dt), rnd((B, Skv, KVH, hd), dt),
                       rnd((B, Skv, KVH, hd), dt))
            check("flash_attention", err(
                fa_ops.flash_attention(q, k, v, causal=causal,
                                       window=window),
                flash_plain(q, k, v, causal, window)), ATOL[name],
                f"{name} B={B} S={Sq} H={H} KVH={KVH} hd={hd} "
                f"causal={causal} window={window}")
        for B, H, KVH, hd, Smax, window in DECODE_SWEEP + decode_rungs + \
                (smoke_decode if smoke_only else []):
            q, kc, vc = (rnd((B, 1, H, hd), dt), rnd((B, Smax, KVH, hd), dt),
                         rnd((B, Smax, KVH, hd), dt))
            lens = torch.randint(1, Smax + 1, (B,), generator=g, device=dev,
                                 dtype=torch.int32)
            check("decode_attention", err(
                dec_ops.decode_attention(q, kc, vc, lens, window=window),
                dec_plain(q, kc, vc, lens, window)), ATOL[name],
                f"{name} B={B} H={H} KVH={KVH} hd={hd} Smax={Smax} "
                f"window={window}")
        for B, NH, S, hs in WKV_SWEEP + wkv_rungs + \
                (smoke_wkv if smoke_only else []):
            r, k, v, lw, u, s0 = wkv_inputs(B, NH, S, hs, dt)
            y_ref, s_ref = wkv6_ref(r, k, v, lw, u, s0)
            state = s0.clone()
            y, _ = wkv_ops.wkv6(r, k, v, lw, u, state, s_out=state)
            tol = WKV_ATOL if name == "float32" else ATOL[name]
            check("rwkv6_scan", max(err(y, y_ref), err(state, s_ref)), tol,
                  f"{name} B={B} NH={NH} S={S} hs={hs} from a nonzero "
                  "state")
    for B, S, W in SCAN_SWEEP + scan_rungs + smoke_scan:
        a, b, h0 = scan_inputs(B, S, W)
        h_ref, hl_ref = rglru_scan_ref(a, b, h0)
        state = h0.clone()
        h, _ = rg_ops.rglru_scan(a, b, state, h_last=state)
        check("rglru_scan", max(err(h, h_ref), err(state, hl_ref)),
              SCAN_ATOL, f"float32 B={B} S={S} W={W} from a nonzero h0")

    # -- main-path shapes, timed --------------------------------------------
    bf16 = torch.bfloat16
    rows = {k: {} for k in KERNELS}

    def flash_row(tag, H, KVH, hd, S, window, dt=bf16, B=1):
        q, k, v = (rnd((B, S, H, hd), dt), rnd((B, S, KVH, hd), dt),
                   rnd((B, S, KVH, hd), dt))
        e = err(fa_ops.flash_attention(q, k, v, causal=True, window=window),
                flash_plain(q, k, v, True, window))
        dname = str(dt).replace("torch.", "")
        if not e < ATOL[dname]:
            raise AssertionError(f"flash_attention {tag}: {e}")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        pos = torch.arange(S, device=dev)
        band = pos[:, None] >= pos[None, :]
        if window:
            band &= pos[None, :] > pos[:, None] - window
        # score pairs this causal (and windowed) attention needs
        pairs = int(band.sum())
        if window and window < S:
            lib = functools.partial(F.scaled_dot_product_attention, qt, kt,
                                    vt, attn_mask=band, enable_gqa=True)
        else:
            lib = functools.partial(F.scaled_dot_product_attention, qt, kt,
                                    vt, is_causal=True, enable_gqa=True)
        rows["flash_attention"][tag] = timed_row(
            f"q ({B},{S},{H},{hd}) k/v ({B},{S},{KVH},{hd}) {dname} causal"
            + (f" window {window}" if window else ""), e,
            functools.partial(fa_ops.flash_attention, q, k, v, causal=True,
                              window=window),
            lambda: flash_plain(q, k, v, True, window), lib,
            nbytes(q, k, v, q), 4 * hd * H * pairs * B, peak_for(dt))

    def decode_row(tag, H, KVH, hd, dt=bf16, B=SLOTS, Smax=MAX_LEN,
                   lens_list=DECODE_LENS):
        q = rnd((B, 1, H, hd), dt)
        kc, vc = (rnd((B, Smax, KVH, hd), dt), rnd((B, Smax, KVH, hd), dt))
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        e = err(dec_ops.decode_attention(q, kc, vc, lens),
                dec_plain(q, kc, vc, lens, 0))
        dname = str(dt).replace("torch.", "")
        if not e < ATOL[dname]:
            raise AssertionError(f"decode_attention {tag}: {e}")
        mask = (torch.arange(Smax, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        n_keys = int(lens.sum())
        rows["decode_attention"][tag] = timed_row(
            f"q ({B},1,{H},{hd}) cache ({B},{Smax},{KVH},{hd}) "
            f"{dname} lens {lens_list}", e,
            functools.partial(dec_ops.decode_attention, q, kc, vc, lens),
            lambda: dec_plain(q, kc, vc, lens, 0),
            functools.partial(F.scaled_dot_product_attention, qt, kt, vt,
                              attn_mask=mask, enable_gqa=True),
            q.element_size() * (2 * q.numel() + 2 * n_keys * KVH * hd)
            + 4 * B, 4 * hd * H * n_keys, peak_for(dt))
        n_split, chunk = dec_ops.plan_split(B, KVH, Smax, dec_ops.sm_count(
            torch.cuda.current_device()))
        rows["decode_attention"][tag].update(
            n_split=n_split, chunk=chunk, blocks=n_split * KVH * B)

    def scan_row(tag, B, S, W):
        a, b, h0 = scan_inputs(B, S, W)
        state = h0.clone()
        h, _ = rg_ops.rglru_scan(a, b, state, h_last=state)
        h_ref, hl_ref = rglru_scan_ref(a, b, h0)
        e = max(err(h, h_ref), err(state, hl_ref))
        if not e < SCAN_ATOL:
            raise AssertionError(f"rglru_scan {tag}: {e}")
        rows["rglru_scan"][tag] = timed_row(
            f"a/b ({B},{S},{W}) f32, h0 ({B},{W})", e,
            functools.partial(rg_ops.rglru_scan, a, b, state, h_last=state),
            lambda: rglru_scan_ref(a, b, h0), None,
            nbytes(a, b, h0, h, state), 2 * a.numel(), PEAK_FP32_FLOPS,
            plain_reps=2)

    def wkv_row(tag, B, S, NH, hs):
        r, k, v, lw, u, s0 = wkv_inputs(B, NH, S, hs, bf16)
        state = s0.clone()
        y, _ = wkv_ops.wkv6(r, k, v, lw, u, state, s_out=state)
        y_ref, s_ref = wkv6_ref(r, k, v, lw, u, s0)
        e = max(err(y, y_ref), err(state, s_ref))
        if not e < ATOL["bfloat16"]:
            raise AssertionError(f"rwkv6_scan {tag}: {e}")
        # what the function needs per (row, head, step): r.S (2 hs^2) and
        # S = w*S + k v^T (3 hs^2), plus exp(lw), u*k, its dot with r and
        # the bonus row (6 hs)
        flops = B * S * NH * (5 * hs + 6) * hs
        rows["rwkv6_scan"][tag] = timed_row(
            f"r/k/v ({B},{S},{NH},{hs}) bf16, lw f32, state "
            f"({B},{NH},{hs},{hs}) f32", e,
            functools.partial(wkv_ops.wkv6, r, k, v, lw, u, state,
                              s_out=state),
            lambda: wkv6_ref(r, k, v, lw, u, s0), None,
            nbytes(r, k, v, lw, u, s0, y, state), flops, PEAK_FP32_FLOPS,
            plain_reps=2)

    for tag, (H, KVH, hd, window) in shapes["flash_attention"]:
        for S in PREFILL_LENS + ((BINDING_LEN,) if window else ()):
            flash_row(f"{tag} S={S}", H, KVH, hd, S, window)
    # a prompt that is no multiple of K1's 64-row query tile, at head_dim
    # 128 and 256
    for tag, (H, KVH, hd, window) in shapes["flash_attention"]:
        if tag in RAGGED_TAGS:
            flash_row(f"{tag} S={RAGGED_LEN} ragged", H, KVH, hd, RAGGED_LEN,
                      window)
    for tag, (H, KVH, hd, _w) in shapes["decode_attention"]:
        decode_row(f"{tag} decode", H, KVH, hd)
    r = rows["decode_attention"]["qwen2.5-3b full decode"]
    log(f"  K2 split-KV at qwen2.5-3b :full decode (B={SLOTS}, Smax="
        f"{MAX_LEN}, KVH 2): n_split {r['n_split']} chunks of {r['chunk']} "
        f"keys, {r['blocks']} blocks, then the combine kernel")
    if r["blocks"] < 64:
        raise AssertionError(f"K2 launches {r['blocks']} blocks at "
                             "qwen2.5-3b's decode shape, want >= 64")
    # the testbed's smoke :full rungs, f32 as they are served
    seen = set()
    for arch in TESTBED_SMOKE_TIMED:
        c = smoke_full_config(arch)
        H, KVH, hd, window = kernel_args(c)["flash_attention"]
        if (H, KVH, window) in seen:
            continue
        seen.add((H, KVH, window))
        tag = f"{arch} smoke full"
        flash_row(f"{tag} S={SMOKE_PROMPT}", H, KVH, hd, SMOKE_PROMPT,
                  window, dt=torch.float32)
        Smax = min(window, SMOKE_MAX_LEN) if window else SMOKE_MAX_LEN
        decode_row(f"{tag} decode", H, KVH, hd, dt=torch.float32,
                   B=SMOKE_SLOTS, Smax=Smax,
                   lens_list=[min(SMOKE_PROMPT + 1, Smax), min(40, Smax)])
    for rung, W in shapes["rglru_scan"]:
        scan_row(f"{rung} S=256", 1, 256, W)
        scan_row(f"{rung} decode", SLOTS, 1, W)
    for rung, (NH, hs) in shapes["rwkv6_scan"]:
        wkv_row(f"{rung} S=256", 1, 256, NH, hs)
        wkv_row(f"{rung} decode", SLOTS, 1, NH, hs)

    for kname, by_tag in rows.items():
        for tag, r in by_tag.items():
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.5f}")
            split = (f"; n_split {r['n_split']} x {r['chunk']} keys, "
                     f"{r['blocks']} blocks" if "n_split" in r else "")
            log(f"  {kname} {tag} [{r['shape']}]: device ms kernel "
                f"{r['ms']:.5f}, plain {r['plain_ms']:.5f}, library {lib}, "
                f"bound {r['bound_ms']:.5f} ({r['bound_by']}, "
                f"{r['peak']} peak); eager call {r['eager_ms']:.5f} ms; "
                f"max_abs_err {r['max_abs_err']:.3g}{split}")
    torch.cuda.synchronize()
    return rows


def int8_library():
    """The yardstick for K6: one PyTorch call that computes the same
    function, ``torch._weight_int8pack_mm`` (w as (N, K) int8, the scale
    in x's dtype) where this torch has it for CUDA, else a bf16 matmul of
    the widened weight times the scale. Timed, never called by the port."""
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=DEV)
    try:
        torch._weight_int8pack_mm(x, torch.zeros((32, 64), dtype=torch.int8,
                                                 device=DEV),
                                  torch.ones(32, dtype=x.dtype, device=DEV))
    except (AttributeError, RuntimeError, NotImplementedError):
        return ("torch.matmul(x, w_q.to(x.dtype)) * scale",
                lambda x, wq, wqt, sc, scx: torch.matmul(
                    x, wq.to(x.dtype)) * scx)
    return ("torch._weight_int8pack_mm",
            lambda x, wq, wqt, sc, scx: torch._weight_int8pack_mm(
                x, wqt, scx))


def int8_swiglu(k6, x, layer):
    """A standalone use of K6: one SwiGLU MLP whose three weights are
    int8 with per-channel scales (``quantize_int8``), every product a K6
    launch. ``layer`` holds (w_q, scale) for gate, up and down."""
    g = k6.int8_matmul(x, *layer["gate"])
    u = k6.int8_matmul(x, *layer["up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return k6.int8_matmul(h, *layer["down"])


def phase_int8():
    """K6 against its plain version: the sweep of tests/test_kernels.py
    in f32 and bf16, and qwen3-32b's MLP shapes in bf16, timed beside the
    plain version, the bound and the library yardstick; then a standalone
    int8 SwiGLU at those shapes, the only launches counted. Returns (rows,
    launches of the standalone run)."""
    from repro_torch.kernels.int8_matmul import ops as k6

    g = torch.Generator(device=DEV).manual_seed(SEED)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def quantized(K, N):
        w = torch.randn((K, N), generator=g, device=DEV) * 0.05
        return k6.quantize_int8(w)

    for name, dt in dts.items():
        for M, K, N in INT8_SWEEP:
            x = torch.randn((M, K), generator=g, device=DEV).to(dt)
            wq, sc = quantized(K, N)
            e = err(k6.int8_matmul(x, wq, sc),
                    k6.int8_matmul_torch(x, wq, sc))
            log(f"  int8_matmul {name} ({M},{K})x({K},{N}): max_abs_err "
                f"{e:.3g}")
            if not e < 10 * ATOL[name]:
                raise AssertionError(f"int8_matmul {name} {(M, K, N)}: {e}")

    lib_name, lib = int8_library()
    bf16 = torch.bfloat16
    rows, layer = {}, {}
    for part, (K, N) in INT8_MLP.items():
        wq, sc = quantized(K, N)
        wqt, scx = wq.t().contiguous(), sc.to(bf16)
        layer.update({p: (wq, sc) for p in
                      (("gate", "up") if part == "gate/up" else ("down",))})
        for M in INT8_M:
            x = torch.randn((M, K), generator=g, device=DEV).to(bf16)
            out = k6.int8_matmul(x, wq, sc)
            e = err(out, k6.int8_matmul_torch(x, wq, sc))
            if not e < 10 * ATOL["bfloat16"]:
                raise AssertionError(f"int8_matmul {part} M={M}: {e}")
            r = timed_row(
                f"x ({M},{K}) bf16 @ w_q ({K},{N}) int8 * scale ({N},) f32",
                e, functools.partial(k6.int8_matmul, x, wq, sc),
                functools.partial(k6.int8_matmul_torch, x, wq, sc),
                functools.partial(lib, x, wq, wqt, sc, scx),
                nbytes(x, wq, sc, out), 2 * M * N * K, PEAK_BF16_FLOPS,
                plain_reps=5)
            r["library"] = lib_name
            rows[f"qwen3-32b {part} M={M}"] = r
            log(f"  int8_matmul qwen3-32b {part} M={M} [{r['shape']}]: "
                f"device ms kernel {r['ms']:.5f}, plain "
                f"{r['plain_ms']:.5f}, library ({lib_name}) "
                f"{r['library_ms']:.5f}, bound {r['bound_ms']:.5f} "
                f"({r['bound_by']}, bf16 tensor core peak); eager call "
                f"{r['eager_ms']:.5f} ms; max_abs_err {e:.3g}")

    # the standalone path: an int8 SwiGLU at decode and prefill, counted
    xs = {M: torch.randn((M, INT8_MLP["gate/up"][0]), generator=g,
                         device=DEV).to(bf16) for M in INT8_M}
    k6.LAUNCHES = 0
    outs = {M: int8_swiglu(k6, x, layer) for M, x in xs.items()}
    torch.cuda.synchronize()
    launches = k6.LAUNCHES
    for M, x in xs.items():
        ref = k6.int8_matmul_torch(x, *layer["gate"])
        h = F.silu(ref.float()).to(bf16) * k6.int8_matmul_torch(
            x, *layer["up"])
        ref = k6.int8_matmul_torch(h, *layer["down"])
        e = err(outs[M], ref)
        rel = e / float(ref.float().abs().max())
        log(f"  int8 SwiGLU (qwen3-32b MLP, M={M}): max_abs_err {e:.3g} "
            f"against the plain products ({rel:.3g} of the largest output)")
        if not rel < 2e-2:
            raise AssertionError(f"int8 SwiGLU M={M}: {e} ({rel})")
    if launches != 3 * len(INT8_M):
        raise AssertionError(f"int8 SwiGLU launched K6 {launches} times")
    log(f"  K6 launches on the standalone int8 SwiGLU: {launches}")
    return rows, launches


# ---------------------------------------------------------------------------
# Phase 3: fp32 model parity, card (kernels) vs CPU (plain path)
# ---------------------------------------------------------------------------

def parity(arch, num_layers, prompt_len, max_len):
    """Prefill ``prompt_len`` tokens and decode three, on the card and on
    the CPU from the same fp32 params; returns the worst logits error."""
    from repro_torch import bridge, configs
    from repro_torch.device import generator_for
    from repro_torch.models import model as MDL

    cfg = configs.get_config(arch).replace(
        num_layers=num_layers, param_dtype="float32",
        activation_dtype="float32")
    cuda, cpu = DEV, torch.device("cpu")
    params = MDL.init_params(generator_for(cuda, SEED), cfg, device=cuda)
    params_cpu = bridge.params_from_jax(bridge.params_to_numpy(params), cpu)
    toks = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, prompt_len)).astype(np.int32)
    cache_g = MDL.init_cache(cfg, 2, max_len, device=cuda)
    cache_c = MDL.init_cache(cfg, 2, max_len, device=cpu)
    worst = 0.0
    with torch.inference_mode():
        lg, _ = MDL.prefill(params, cfg, torch.from_numpy(toks).to(cuda),
                            cache_g)
        lc, _ = MDL.prefill(params_cpu, cfg, torch.from_numpy(toks), cache_c)
        for step in range(4):
            e = float((lg.cpu() - lc).abs().max())
            worst = max(worst, e)
            tg, tc = lg.argmax(-1).cpu(), lc.argmax(-1)
            log(f"  {arch} {'prefill' if step == 0 else f'decode {step}'}: "
                f"logits max_abs_err {e:.3g}, greedy card {tg.tolist()} "
                f"cpu {tc.tolist()}")
            if not e < LOGIT_ATOL or not torch.equal(tg, tc):
                raise AssertionError(f"{arch}: card and CPU disagree")
            if step == 3:
                break
            lg, _ = MDL.decode_step(params, cfg, tg.to(cuda), cache_g)
            lc, _ = MDL.decode_step(params_cpu, cfg, tc, cache_c)
    torch.cuda.synchronize()
    del params, params_cpu, cache_g, cache_c
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def phase_parity():
    out = {"qwen2.5-3b": parity("qwen2.5-3b", 2, 16, 32)}
    # 5 layers = one (rglru, rglru, local) cycle + the (rglru, rglru) tail;
    # 2100 > window 2048: banded on the CPU, windowed in K1, and the ring
    # of 2048 slots wraps in the prefill and again in the decode steps
    out["recurrentgemma-2b"] = parity("recurrentgemma-2b", 5, 2100, 2200)
    out["rwkv6-3b"] = parity("rwkv6-3b", 2, 250, 256)
    out["qwen3-32b"] = parity("qwen3-32b", 2, 16, 32)
    # 2 x 16 tokens over 128 experts top-8: capacity 8 slots an expert
    out["qwen3-moe-30b-a3b"] = parity("qwen3-moe-30b-a3b", 2, 16, 32)
    return out


# ---------------------------------------------------------------------------
# Phase 4: serve on the full model, kill it, fail over to the warm w050
# ---------------------------------------------------------------------------


def serve(server, variant, prompts, timeout=600.0, tag=""):
    """Submit every prompt to ``server`` and wait for all of them."""
    from repro_torch.serving.engine import Request

    reqs = []
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        r = Request(id=f"{server.id}{tag}-{i}", prompt=p,
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


def fresh_engine_tokens(eng, prompt):
    """The tokens a new engine on the same params gives ``prompt``."""
    from repro_torch.serving.engine import InferenceEngine, Request

    fresh = InferenceEngine(eng.cfg, eng.params, batch_slots=eng.batch_slots,
                            max_len=eng.max_len, device=eng.device)
    r = Request(id="fresh", prompt=prompt, max_new_tokens=NEW_TOKENS)
    if not fresh.try_admit(r):
        raise AssertionError("a fresh engine refused a request")
    while fresh.active_count():
        fresh.step()
    return r.tokens


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


def device_profile(MDL, eng, prompt_len=256, n=5):
    """Device time by kernel name (torch.profiler) over ``n`` decode steps
    of all slots and ``n`` prefills of ``prompt_len`` tokens, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, dev = eng.cfg, eng.device
    out = {}
    with torch.inference_mode():
        cache = MDL.init_cache(cfg, SLOTS, MAX_LEN, device=dev)
        cache["pos"].copy_(torch.tensor([97, 161, 288, 400]))
        tok = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)
        prompt = torch.zeros((1, prompt_len), dtype=torch.int32, device=dev)
        calls = {"decode_step": lambda: MDL.decode_step(eng.params, cfg, tok,
                                                        cache),
                 f"prefill_{prompt_len}": lambda: MDL.prefill(
                     eng.params, cfg, prompt,
                     MDL.cache_zero(MDL.cache_take_slot(cache, 0)))}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            kern = [(e.key, e.self_device_time_total / 1e3 / n)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0]
            kern.sort(key=lambda kv: -kv[1])
            total = sum(t for _, t in kern)
            ours = sum(t for k, t in kern if any(
                tag in k for tag in PORT_KERNEL_NAMES))
            out[name] = {"device_ms": total, "port_kernels_ms": ours,
                         "n_kernel_names": len(kern),
                         "top": [(k[:60], t) for k, t in kern[:6]]}
    return out


def expected_launches(cfg, n_prefills, n_steps):
    """One launch per layer of each kind per prefill and per decode step."""
    from repro_torch.models.model import ATTN_KINDS

    kinds = cfg.layer_kinds()
    attn = sum(k in ATTN_KINDS for k in kinds)
    rec = {"rglru_scan": kinds.count("rglru"),
           "rwkv6_scan": kinds.count("rwkv")}
    out = {"flash_attention": attn * n_prefills,
           "decode_attention": attn * n_steps}
    out.update({k: n * (n_prefills + n_steps) for k, n in rec.items()})
    return out


def phase_serve(arch):
    from repro_torch import configs
    from repro_torch.core.heartbeat import FailureDetector, WallClock
    from repro_torch.core.variants import Application, build_ladder
    from repro_torch.models import model as MDL
    from repro_torch.serving.router import Router
    from repro_torch.serving.server import WorkerServer

    cfg = configs.get_config(arch)
    if arch in SERVE_LAYERS:
        cfg = cfg.replace(num_layers=SERVE_LAYERS[arch])
    ops = ops_modules()
    app = Application(id=f"{arch}/app0", family=cfg.name,
                      variants=build_ladder(cfg))
    full, w050 = app.full, app.variant_by_name(f"{cfg.name}:w050")
    det = FailureDetector(WallClock(), interval=0.020)
    router = Router()
    workers = {sid: WorkerServer(sid, det, batch_slots=SLOTS,
                                 max_len=MAX_LEN, device=DEV).start()
               for sid in ("A", "B")}
    res = {}
    launches = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        res["load_s_A_full"] = workers["A"].load(app, full)
        res["load_s_B_w050"] = workers["B"].load(app, w050)
        log(f"  load: A {full.name} {res['load_s_A_full']:.3f} s, "
            f"B {w050.name} {res['load_s_B_w050']:.3f} s")
        eng_a = workers["A"].engines[full.name]
        eng_b = workers["B"].engines[w050.name]
        fc = full.config
        log(f"  {full.name}: {MDL.param_count(eng_a.params)} params, "
            f"{fc.num_layers} layers {fc.block_pattern}, d_model "
            f"{fc.d_model}, vocab {fc.vocab_size}")
        widths = ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                  "vocab_size", "rnn_width", "rwkv_head_size", "window_size")
        if any(getattr(fc, f) != getattr(cfg, f) for f in widths) \
                or fc.param_dtype != "bfloat16":
            raise AssertionError(f"{full.name} is not {arch} at its "
                                 "published widths in bf16")
        router.set_route(app.id, "A", full.name)
        router.set_backup(app.id, "B", w050.name)

        rng = np.random.default_rng(SEED)
        lens = rng.integers(64, 257, SLOTS)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]

        def run(tag, eng, batch):
            sid, variant = router.lookup(app.id)
            steps0 = eng.steps
            for m in ops.values():
                m.LAUNCHES = 0
            reqs, t0 = serve(workers[sid], variant, batch, tag=tag)
            got = {k: m.LAUNCHES for k, m in ops.items()}
            steps = eng.steps - steps0
            want = expected_launches(eng.cfg, len(reqs), steps)
            log(f"  {tag}: served {len(reqs)} requests on {sid} {variant}; "
                f"decode steps {steps}; launches {json.dumps(got)}")
            if got != want or steps < NEW_TOKENS:
                raise AssertionError(f"{tag}: launches {got} do not match "
                                     f"the path {want} (one per layer of "
                                     "each kind per prefill / decode step)")
            if not any(got.values()):
                raise AssertionError(f"{tag}: no kernel launched")
            launches[tag] = got
            wall = max(r.done_at for r in reqs) - t0
            res[f"tokens_per_s_{tag}"] = sum(len(r.tokens)
                                             for r in reqs) / wall
            return reqs

        reqs_a = run("A", eng_a, prompts)
        mirror = mirror_tokens(MDL, eng_a, prompts[0])
        if reqs_a[0].tokens != mirror:
            raise AssertionError(f"engine tokens {reqs_a[0].tokens} != "
                                 f"model prefill+decode {mirror}")
        log(f"  A's engine tokens for request 0 equal the model's own "
            f"prefill + decode_step ({len(mirror)} tokens)")
        fifth = rng.integers(0, cfg.vocab_size, 200).astype(np.int32)
        reused = run("A-reuse", eng_a, [fifth])[0].tokens
        fresh = fresh_engine_tokens(eng_a, fifth)
        if reused != fresh:
            raise AssertionError(f"a reused slot gives {reused}, a fresh "
                                 f"engine {fresh}")
        log(f"  slot reuse: a fifth request on a reused slot equals a fresh "
            f"engine's tokens ({len(fresh)} tokens)")
        res["A_steps"] = step_breakdown(MDL, eng_a)
        log(f"  A {full.name} step breakdown: {json.dumps(res['A_steps'])}")
        res["A_profile"] = device_profile(MDL, eng_a)
        for call, p in res["A_profile"].items():
            log(f"  A {full.name} {call} by kernel (torch.profiler, ms per "
                f"call): total {p['device_ms']:.3f}, the port's kernels "
                f"{p['port_kernels_ms']:.3f}, {p['n_kernel_names']} kernel "
                f"names; top {json.dumps(p['top'])}")

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
        reqs_b = run("B", eng_b, prompts)
        res["failover_ttft_s"] = min(r.first_token_at for r in reqs_b) \
            - t_kill
        res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        log(f"  detection latency {res['detect_s'] * 1e3:.2f} ms; kill to "
            f"B's first token {res['failover_ttft_s'] * 1e3:.2f} ms; "
            f"tokens/s A {res['tokens_per_s_A']:.1f}, B "
            f"{res['tokens_per_s_B']:.1f}; max_memory_allocated "
            f"{res['max_memory_allocated_bytes'] / 2**30:.3f} GiB")
        mirror = mirror_tokens(MDL, eng_b, prompts[0])
        if reqs_b[0].tokens != mirror:
            raise AssertionError(f"B's engine tokens {reqs_b[0].tokens} != "
                                 f"model prefill+decode {mirror}")
        log(f"  B's engine tokens for request 0 equal the model's own "
            f"prefill + decode_step on {w050.name} ({len(mirror)} tokens)")
    finally:
        for w in workers.values():
            w.kill()
            w.join()
            w.engines.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return res, launches


# ---------------------------------------------------------------------------
# Phase 5: the simulator's failover planning on the card (K5)
# ---------------------------------------------------------------------------

def phase_argmax():
    """K5 against its plain version, exactly, at every size, dtype and mask
    kind, one row and (ARGMAX_ROWS, S) rows over one shared column; the
    dense rows timed beside the plain version and the bound."""
    from repro_torch.kernels.planner_argmax import ops as k5

    g = torch.Generator(device=DEV).manual_seed(SEED)
    rows = {}

    def rand(*shape):
        return torch.rand(shape, generator=g, device=DEV)

    n_checked = 0
    for S in ARGMAX_SIZES:
        for dt in (torch.float32, torch.float64):
            x = torch.randn(S, generator=g, device=DEV).to(dt)
            for kind in ("empty", "sparse", "dense", "all-tied"):
                v = torch.full_like(x, 0.5) if kind == "all-tied" else x
                for n in (0, ARGMAX_ROWS):
                    shape = (n, S) if n else (S,)
                    mask = {"empty": torch.zeros(shape, dtype=torch.bool,
                                                 device=DEV),
                            "sparse": rand(*shape) < 0.01,
                            "dense": rand(*shape) < 0.7,
                            "all-tied": torch.ones(shape, dtype=torch.bool,
                                                   device=DEV)}[kind]
                    vals = v.expand(n, S) if n else v
                    i, val = k5.masked_argmax(vals, mask)
                    pi, pv = k5.masked_argmax_torch(vals, mask)
                    if not (torch.equal(i, pi) and torch.equal(val, pv)):
                        raise AssertionError(
                            f"planner_argmax {shape} {dt} {kind}: "
                            f"{i.tolist()} {val.tolist()} vs plain "
                            f"{pi.tolist()} {pv.tolist()}")
                    n_checked += 1
                    if kind != "dense":
                        continue
                    name = str(dt).replace("torch.", "")
                    tag = f"({n},{S}) {name} dense" if n else \
                        f"({S},) {name} dense"
                    # each input byte read once (the shared column once),
                    # each output written once; one comparison per mask
                    # entry, no arithmetic
                    n_bytes = (v.numel() * v.element_size() + mask.numel()
                               + max(n, 1) * (4 + v.element_size()))
                    rows[tag] = timed_row(
                        f"values {tag.split(' ')[0]}"
                        + (" (one shared column, row stride 0)" if n
                           else "") + f" {name}, mask bool 70% set", 0.0,
                        functools.partial(k5.masked_argmax, vals, mask),
                        functools.partial(k5.masked_argmax_torch, vals,
                                          mask), None, n_bytes,
                        mask.numel(), PEAK_FP32_FLOPS)
                    # a yardstick only: where + argmax is not the same
                    # function (an empty mask gives index 0, not -1)
                    rows[tag]["where_argmax_ms"] = graph_ms(
                        lambda: torch.where(mask, vals, float("-inf"))
                        .argmax(-1))
    torch.cuda.synchronize()
    log(f"  K5 equal to its plain version (index and value) on "
        f"{n_checked} cases: S in {ARGMAX_SIZES} x float32/float64 x "
        f"empty/sparse/dense/all-tied x (S,) and ({ARGMAX_ROWS}, S)")
    for tag, r in rows.items():
        log(f"  planner_argmax {tag} [{r['shape']}]: device ms kernel "
            f"{r['ms']:.5f}, plain {r['plain_ms']:.5f}, library none "
            f"(torch.where + torch.argmax {r['where_argmax_ms']:.5f}), "
            f"bound {r['bound_ms']:.6f} ({r['bound_by']}); eager call "
            f"{r['eager_ms']:.5f} ms")
    return rows


def planner_instance(rng, tc, tv):
    """A random planning round on 100 servers in 4 sites: 20-300 apps of
    2-6 variants, pre-placed primaries, a few dead servers, server and
    site exclusions, an alpha."""
    cluster = tc.make_cluster(4, 25, mem=rng.uniform(4e9, 16e9),
                              compute=rng.uniform(0.5, 2.0))
    apps = [tv.Application(
        id=f"a{i}", family=f"f{i}",
        variants=tv.synthetic_family(f"f{i}", rng.uniform(0.3e9, 6e9),
                                     n_variants=rng.randint(2, 6),
                                     spread=rng.uniform(1.5, 12.0)),
        request_rate=rng.uniform(0.2, 3.0), critical=rng.random() < 0.5)
        for i in range(rng.randint(20, 300))]
    sids = list(cluster.servers)
    for a in apps[::3]:
        sid = rng.choice(sids)
        if cluster.servers[sid].fits(a.variants[-1].demand):
            cluster.place(a.id, a.variants[-1], sid, "primary")
    for sid in rng.sample(sids, rng.randint(0, 10)):
        cluster.fail_server(sid)
    exclude = {a.id: {rng.choice(sids)} for a in apps if rng.random() < 0.7}
    site_exclude = {a.id: {f"site{rng.randrange(4)}"} for a in apps
                    if rng.random() < 0.3}
    return cluster, apps, dict(exclude=exclude, site_exclude=site_exclude,
                               alpha=rng.choice([0.0, 0.1, 0.25]))


def phase_planner():
    """plan_greedy_torch on the card against the port's numpy planner:
    assignments, their order, the unplaced list and the objective bits."""
    import random

    from repro_torch.core import cluster as tc
    from repro_torch.core import variants as tv
    from repro_torch.core.planner import PlannerState, plan_greedy
    from repro_torch.core.planner.torch_backend import (TorchPlanContext,
                                                        plan_greedy_torch)

    # one context for every instance, though each reuses the ids a0, a1,
    # ... with other ladders: its demand cache must follow the new apps
    ctx = TorchPlanContext()
    n_apps = n_placed = 0
    for dtype in ("float64", "float32"):
        for seed in range(PLANNER_INSTANCES):
            cluster, apps, kw = planner_instance(random.Random(seed), tc, tv)
            r_np = plan_greedy(apps, cluster, state=PlannerState(
                cluster, subscribe=False, dtype=dtype), **kw)
            r_t = plan_greedy_torch(apps, cluster, state=PlannerState(
                cluster, subscribe=False, dtype=dtype), ctx=ctx, **kw)
            got = ([(k, v.name, s) for k, (v, s) in r_t.assignment.items()],
                   r_t.unplaced, r_t.objective.hex())
            want = ([(k, v.name, s) for k, (v, s) in
                     r_np.assignment.items()], r_np.unplaced,
                    r_np.objective.hex())
            if got != want:
                raise AssertionError(f"plan_greedy_torch {dtype} seed "
                                     f"{seed}: differs from numpy")
            n_apps += len(apps)
            n_placed += len(r_np.assignment)
    log(f"  plan_greedy_torch on the card equals numpy on "
        f"{2 * PLANNER_INSTANCES} instances (float64 and float32, "
        f"{n_apps} apps, {n_placed} placed): assignments, order, unplaced, "
        f"objective bits")


def sim_config(backend):
    from repro_torch.core.simulation import SimConfig

    c = SIM_CELL
    return SimConfig(
        n_sites=c["n_servers"] // c["per_site"],
        servers_per_site=c["per_site"],
        server_mem=c["n_apps"] * AVG_FULL_MEM / (c["n_servers"]
                                                 * PRIMARY_UTIL),
        headroom=0.2, seed=SEED, planner="greedy", planner_dtype="float64",
        planner_backend=backend, traffic_rate_scale=c["rate_scale"],
        traffic_chunk_s=c["chunk_s"], event_mode="epoch")


def profile_round(planner, req, n=3):
    """One failover round's planning, replayed from its request before the
    round itself runs (a round is a pure function of the state it reads),
    in a run of its own whose plan walls are not reported: a first replay
    that also syncs the failed servers' rows into the device mirror, then
    the host wall of unprofiled replays ending in their host reads, and
    the device busy time of a profiled one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.planner.torch_backend import plan_greedy_torch

    exclude, site_exclude = req.exclusions()

    def replay():
        return plan_greedy_torch(req.apps, req.cluster, state=req.state,
                                 exclude=exclude, site_exclude=site_exclude,
                                 alpha=req.alpha, ctx=planner._ctx)

    replay()                                   # the row sync, once
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    kern = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    kern.sort(key=lambda kv: -kv[1])
    busy = sum(t for _, t in kern)
    n_kernels = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0)
    wall = statistics.median(walls)
    return {"n_apps": len(req.apps), "wall_ms": wall,
            "device_kernels": n_kernels,
            "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "k5_device_ms": sum(t for k, t in kern
                                if "masked_argmax" in k),
            "top": [(k[:50], t) for k, t in kern[:5]]}


def run_sim(backend, k5, profile=False):
    """One run of the cell through the simulator's entry points, each
    planning round recorded (apps, plan wall, K5 launches, failover or
    not); with ``profile`` the first failover round is also profiled
    (``profile_round``), and the run's walls then include the replays."""
    from repro_torch.core.simulation import Simulation

    t0 = time.perf_counter()
    sim = Simulation(sim_config(backend))
    ctl = sim.controller
    planner = ctl.fast_planner                # greedy: also ctl.planner
    rounds, flag = [], {"failover": False, "profile": None}
    plan, handle_failures = planner.plan, ctl.handle_failures

    def failover(*a, **kw):
        flag["failover"] = True
        try:
            return handle_failures(*a, **kw)
        finally:
            flag["failover"] = False

    def recorded_plan(req):
        if (profile and flag["failover"] and req.apps
                and flag["profile"] is None):
            flag["profile"] = profile_round(planner, req)
        n0 = k5.LAUNCHES
        res = plan(req)
        rounds.append({"n_apps": len(req.apps), "wall_s": res.wall_s,
                       "k5": k5.LAUNCHES - n0,
                       "failover": flag["failover"]})
        return res

    planner.plan = recorded_plan
    ctl.handle_failures = failover
    sim.setup()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sim.run_named_scenario(SIM_CELL["scenario"])
    run_s = time.perf_counter() - t0
    return sim, res, rounds, flag["profile"], setup_s, run_s


def sim_records(sim, res):
    ctl = sim.controller
    epochs = [sorted((r.epoch, r.app_id, r.recovered, r.mttr, r.variant,
                      r.mode, r.upgraded_to) for r in ep.values())
              for ep in ctl.epoch_records]
    placement = (dict(ctl.primaries),
                 {a: (v.name, sid) for a, (v, sid, _k) in ctl.warm.items()})
    return epochs, placement, res.fingerprint(), res.overall


def phase_sim():
    """The cell on the torch backend (K5 on the card) and on numpy, in this
    process from one seed; the records, the placement and the traffic
    summary must be equal. K5's counter is zeroed just before the torch
    run and read just after it. Both runs are unprofiled, so their plan
    walls compare like for like; a third run on the torch backend
    profiles a replay of its first failover round for the device idle
    share, and reports no wall."""
    from repro_torch.kernels.planner_argmax import ops as k5

    out = {}
    k5.LAUNCHES = 0
    runs = {"torch": run_sim("torch", k5)}
    launches = k5.LAUNCHES
    runs["numpy"] = run_sim("numpy", k5)
    prof = run_sim("torch", k5, profile=True)[3]
    if prof is None:
        raise AssertionError("the profiled torch run had no failover "
                             "round to profile")
    for backend, (sim, res, rounds, _, setup_s, run_s) in runs.items():
        fail = [r for r in rounds if r["failover"] and r["n_apps"]]
        stats = sim.controller.planner_stats()
        out[backend] = {
            "n_apps": len(sim.apps), "n_servers": len(sim.cluster.servers),
            "setup_s": setup_s, "run_s": run_s,
            "plan_wall_s": sim.controller.plan_wall_s,
            "plan_peak_s": max((r.phases.get("plan", 0.0)
                                for r in res.records), default=0.0),
            "rounds": len(rounds), "rounds_with_apps": sum(
                1 for r in rounds if r["n_apps"]),
            "setup_round": rounds[0] if rounds else None,
            "failover_rounds": fail,
            "torch_rounds": stats["torch_rounds"],
            "numpy_rounds": stats["numpy_rounds"],
            "n_records": len(res.records),
            "recovery_rate": res.overall["recovery_rate"]}
        log(f"  {backend}: {json.dumps(out[backend])}")
    if sim_records(*runs["torch"][:2]) != sim_records(*runs["numpy"][:2]):
        raise AssertionError("the cell's records differ between the torch "
                             "and numpy planner backends")
    t = out["torch"]
    if not t["torch_rounds"] or not launches:
        raise AssertionError("the torch run planned no round on the card")
    t["k5_launches"] = launches
    log(f"  records, placement and traffic summary equal between torch and "
        f"numpy ({t['n_records']} records, recovery rate "
        f"{t['recovery_rate']}); K5 launches on the torch run {launches} in "
        f"{t['torch_rounds']} rounds ({launches / t['torch_rounds']:.1f} "
        f"per round)")
    for name in ("torch", "numpy"):
        o = out[name]
        log(f"  {name}: plan_wall_s {o['plan_wall_s']:.6f}, peak failover "
            f"plan phase {o['plan_peak_s']:.6f} s, setup {o['setup_s']:.3f} "
            f"s, scenario {o['run_s']:.3f} s")
    t["profiled_failover_round"] = p = prof
    log(f"  one failover round on the card, replayed in a third run "
        f"({p['n_apps']} apps): host wall "
        f"{p['wall_ms']:.3f} ms, device busy {p['device_busy_ms']:.3f} ms, "
        f"device idle share {p['idle_share']:.4f}; {p['device_kernels']} "
        f"device kernels and copies ({p['device_kernels'] / p['n_apps']:.1f} "
        f"per app); K5 device {p['k5_device_ms']:.3f} ms; top "
        f"{json.dumps(p['top'])}")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 6: the live failover testbed through the entry points, on the card
# ---------------------------------------------------------------------------

def phase_testbed_smoke():
    """tests/test_experiment.py:185's spec with the default arch list on
    the port's testbed backend, then on its sim backend. Every kernel
    counter is zeroed just before the testbed run and read just after."""
    from repro_torch.experiment import ExperimentSpec, run_experiment

    ops = all_ops()
    spec = ExperimentSpec(backend="testbed", **TESTBED_SPEC)
    for m in ops.values():
        m.LAUNCHES = 0
    t0 = time.monotonic()
    tb = run_experiment(spec)
    launches = {k: m.LAUNCHES for k, m in ops.items()}
    tb_wall = time.monotonic() - t0
    sim = run_experiment(spec.with_(backend="sim"))
    t = tb.traffic
    stats = tb.extras["client_stats"]
    out = {"recovery_by_app": {a: list(v) for a, v in
                               tb.recovery_by_app().items()},
           "recovery_rate": tb.overall["recovery_rate"],
           "detect_latency_s": tb.detect_latency_s,
           "client_mttr_avg_s": t.client_mttr_avg,
           "availability": t.availability, "n_offered": t.n_offered,
           "clients_ok": {a: st.ok for a, st in stats.items()},
           "load_calibration": tb.extras["load_calibration"],
           "plan_wall_s": tb.plan_wall_s, "planner": tb.extras["planner"],
           "load_errors": tb.extras["load_errors"],
           "refused_no_slot": tb.extras["refused_no_slot"], "wall_s": tb_wall,
           "launches": launches}
    log("  " + json.dumps({"testbed_smoke": out}, default=str))
    if tb.recovery_by_app() != sim.recovery_by_app():
        raise AssertionError(f"testbed {tb.recovery_by_app()} != sim "
                             f"{sim.recovery_by_app()}")
    if tb.extras["load_errors"]:
        raise AssertionError(f"testbed errors: {tb.extras['load_errors']}")
    if tb.overall["recovery_rate"] != 1.0:
        raise AssertionError(f"recovery rate {tb.overall['recovery_rate']}")
    if not 0.0 < tb.detect_latency_s < 1.0:
        raise AssertionError(f"detection {tb.detect_latency_s} s")
    if not (np.isfinite(t.client_mttr_avg) and t.client_mttr_avg > 0):
        raise AssertionError(f"client MTTR {t.client_mttr_avg}")
    if not all(st.ok > 0 for st in stats.values()):
        raise AssertionError(f"an app's clients got no answer: {stats}")
    idle = [k for k in KERNELS if k != "int8_matmul" and not launches[k]]
    if idle:
        raise AssertionError(f"{idle} never launched in the testbed run")
    log(f"  testbed == sim failover choices {tb.recovery_by_app()}; "
        f"recovery rate 1.0, detection {tb.detect_latency_s * 1e3:.2f} ms, "
        f"client MTTR {t.client_mttr_avg * 1e3:.2f} ms, availability "
        f"{t.availability:.6f} of {t.n_offered} requests "
        f"({tb.extras['refused_no_slot']} refused for want of a free batch "
        f"slot), no load error; "
        f"testbed run {tb_wall:.1f} s; launches {json.dumps(launches)}")
    return out, launches


def phase_testbed_full():
    """Two critical apps at full width, qwen3-32b's primary killed."""
    import random

    from repro_torch import configs
    from repro_torch.core.variants import Application, build_ladder
    from repro_torch.experiment import primary_kill_scenario
    from repro_torch.serving.testbed import MiniTestbed

    apps = []
    for i, (arch, layers) in enumerate(FULL_TESTBED_LAYERS.items()):
        cfg = configs.get_config(arch)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        apps.append(Application(id=f"{arch}-app{i}", family=arch,
                                variants=build_ladder(cfg), critical=True))
    victim = apps[-1].id
    ops = all_ops()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for m in ops.values():
        m.LAUNCHES = 0
    tb = MiniTestbed(apps=apps, n_sites=3, servers_per_site=2,
                     headroom=0.35, seed=SEED + 1)
    loads = []                     # (server, variant, wall s) of each load

    def timed(w, load):
        def run(app, variant, *a, **kw):
            wall = load(app, variant, *a, **kw)
            loads.append((w.id, variant.name, wall))
            return wall
        return run

    for w in tb.workers.values():
        w.load = timed(w, w.load)
    try:
        t0 = time.monotonic()
        tb.deploy()
        deploy_s = time.monotonic() - t0
        placed = {a: (v.name, sid) for a, (v, sid, _k) in
                  tb.controller.warm.items()}
        log(f"  deployed in {deploy_s:.1f} s: primaries "
            f"{json.dumps(dict(tb.controller.primaries))}, warm {placed}")
        scenario = primary_kill_scenario(victim, t_fail=2.0, horizon=5.0)(
            tb.cluster, tb.apps, random.Random(SEED))
        out = tb.run_scenario(scenario, time_scale=1.0, settle_s=120.0,
                              client_hz=10.0)
        t_kill = min(tb._kill_times.values())
    finally:
        tb.shutdown()
    launches = {k: m.LAUNCHES for k, m in ops.items()}
    peak = torch.cuda.max_memory_allocated()
    recs = [r for r in out["records"] if r.app_id == victim]
    st = out["client_stats"][victim]
    res = {"victim": victim,
           "recovered": [(r.recovered, r.mode, r.variant, r.upgraded_to)
                         for r in recs],
           "phases_s": [r.phases for r in recs],
           "detect_latency_s": out["detect_latency_s"],
           "client_downtime_s": st.downtime, "client_ok": st.ok,
           "client_failed": st.failed,
           "load_calibration": out["load_calibration"], "loads_s": loads,
           "plan_wall_s": tb.controller.plan_wall_s,
           "max_memory_allocated_bytes": peak, "deploy_s": deploy_s,
           "load_errors": out["load_errors"],
           "refused_no_slot": out["refused_no_slot"],
           "availability": out["traffic"].availability,
           "n_offered": out["traffic"].n_offered, "launches": launches}
    log("  " + json.dumps({"testbed_full_width": res}, default=str))
    if out["load_errors"]:
        raise AssertionError(f"testbed errors: {out['load_errors']}")
    if not recs or not all(r.recovered for r in recs):
        raise AssertionError(f"{victim} did not recover: {recs}")
    if st.last_ok is None or st.last_ok <= t_kill:
        raise AssertionError(f"{victim}'s clients were not served after "
                             "the kill")
    if not (launches["flash_attention"] and launches["decode_attention"]):
        raise AssertionError(f"attention kernels not launched: {launches}")
    r = recs[-1]
    log(f"  {victim} recovered ({r.mode}) on {r.upgraded_to or r.variant}; "
        f"detection {out['detect_latency_s'] * 1e3:.2f} ms, client "
        f"downtime {st.downtime * 1e3:.2f} ms, loads (server, variant, s) "
        f"{json.dumps(loads)}, load calibration "
        f"{json.dumps(out['load_calibration'])}, plan wall "
        f"{tb.controller.plan_wall_s * 1e3:.2f} ms, max_memory_allocated "
        f"{peak / 2**30:.3f} GiB")
    return res, launches


def sass_counts(name, opcode):
    """Per kernel function of the built ``name`` library, the number of
    SASS instructions of ``opcode`` (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.target(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(rf"\b{opcode}\b", ln):
            counts[fn] += 1
    return counts


def phase_build():
    """Build every kernel (one nvcc each, all at once), print each
    kernel's ptxas registers and spills, fail on any spill in K1/K2, and
    print the HMMA count of each of K1's bf16 (tensor-core)
    instantiations, failing if one has none."""
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    secs = _build.build(list(KERNELS))
    log(f"  built {sorted(secs)} in {time.monotonic() - t0:.2f} s "
        f"(per kernel {json.dumps({k: round(v, 2) for k, v in secs.items()})})")
    for name in KERNELS:
        lines = (_build.BUILD_DIR / f"{name}.log").read_text().splitlines()
        regs = [ln.split(":", 1)[1].strip() for ln in lines
                if "registers" in ln]
        spills = sorted({ln.strip() for ln in lines if "spill" in ln})
        log(f"  ptxas {name}: {'; '.join(regs)} | {'; '.join(spills)}")
        if name in ("flash_attention", "decode_attention"):
            spilled = [ln for ln in lines if re.search(
                r"[1-9]\d* bytes spill (stores|loads)", ln)]
            if spilled:
                raise AssertionError(f"ptxas spills in {name}: {spilled}")
    hmma = {f"hd {m.group(1)}": n
            for fn, n in sass_counts("flash_attention", "HMMA").items()
            for m in [re.search(r"fa_tc_kernelILi(\d+)E", fn)] if m}
    log(f"  HMMA instructions in K1's bf16 instantiations: "
        f"{json.dumps(hmma)}")
    if len(hmma) != 5 or not all(hmma.values()):
        raise AssertionError(f"K1's bf16 kernels lack tensor-core mma: "
                             f"{hmma}")


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
    phase_build()

    log("phase 2: kernels against their plain versions")
    t0 = time.monotonic()
    rows = phase_kernels()
    rows["int8_matmul"], k6_launches = phase_int8()
    log(f"  phase 2 took {time.monotonic() - t0:.1f} s")

    log("phase 3: fp32 model parity at full width, card vs CPU")
    t0 = time.monotonic()
    worst = phase_parity()
    log(f"  worst logits max_abs_err {json.dumps(worst)} (< {LOGIT_ATOL}); "
        f"phase 3 took {time.monotonic() - t0:.1f} s")

    serves, launches = {}, {}
    for arch in ARCHS:
        log(f"phase 4: serve {arch}:full, kill it, fail over to w050")
        t0 = time.monotonic()
        serves[arch], launches[arch] = phase_serve(arch)
        log("  " + json.dumps({"serve": {arch: serves[arch]}}))
        st = serves[arch]["A_steps"]
        for name in ("decode_step", "prefill_256"):
            wall, devt = st[f"{name}_wall_ms"], st[f"{name}_device_ms"]
            log(f"  {name} on {arch}:full: host wall {wall:.3f} ms, device "
                f"{devt:.3f} ms, device idle share {1 - devt / wall:.3f}")
        log(f"  phase 4 {arch} took {time.monotonic() - t0:.1f} s")

    log("phase 5: the simulator's failover planning on the card (K5)")
    t0 = time.monotonic()
    rows["planner_argmax"] = phase_argmax()
    phase_planner()
    _, k5_launches = phase_sim()
    log(f"  phase 5 took {time.monotonic() - t0:.1f} s")

    log("phase 6: the live failover testbed on the card")
    t0 = time.monotonic()
    _, tb_smoke = phase_testbed_smoke()
    log(f"  phase 6 (a) took {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    _, tb_full = phase_testbed_full()
    log(f"  phase 6 (b) took {time.monotonic() - t0:.1f} s")

    kernels = []
    for name, (src, replaces, headline) in KERNELS.items():
        r = rows[name][headline]
        if name == "int8_matmul":
            by_path = {INT8_PATH: k6_launches}
        else:
            by_path = {f"{arch}:{tag}": n[name]
                       for arch, runs in launches.items()
                       for tag, n in runs.items() if n.get(name)}
            if name == "planner_argmax":
                by_path[f"sim {SIM_CELL['scenario']} torch"] = k5_launches
            by_path["testbed smoke (phase 6a)"] = tb_smoke[name]
            by_path["testbed full width (phase 6b)"] = tb_full[name]
        main_path = sum(by_path.values())
        if not main_path:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main_path,
            "max_abs_err": max(x["max_abs_err"] for x in rows[name].values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "peak": r["peak"],
            "library": (NO_LIBRARY[name] if r["library_ms"] is None
                        else r.get("library",
                                   "scaled_dot_product_attention")),
            "launches_by_path": by_path,
            "rows": {tag: {k: x[k] for k in ("shape", "ms", "plain_ms",
                                             "library_ms", "bound_ms",
                                             "bound_by", "max_abs_err")}
                     for tag, x in rows[name].items()}})
    log(f"  total {time.monotonic() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
