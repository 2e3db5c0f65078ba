#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; no arguments

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

0. device: the card's name and power limit, TF32 off;
1. build: the six CUDA kernels and the backward kernels of K1, K3's
   gated route and K4 from ``src/repro_torch/kernels/*/csrc``, one
   ``nvcc`` each, all at once; no ptxas spill in K1, K3 or K4's backward
   kernels, K1 (forward), K2, K3, K4's chunked kernels, K5's round kernel
   or K6's tensor-core kernels, and HMMA
   instructions in every bf16 instantiation of K1, every dK/dV and dQ
   instantiation of K1's backward (bf16, and f32 as 3xTF32), K4's
   chunked kernels, K4's backward kernels (G and the per-chunk
   gradients, 3xTF32) and K6;
2. kernels: each against its plain PyTorch version on the card —
   K1 (prefill flash attention) and K2 (decode attention) on the sweeps of
   tests/test_kernels.py (f32 2e-5, bf16 2e-2), K3 (RG-LRU scan, f32 1e-5)
   and K4 (WKV-6, f32 5e-4, bf16 2e-2) on the sweeps of
   tests/test_kernels.py (K1's with non-causal rows where Sq != Skv:
   whisper's cross attention at Sq = 1 and 64 against 1500 frames, and a
   ragged 33 x 77; K2's with a group of 7, arctic-480b's), and each at the
   shapes of every ladder rung that phases 4 and 6 serve (heads, KV heads,
   head_dim and window of each attention rung, one prompt where the
   window of recurrentgemma-2b and of gemma3-27b binds; the
   LRU width and the WKV heads of each recurrent rung; from a nonzero
   state), the testbed's smoke rungs (head_dim 16) in f32. K4 has two
   routes, the chunked tensor-core kernels of a prefill (S > 1) and the
   recurrence of a decode step, each checked on the sweep, every rung,
   prompts that are no multiple of the 32-step chunk or shorter than it,
   lw spread to -3 and down to -20 (below the TPU kernel's clamp), the
   final state written over s0. K3 has two routes too: the (a, b) scan
   (the TPU kernel's contract) and the gated route the model calls (the
   gates' elementwise tail fused in, f32 and bf16 gate inputs, within
   1e-5 of the largest |h|), each on the sweep, every rung, prompts that
   are no multiple of a chunk, a 2100-token prompt, S = 1 and a ragged
   width; the gated route is timed beside its "before", the unfused
   ``_gates`` tail + the (a, b) route, whose launches are counted on that
   standalone path. The main-path shapes are timed in bf16
   (the smoke rungs in f32) beside the plain version, the bound, and, for
   K1/K2, PyTorch's ``scaled_dot_product_attention`` (a yardstick the
   port never calls); K4's prefill rows also with a cold L2. The :full
   and :w050 rungs of qwen1.5-4b (G = 1), gemma3-27b (window 1024),
   llava-next-mistral-7b (576 patches + 64 tokens) and arctic-480b
   (G = 7), and whisper-medium's encoder (1500 frames, non-causal), its
   decoder's causal prefill and its cross attention at a prefill and a
   decode step (K1) and its self attention at a decode step (K2).
   K6 (the weight-only int8 matmul, which no model calls, as in the JAX
   package) on the sweep of tests/test_kernels.py:102-104 in f32 and bf16,
   on its split-K and one-range tensor-core routes at reduced widths
   (an unaligned int8 row, an f32 output, two launches bit-equal) and at
   qwen3-32b's MLP shapes in bf16, within 10x the K1 tolerances,
   timed beside its plain version, the bound and
   ``torch._weight_int8pack_mm`` (a yardstick); its launches are counted
   on a standalone int8 SwiGLU over qwen3-32b's quantized MLP weights;
3. model parity, fp32, card (kernels) against CPU (plain path): qwen2.5-3b
   (2 layers), recurrentgemma-2b (one (rglru, rglru, local) cycle plus an
   (rglru, rglru) tail, a 2100-token prompt so the local layer's window
   binds and its ring buffer wraps), rwkv6-3b (2 layers, 250 tokens),
   qwen3-32b (2 layers, qk_norm), qwen3-moe-30b-a3b (2 layers, 128
   experts top-8), qwen1.5-4b (2 layers, MHA), gemma3-27b (one 6-layer
   cycle, an 1100-token prompt so the window of 1024 binds and its ring
   wraps), llava-next-mistral-7b (2 layers, 576 seeded patch embeddings
   + 64 tokens), whisper-medium (4 + 4 layers, 1500 seeded frames, a
   64-token prompt) and arctic-480b (1 layer of 128 experts: its fp32
   layer does not fit the card twice or the host beside it, so its
   reference is the model's plain attention path on the card on the same
   params), all at full width, prefill and three decode steps
   (recurrentgemma-2b's through K3's gated route only);
4. serve and fail over, for each of qwen2.5-3b, recurrentgemma-2b,
   rwkv6-3b, qwen3-32b (32 of its 64 layers: two full-width copies do
   not fit 80 GB at full depth), qwen1.5-4b, gemma3-27b (the ladder's 60
   layers), llava-next-mistral-7b (text prompts, as the engine serves
   it) and arctic-480b (2 of its 35 layers) in turn: worker A serves the
   ladder's
   ``:full`` rung (bf16) to
   4 requests, its tokens are held against the model's own prefill/decode,
   a fifth request on a reused slot against a fresh engine, A is killed,
   the heartbeat detector reports it, the router moves the app to worker
   B's warm ``:w050`` and B serves the same requests, its tokens held
   against the model's own prefill/decode on B's params. Kernel launch
   counters are zeroed before and read after each serving run and must
   show one launch per layer of each kind per prefill and per decode step
   (K3 on its gated route only). Each arch's ``:full`` decode step and
   256-token prefill are timed (host wall, CUDA-graph device time) and
   profiled (device ms by kernel, device kernels a call); for
   recurrentgemma-2b also with its RG-LRU scan unfused (the ``_gates``
   tail in PyTorch, then K3's (a, b) route), as it ran before the gated
   route. Each arch is unloaded before the next one loads;
   (w) whisper-medium at full width and depth (24 + 24 layers, bf16),
   which the engine does not serve (its requests need frame embeddings),
   through the model's entry points: a 1500-frame encode + 64-token
   prefill into each of 4 slots and decode steps over them, K1 and K2
   launches counted and held to the path, the cross K/V the prefill
   cached equal to ``_cross_kv`` recomputed, the prefill and the 4-slot
   decode step timed (host wall, CUDA-graph device time, device kernels
   a call);
5. the simulator's failover planning (the greedy planner's ``torch``
   backend, which plans each round in one launch of K5's round kernel,
   the masked argmax inline): the standalone masked argmax (the TPU
   kernel's contract) exactly equal to its plain version (index and
   value) for S in
   ``ARGMAX_SIZES`` x float32/float64 x empty/sparse/dense/all-tied masks,
   one row and (8, S) rows over one shared column, the dense ones timed
   beside the plain version, the bound and ``torch.where`` +
   ``torch.argmax`` (a yardstick, printed only); on 20 random instances
   per state dtype, the round kernel bit-equal to its plain version
   (``place_chunk`` + ``upgrade_chunk``, on the CPU): placements,
   upgrades and the free/head/budget tensors after the round, and
   ``plan_greedy_torch`` on the card equal to the port's numpy planner
   (assignments, their order, the unplaced list, the objective bits); and
   tools/bench_scale.py's 1000-server x 10,000-app cell
   through ``Simulation(SimConfig(planner="greedy",
   planner_backend=...)).setup().run_named_scenario("site-outage")`` on
   the torch backend and on numpy in this process from one seed, their
   recovery records, placements and traffic summaries equal. It prints
   each backend's plan wall, peak failover plan phase, rounds and round
   kernel launches per round (one, and no standalone argmax), all from
   these two unprofiled runs, and the device idle share and device
   kernels of one failover round from a third, profiled torch run that
   replays the round before planning it; that round is then timed on the
   round kernel and on its plain version on the card (which launches the
   standalone argmax once per app: its counted path), the two bit-equal.
   The counters are zeroed just before the first torch run and read
   after it;
6. the live failover testbed through the port's entry points, on the
   card: (a) ``run_experiment(ExperimentSpec(backend="testbed", ...))``
   on tests/test_experiment.py:185's spec with the default arch list
   (all five testbed archs on their smoke ladders, 3 sites x 2 servers),
   then the same spec on the ``sim`` backend: equal failover choices
   (``recovery_by_app()``), recovery rate 1, detection under 1 s, a
   finite client MTTR, no error other than a dead server, and every
   kernel of the path (K1, K2, K3's gated route, both K4 routes, the K5
   round kernel)
   launched during the testbed run (counters zeroed just before it, read
   just after); (b) a ``MiniTestbed`` of two critical apps at full width
   (qwen2.5-3b's published config, qwen3-32b's published widths at 8
   layers) whose qwen3-32b primary is killed: that app recovers and its
   clients are served after the kill; it prints the recovered variant,
   detection, client downtime, the measured load seconds, the plan wall
   and the peak memory allocated; (c) (a)'s spec with the four
   decoder-only archs outside the default list (qwen1.5-4b, gemma3-27b,
   llava-next-mistral-7b, arctic-480b) on the testbed and on the sim:
   equal failover choices, no load error, K1, K2 and the K5 round kernel
   launched during the testbed run; (d) the testbed's tensor-parallel
   shard plane: qwen2.5-3b (critical) and rwkv6-3b at their published
   configs (bf16), ``tp_degree=2`` on 3 sites x 2 servers, each group's
   weights drawn on the card, split into two slices held by two workers
   and gathered into the lead's engine, whose greedy tokens for a fixed
   prompt must equal those of a ``WorkerServer.load`` engine of the same
   variant; run under ``shard_policy="auto"`` with a non-lead member of
   each group killed (qwen2.5-3b degrades: its rebuilt engine, a slice
   zero-filled, gives finite logits unlike the full engine's; rwkv6-3b
   reshards: the lead serves ``:full`` again with the same tokens, and the
   measured repartition recalibrates the sim's model), then under
   ``"monolith"`` with qwen2.5-3b's member killed (the group falls back
   and the controller plans and cold-loads a monolith); no load error;
   K1, K2, both K4 routes and (in the monolith run) the K5 round kernel
   launched; it prints the six measured wall-time series, client MTTR,
   availability, refused submits and the peak memory of each run;
7. the rest of the planning and protection plane, in this process from
   fixed seeds, K5's round-kernel counters zeroed just before and read
   just after each planning run: (a) 20 random instances per state dtype
   with a ``latency_fn`` (about half the (variant, server) pairs over the
   SLO, some NaN), exclusions and dead servers: the round kernel with the
   latency mask bit-equal to its plain version on the CPU, and the greedy
   planner on the card (one masked round launch a plan) equal to numpy's
   ``plan_greedy(latency_fn=...)``; phase 5's failover round timed with
   an all-true mask and without one, alternating; (b) phase 5's cell with
   ``planner="sharded"`` on the torch backend and on numpy with 4
   coordinators, each equal to phase 5's greedy torch run; (c)
   tools/bench_mttr.py's five (policy, planner, scheduler) cells at its
   --smoke shape, (d) tools/bench_shardfail.py's smoke cells (tp_degree 2,
   degrade / reshard / monolith) and (e) tests/test_autopilot.py:208's
   chaos run with the autopilot, each through the entry points on the
   torch and the numpy planner backends with equal fingerprints (printing
   MTTR, client downtime percentiles and phases; client MTTR and ladder
   actions; promotions and demotions); the round kernel launched wherever
   a torch-backend planner planned, the standalone argmax never; (f)
   benchmarks/ilp_vs_heuristic.py's instances: the ILP's objective at
   least the greedy planner's on the card;
8. training on the card, K1, K3's gated route and K4 under autograd
   (``FlashAttentionFn``: K1 keeps each row's log-sum-exp, its backward
   is ``csrc/flash_attention_bwd.cu``; ``RGLRUGatedScanFn`` and
   ``WKV6Fn``, whose backwards are ``csrc/rglru_scan_bwd.cu`` and
   ``csrc/rwkv6_scan_bwd.cu``): (a) K1's backward against
   ``flash_attention_bwd_ref`` on the same (q, k, v, o, lse, dO) and
   against autograd through ``flash_attention_plain`` (1e-4 of the
   largest |gradient| in f32, 2e-2 in bf16), K1's lse against the plain
   forward's, two runs bit-equal, at qwen2.5-3b B=2 S=256 (f32 and
   bf16), gemma3-27b S=2100 window 1024, whisper-medium's 1500x1500
   encoder and 64x1500 cross attention, arctic-480b (G = 7),
   recurrentgemma-2b's hd-256 local layer at S=2100 and every K1 shape
   of (b), each with ``plan_bwd``'s choice (the GQA group split across
   blocks or not) and block count; each timed beside its plain version
   and the bound (2.5x the forward's operations; f32 at the 3xTF32
   rate), and K1's forward + backward beside SDPA's forward + backward;
   then both of ``plan_bwd``'s plans timed in turns at shapes on both
   sides of its split rule, their gradients within the same tolerance;
   and K3's gated backward (recurrentgemma-2b's width, B=1 and 2 at
   S=256, S=2100) and K4's (rwkv6-3b's 40 heads of 64, B=1 and 2 at
   S=256, S=33, lw to -20) in f32 and bf16 against their plain backwards
   and against autograd through their plain forwards on the card (the
   same tolerances; K4's dlw 1e-3; K4's plain backward is its kernel's
   algorithm, ``sub=16`` with 3xTF32 rounding), two runs bit-equal, each
   timed beside its plain version, the earlier design's time and the
   bound (K3 at the fp32 rate, K4 at the 3xTF32 rate, or bytes); then
   K3's backward at its rows under ``plan_chunks``'s plan and its
   neighbours, timed, the gradients within the same tolerance of the
   planned ones;
   (b) two ``make_train_step`` steps on SMOKE params of all ten archs,
   card against CPU (losses within 1e-5 relative, the gradients within
   1e-4 x max(1, max|g|), params moved, the forward and backward kernels
   of the arch's layers launched by the card steps); then ``cfg.remat``:
   for one SMOKE arch per loop kind (qwen2.5-3b, recurrentgemma-2b,
   gemma3-27b with its binding window and with a window past S,
   rwkv6-3b, qwen3-moe-30b-a3b, whisper-medium) a gradient with remat
   and one without through the kernels, bit-equal (the MoE arch within
   1e-4 x max(1, max|g|)), each run's K1/K3/K4 launches exactly one
   forward per layer, twice in a checkpointed layer (the backward's
   recompute), and one backward; (c) qwen2.5-3b,
   rwkv6-3b and recurrentgemma-2b at their published configs in fp32
   (remat on, as published), B=2 x S=256, one after the other: the
   attention, recurrent-block and embedding gradients through the
   kernels against the plain paths on the card, then 3 steps, the loss
   finite and falling over them (the last below the first), each
   kernel's launches exactly those of 3 remat steps; the step's host
   wall, device ms (torch.profiler), idle share, device kernels, the
   port's kernels' share of the device time by kernel name, tokens/s
   and peak memory, the walls of 3 more steps and the caching
   allocator's retries, allocations and frees a step; for qwen2.5-3b
   one step with ``remat=False`` beside it (the same first loss, its
   wall, device ms and peak); (d) ``train(scale="20m")`` of
   qwen2.5-3b and of rwkv6-3b crashed at step 6 and resumed: its losses
   bit-equal to one uninterrupted run's, the last checkpoint restored on
   the CPU bit-equal to the card's.
9. launch and layout: (a) ``make_local_mesh()``, a (1, 1) ("data",
   "model") ``DeviceMesh`` over cuda:0 with a process group of one (NCCL
   over a ``HashStore``), ``current_mesh()`` it inside ``with`` and None
   outside; (b) the elastic restore on the card: qwen2.5-3b's full-width
   bf16 params as the worker draws them, saved and restored through
   ``shardings=param_shardings(param_shapes(cfg), mesh, serving=True)``,
   every local shard bit-equal to the saved leaf, and an engine on
   ``local_tree`` of them giving the greedy tokens of an engine on the
   params never saved for phase 4's first prompt (K1, K2 launched,
   counted); then phase 8 (d)'s crash and resume of rwkv6-3b with the
   resume's restore through ``shardings=`` on the mesh, its losses
   bit-equal to the uninterrupted run's (K4 and K4's backward launched,
   counted); (c) the dry run's accounting held against the card, for
   qwen2.5-3b's published config on the mesh at shapes cut from SHAPES
   (``LAYOUT_CELLS``: a prefill at B=1 S=4096, a decode step at B=32
   against a 4096 cache, a train step at B=2 S=4096 with remat):
   ``lower_cell``'s
   per-device argument bytes equal to the caching allocator's growth in
   requested bytes when the same params (drawn), AdamW state or cache,
   and batch are placed on the card, and ``torch.cuda.memory_allocated``'s
   growth above them within the allocator's rounding (512 bytes a block,
   and up to 1 MiB more for a block over 1 MiB, whose segment's rest is
   not split off); the real step's
   time (CUDA events around the eager call, median of 10) at or above
   max(model flops / 989 TFLOP/s, argument bytes / 3.35 TB/s), printed
   beside the trace's compute and memory terms and useful_flop_frac; and
   the step's own peak (the allocator's peak over the run less its count
   just before it) at or under the record's ``temp_bytes`` in requested
   bytes, and at or under ``temp_bytes + temp_alloc_slack`` (the
   allocator's rounding of the storages the trace holds at once) in
   ``max_memory_allocated``'s bytes, the bounds it claims; (d) ``python -m
   repro_torch.launch.dryrun --all --no-save``, started in the background
   at the lowest CPU priority after (c), so that (c)'s times are taken on
   a quiet host, and run beside (b), must end with "33 ok, 0 failed, 7
   skipped"; each cell's line is printed. The order is (a), (c), (b),
   phase 10, (d);
10. while phase 9 (d)'s sweep runs, the example ports, each in a
   subprocess through its own entry point on the card:
   ``examples/{quickstart,failure_storm,site_failure_sim}_torch.py``,
   whose output must equal their ``--device cpu`` runs' (run beside),
   ``train_lm_torch.py --scale toy --steps 50`` (crash, resume) and,
   alone after them, ``edge_failover_torch.py --settle 2`` (the live
   testbed: every app recovered); each must exit 0.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel (the backward kernels as ``flash_attention_bwd``,
``rglru_gated_bwd`` and ``wkv6_bwd``) with its launches, error, times
and bound.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEV = torch.device("cuda")

# H100 SXM data-sheet peaks (dense): HBM rate, bf16 tensor-core rate (K1
# and K2 at the main path's bf16 shapes), fp32 rate outside the tensor
# cores (K3 and K4 compute in fp32 FMAs), and the TF32 tensor-core rate
# (495 TFLOP/s) over the three TF32 products of one 3xTF32 fp32 product
# (K1's backward in f32)
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
# the rate each peak is, as the JSON rows name it
PEAK_NAMES = {PEAK_BF16_FLOPS: "bf16 tensor core",
              PEAK_TF32X3_FLOPS: "tf32x3 tensor core",
              PEAK_FP32_FLOPS: "fp32 non-tensor"}
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_ATOL = 1e-5           # K3, tests/test_kernels.py:77-78
# K3's gated route: 1e-5 of the largest |h| (at least 1). Its gates are
# the plain version's operations in the same order, and its scan rounds a
# chunk's carry (a product of up to S / 32 decays) as the (a, b) route
# does; the state's magnitude (1 - a^2 small, h up to ~1 / sqrt(1 - a))
# scales that rounding, so the tolerance is relative to it
GATED_RTOL = 1e-5
# operations per element of K3's gated route: two sigmoids (negate, exp,
# add, divide), log a, exp, 2 log a, exp, 1 - ., max, sqrt, two products,
# and the scan's multiply-add; an exp, a divide or a sqrt counted as one
GATED_FLOPS = 19
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
    (2, 1, 1500, 16, 16, 64, False, 0),     # Sq != Skv, non-causal:
    (1, 64, 1500, 16, 16, 64, False, 0),    # whisper's cross attention
    (2, 33, 77, 8, 2, 128, False, 0),       # and a ragged pair
]
DECODE_SWEEP = [                    # tests/test_kernels.py:42-46
    (3, 8, 2, 64, 200, 0),
    (2, 4, 1, 32, 64, 16),
    (1, 16, 16, 128, 300, 0),
    (2, 4, 4, 128, 300, 0),                 # G = 1, 5, 8, 32 as
    (4, 5, 1, 256, 512, 100),               # tests/test_torch_cuda.py
    (4, 16, 2, 128, 512, 0),
    (2, 32, 1, 64, 700, 0),
    (2, 56, 8, 128, 300, 0),                # G = 7, arctic-480b's
]
SCAN_SWEEP = [(2, 100, 256), (1, 64, 128), (3, 17, 256)]    # :64-68
# K3's extra rows (B, S, W): prompts that are no multiple of a chunk
# (S / 32 steps) or shorter than 32, a 2100-token prompt (a chunk walked
# in groups, a and b recomputed), S = 1, a ragged width
SCAN_EDGES = [(1, 33, 2560), (2, 7, 64), (1, 2100, 2560), (3, 1, 100),
              (2, 300, 100)]
WKV_SWEEP = [(2, 3, 70, 16), (1, 2, 64, 32), (2, 1, 33, 8)]  # :82-86
# ladder rungs whose kernel shapes phase 2 checks and times: the :full and
# :w050 that phase 4 serves, and qwen2.5-3b's w075 as a reference row
RUNGS = {"qwen2.5-3b": ("full", "w075", "w050"),
         "recurrentgemma-2b": ("full", "w050"),
         "rwkv6-3b": ("full", "w050"),
         "qwen3-32b": ("full", "w050"),
         "qwen1.5-4b": ("full", "w050"),
         "gemma3-27b": ("full", "w050"),
         "llava-next-mistral-7b": ("full", "w050"),
         "arctic-480b": ("full", "w050")}
PREFILL_LENS = (128, 256, 512)
# the archs beyond the testbed's five: their K1 rows are timed at one
# prompt of 256 tokens (a prompt past the window where one binds),
# llava's also at its 576 patch embeddings + 64 tokens
NEW_ARCHS = ("qwen1.5-4b", "gemma3-27b", "llava-next-mistral-7b",
             "arctic-480b")
NEW_PREFILL_LENS = {"llava-next-mistral-7b": (256, 640)}
# whisper-medium's encoder-decoder path (phase 4 (w)): 1500 frames, a
# 64-token prompt into each of the 4 slots, then decode steps
WHISPER_RUNGS = ("full", "w050")
WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_STEPS = 1500, 64, 8
RAGGED_LEN = 333            # K1 rows whose prompt ends inside a query tile
RAGGED_TAGS = ("qwen2.5-3b full", "recurrentgemma-2b full")
BINDING_LEN = 2100          # a prompt past recurrentgemma-2b's window 2048
SLOTS, MAX_LEN, NEW_TOKENS = 4, 512, 32
DECODE_LENS = [97, 161, 288, 512]
ARCHS = ("qwen2.5-3b", "recurrentgemma-2b", "rwkv6-3b", "qwen3-32b") \
    + NEW_ARCHS
# phase 4's depth cuts: qwen3-32b's :full at 64 layers is ~65.5 GB of bf16
# weights and its :w050 ~17 GB more, which do not fit 80 GB together;
# arctic-480b's layer holds 128 x 3 x 7168 x 4864 expert weights, ~26.8
# GB of bf16, so 2 of its 35 layers (~55.6 GB, :w050 ~7.4 GB more).
# gemma3-27b runs at the ladder's 60 layers (its 62 rounded to whole
# 6-layer cycles), ~52.4 GB with :w050 ~13.8 GB more
SERVE_LAYERS = {"qwen3-32b": 32, "arctic-480b": 2}
# phase 6: tests/test_experiment.py:185's testbed spec with the default
# arch list, and the full-width testbed's depth of qwen3-32b (the card
# holds up to four copies of the largest rung at once: primary, warm
# backup, the re-protection load and the killed worker's engine)
TESTBED_SPEC = dict(scenario="single-server", app_mix="arch", archs=None,
                    n_sites=3, servers_per_site=2, headroom=0.35,
                    client_hz=20.0, time_scale=0.25, settle_s=25.0, seed=1)
FULL_TESTBED_LAYERS = {"qwen2.5-3b": None, "qwen3-32b": 8}
# phase 6 (d): the testbed's tensor-parallel shard plane at full width,
# (arch, critical): under shard_policy "auto" the critical qwen2.5-3b
# degrades and rwkv6-3b reshards; a 16-token prompt holds the gathered
# engines' greedy tokens against a monolith load's
SHARD_APPS = (("qwen2.5-3b", True), ("rwkv6-3b", False))
SHARD_PROMPT = 16
# the testbed's smoke ladders serve f32 engines of 2 slots x 96 positions
# with 8-token prompts (serving/server.py, serving/workload.py)
SMOKE_SLOTS, SMOKE_MAX_LEN, SMOKE_PROMPT = 2, 96, 8
# K6 at qwen3-32b's MLP: gate/up (M, 5120) x (5120, 25600) and down
# (M, 25600) x (25600, 5120), at decode (4 slots) and a 256-token prefill
INT8_SWEEP = [(100, 300, 200), (64, 128, 64), (33, 65, 130)]  # :102-104
# K6's tensor-core routes at reduced widths (M, K, N): split-K decode
# (an unaligned row, a ragged K), split-K and one-range prefill
INT8_ROUTES = [(4, 5120, 1024), (4, 2048, 130), (1, 1000, 256),
               (16, 4096, 640), (256, 1024, 2048), (100, 520, 390),
               (256, 512, 25600)]
INT8_MLP = {"gate/up": (5120, 25600), "down": (25600, 5120)}
INT8_M = (SLOTS, 256)
# route -> (kernel package, source, TPU kernel it replaces, headline row
# of the JSON line); K3 and K4 have two routes each in one source, K5
# three (the round kernel without and with a latency mask, the argmax)
KERNELS = {
    "flash_attention": (
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:29",
        "qwen2.5-3b full S=256"),
    "flash_attention_bwd": (
        "flash_attention_bwd",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:29",
        "qwen2.5-3b full S=256 float32"),
    "rglru_gated_bwd": (
        "rglru_scan_bwd",
        "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan_bwd.cu",
        "src/repro/kernels/rglru_scan/rglru_scan.py:25",
        "recurrentgemma-2b full B=2 S=256 float32"),
    "wkv6_bwd": (
        "rwkv6_scan_bwd",
        "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan_bwd.cu",
        "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:26",
        "rwkv6-3b full B=2 S=256 float32"),
    "decode_attention": (
        "decode_attention",
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:27",
        "qwen2.5-3b full decode"),
    "rglru_gated": (
        "rglru_scan",
        "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan/rglru_scan.py:25",
        "recurrentgemma-2b full S=256"),
    "rglru_scan": (
        "rglru_scan",
        "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan/rglru_scan.py:25",
        "recurrentgemma-2b full S=256"),
    "rwkv6_chunked": (
        "rwkv6_scan",
        "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
        "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:26",
        "rwkv6-3b full S=256"),
    "rwkv6_scan": (
        "rwkv6_scan",
        "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
        "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:26",
        "rwkv6-3b full decode"),
    "planner_round": (
        "planner_argmax",
        "src/repro_torch/kernels/planner_argmax/csrc/planner_argmax.cu",
        "src/repro/kernels/planner_argmax/planner_argmax.py:29",
        "site-outage failover round"),
    "planner_round_masked": (
        "planner_argmax",
        "src/repro_torch/kernels/planner_argmax/csrc/planner_argmax.cu",
        "src/repro/kernels/planner_argmax/planner_argmax.py:29",
        "site-outage failover round, all-true latency mask"),
    "planner_argmax": (
        "planner_argmax",
        "src/repro_torch/kernels/planner_argmax/csrc/planner_argmax.cu",
        "src/repro/kernels/planner_argmax/planner_argmax.py:29",
        "(8,1000) float64 dense"),
    "int8_matmul": (
        "int8_matmul",
        "src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu",
        "src/repro/kernels/int8_matmul/int8_matmul.py:24",
        "qwen3-32b gate/up M=4"),
}
# the serving routes, whose launches phase 4 checks per layer
SERVING = ("flash_attention", "decode_attention", "rglru_gated",
           "rwkv6_chunked", "rwkv6_scan")
# routes off the main path, each counted on a standalone path of its own
STANDALONE = ("rglru_scan", "planner_argmax", "int8_matmul")
# routes only a planner call with a latency_fn takes (phase 7 (a)); the
# controller, the simulator and the testbed plan no such request
LATENCY_ONLY = ("planner_round_masked",)
# routes only a train step takes (phase 8): the backward kernels of K1,
# K3's gated route and K4. Each one's "replaces" is its forward's TPU
# kernel: the JAX package has no backward kernel and takes those
# gradients from XLA's autodiff of flash_attention_jnp, rglru_scan and
# wkv_chunked / wkv_scan
TRAINING_ONLY = ("flash_attention_bwd", "rglru_gated_bwd", "wkv6_bwd")
INT8_PATH = "standalone (no JAX caller): int8 SwiGLU at qwen3-32b's MLP"
SCAN_PATH = ("standalone (off the main path since the gated route): "
             "recurrentgemma-2b's RG-LRU unfused, the _gates tail then the "
             "(a, b) route, a 256-token prefill and decode steps")
SCAN_PATH_STEPS = 8
ARGMAX_PATH = ("standalone (off the main path since the round kernel): the "
               "failover round's place_chunk + upgrade_chunk on the card")
# the smoke :full rungs whose K1/K2 shapes phase 2 times (the attention
# archs of the testbed's default list)
TESTBED_SMOKE_TIMED = ("qwen2.5-3b", "qwen3-32b", "recurrentgemma-2b",
                       "qwen3-moe-30b-a3b")
# the serving kernels' device names, as torch.profiler reports them: K1's
# tensor-core (bf16) and scalar (f32) kernels, K2's split and combine
# passes, K3's chunked prefill and decode step, K4's recurrence and its
# three chunked kernels
PORT_KERNEL_NAMES = ("fa_tc_kernel", "fa_kernel", "dec_split_kernel",
                     "dec_combine_kernel", "rglru_chunk_kernel",
                     "rglru_step_kernel", "wkv_kernel",
                     "wkv_chunk_state_kernel", "wkv_chunk_scan_kernel",
                     "wkv_chunk_out_kernel")
# K5's device names: the standalone argmax and the round kernel
K5_KERNEL_NAMES = ("masked_argmax_kernel", "plan_round_kernel")
NO_LIBRARY = {
    "rglru_gated": "none: no single PyTorch call computes this recurrence "
                   "or its gates",
    "rglru_scan": "none: no single PyTorch call computes this recurrence",
    "rwkv6_chunked": "none: no single PyTorch call computes this recurrence",
    "rwkv6_scan": "none: no single PyTorch call computes this recurrence",
    "rglru_gated_bwd": "none: no single PyTorch call computes this "
                       "recurrence's gradient",
    "wkv6_bwd": "none: no single PyTorch call computes this recurrence's "
                "gradient",
    "planner_round": "none: no single PyTorch call plans a round",
    "planner_round_masked": "none: no single PyTorch call plans a round",
    "planner_argmax": "none (no single PyTorch call)",
}
# K4's extra rows: prompts that are no multiple of the 32-step chunk and
# prompts shorter than it, (B, NH, S, hs)
WKV_EDGES = [(1, 2, 31, 64), (2, 3, 33, 16), (1, 2, 2, 32), (2, 1, 95, 8),
             (1, 4, 250, 64)]
WKV_LW_MIN = (-3.0, -20.0)        # lw spread down to these
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
    """Every kernel package's wrapper module, by package name."""
    from repro_torch.kernels.int8_matmul import ops as k6
    from repro_torch.kernels.planner_argmax import ops as k5
    return {**ops_modules(), "planner_argmax": k5, "int8_matmul": k6}


def reset_counts():
    """Zero every wrapper's launch counters."""
    for m in all_ops().values():
        for name in ("LAUNCHES", "BWD_LAUNCHES", "GATED_LAUNCHES",
                     "CHUNKED_LAUNCHES", "ROUND_LAUNCHES",
                     "MASKED_LAUNCHES"):
            if hasattr(m, name):
                setattr(m, name, 0)


def read_counts(routes=None):
    """Launches since the last reset, by route (``KERNELS``): K1's forward
    and backward, K3's gated and (a, b) calls and the gated route's
    backward, K4's chunked prefill and recurrent decode calls and its
    backward, K5's
    round kernel without and with a latency mask and its standalone
    argmax apart."""
    m = all_ops()
    rg, wkv, k5 = m["rglru_scan"], m["rwkv6_scan"], m["planner_argmax"]
    out = {name: m[name].LAUNCHES for name in
           ("flash_attention", "decode_attention", "int8_matmul")}
    out.update(flash_attention_bwd=m["flash_attention"].BWD_LAUNCHES,
               rglru_gated_bwd=rg.BWD_LAUNCHES, wkv6_bwd=wkv.BWD_LAUNCHES,
               rglru_gated=rg.GATED_LAUNCHES,
               rglru_scan=rg.LAUNCHES - rg.GATED_LAUNCHES,
               rwkv6_chunked=wkv.CHUNKED_LAUNCHES,
               rwkv6_scan=wkv.LAUNCHES - wkv.CHUNKED_LAUNCHES,
               planner_round=k5.ROUND_LAUNCHES - k5.MASKED_LAUNCHES,
               planner_round_masked=k5.MASKED_LAUNCHES,
               planner_argmax=k5.LAUNCHES - k5.ROUND_LAUNCHES)
    return {k: out[k] for k in (routes or KERNELS)}


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


def cold_ms(fn, reps=10, n=10):
    """Device ms of one call with a cold L2: ``reps`` x (a 128 MB write
    that evicts the 50 MB L2, then the call) in one CUDA graph, less the
    writes alone."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=DEV)
    both = graph_ms(lambda: (flush.zero_(), fn()), reps=reps, n=n)
    alone = graph_ms(flush.zero_, reps=reps, n=n)
    return both - alone


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
                bound_ms=b_ms, bound_by=b_by, peak=PEAK_NAMES[peak])


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


def whisper_rung_shapes():
    """(tag, (H, KVH, hd)) of whisper-medium's rungs in ``WHISPER_RUNGS``."""
    from repro_torch import configs
    from repro_torch.core.variants import build_ladder

    ladder = {v.name: v.config for v in
              build_ladder(configs.get_config("whisper-medium"))}
    return [(f"whisper-medium {r}", (c.num_heads, c.num_kv_heads,
                                     c.head_dim))
            for r in WHISPER_RUNGS for c in [ladder[f"whisper-medium:{r}"]]]


def testbed_rung_shapes():
    """Each serving kernel's distinct shapes on every rung phase 6 can
    load: ``(smoke, full)``, each ``{kernel: sorted args}`` — the smoke
    ladders (f32, head_dim 16) of the five testbed archs that (a) serves
    and of the four that (c) serves, and the full-width ladders of phase
    6 (b). Rungs whose query heads do not divide among their KV heads
    (ROADMAP R8: the smoke :w075 of qwen2.5-3b, qwen3-moe-30b-a3b,
    gemma3-27b, llava-next-mistral-7b and arctic-480b) are left out: no
    model of either package builds them, so no worker loads them."""
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

    smoke = collect(testbed_ladder(a) for a in (*TESTBED_ARCHS, *NEW_ARCHS))
    full = collect(build_ladder(configs.get_config(a)) for a in
                   FULL_TESTBED_LAYERS)
    return smoke, full


def phase_kernels():
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_ref as dec_ref
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_ref as fa_ref
    from repro_torch.kernels.rglru_scan.ref import (rglru_gated_scan_ref,
                                                    rglru_scan_ref)
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

    def gated_inputs(B, S, W, dt):
        """ga, gx, xb (B,S,W) in ``dt``, log_lambda as the model draws it
        (a in [0.9, 0.999] at r = 1), h0 (B,W)."""
        a_init = torch.empty(W, device=dev).uniform_(0.9, 0.999, generator=g)
        lam = torch.log(torch.expm1(-torch.log(a_init) / 8.0))
        return (rnd((B, S, W), dt), rnd((B, S, W), dt), rnd((B, S, W), dt),
                lam, rnd((B, W)))

    def gated_err(h, hl, h_ref, hl_ref):
        """(max abs error, that error over the largest |h|, at least 1)"""
        e = max(err(h, h_ref), err(hl, hl_ref))
        return e, e / max(1.0, float(h_ref.abs().max()))

    def gated_case(B, S, W, dt):
        ga, gx, xb, lam, h0 = gated_inputs(B, S, W, dt)
        h_ref, hl_ref = rglru_gated_scan_ref(ga, gx, xb, lam, h0)
        state = h0.clone()
        h, _ = rg_ops.rglru_gated_scan(ga, gx, xb, lam, state, h_last=state)
        return (ga, gx, xb, lam, h0, state, h), gated_err(h, state, h_ref,
                                                          hl_ref)

    def wkv_inputs(B, NH, S, hs, dt, lw_min=-3.0):
        r, k, v = (rnd((B, S, NH, hs), dt) for _ in range(3))
        # lw spread over [lw_min, -0.05]; rwkv6-3b's decay_base reaches -3
        lw = -torch.exp(torch.empty((B, S, NH, hs), device=dev).uniform_(
            float(np.log(0.05)), float(np.log(-lw_min)), generator=g))
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
    # whisper's encoder, its cross attention at a prefill and at a decode
    # step (non-causal, Sq != Skv) and its decoder's causal prefill
    whisper = whisper_rung_shapes()
    whisper_flash = [
        (B, Sq, Skv, H, KVH, hd, causal, 0) for _, (H, KVH, hd) in whisper
        for B, Sq, Skv, causal in (
            (1, WHISPER_FRAMES, WHISPER_FRAMES, False),
            (1, WHISPER_PROMPT, WHISPER_FRAMES, False),
            (SLOTS, 1, WHISPER_FRAMES, False),
            (1, WHISPER_PROMPT, WHISPER_PROMPT, True))]
    decode_rungs += [(SLOTS, H, KVH, hd, MAX_LEN, 0)
                     for _, (H, KVH, hd) in whisper]
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
                flash_rungs + whisper_flash + (smoke_flash if smoke_only
                                               else []):
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
        for (B, NH, S, hs), lw_min in itertools.product(
                WKV_SWEEP + WKV_EDGES + wkv_rungs
                + (smoke_wkv if smoke_only else []), WKV_LW_MIN):
            r, k, v, lw, u, s0 = wkv_inputs(B, NH, S, hs, dt, lw_min)
            y_ref, s_ref = wkv6_ref(r, k, v, lw, u, s0)
            state = s0.clone()
            y, s = wkv_ops.wkv6(r, k, v, lw, u, state, s_out=state)
            if s is not state:
                raise AssertionError("rwkv6_scan: s_out is not s0")
            tol = WKV_ATOL if name == "float32" else ATOL[name]
            route = ("rwkv6_chunked" if wkv_ops.chunked_route(S)
                     else "rwkv6_scan")
            check(route, max(err(y, y_ref), err(state, s_ref)), tol,
                  f"{name} B={B} NH={NH} S={S} hs={hs} lw >= {lw_min} "
                  "from a nonzero state written over s0")
    for B, S, W in SCAN_SWEEP + SCAN_EDGES + scan_rungs + smoke_scan:
        a, b, h0 = scan_inputs(B, S, W)
        h_ref, hl_ref = rglru_scan_ref(a, b, h0)
        state = h0.clone()
        h, _ = rg_ops.rglru_scan(a, b, state, h_last=state)
        check("rglru_scan", max(err(h, h_ref), err(state, hl_ref)),
              SCAN_ATOL, f"float32 B={B} S={S} W={W} from a nonzero h0")
        for name, dt in dts.items():
            _, (e, rel) = gated_case(B, S, W, dt)
            log(f"  rglru_gated {name} gates B={B} S={S} W={W} from a "
                f"nonzero h0: max_abs_err {e:.3g}, {rel:.3g} of the largest "
                f"|h|")
            if not rel < GATED_RTOL:
                raise AssertionError(f"rglru_gated {name} {(B, S, W)}: "
                                     f"{e} ({rel} of the largest |h|)")

    # -- main-path shapes, timed --------------------------------------------
    bf16 = torch.bfloat16
    rows = {k: {} for k in KERNELS}

    def flash_row(tag, H, KVH, hd, S, window, dt=bf16, B=1, Skv=None,
                  causal=True):
        Skv = Skv or S
        q, k, v = (rnd((B, S, H, hd), dt), rnd((B, Skv, KVH, hd), dt),
                   rnd((B, Skv, KVH, hd), dt))
        e = err(fa_ops.flash_attention(q, k, v, causal=causal,
                                       window=window),
                flash_plain(q, k, v, causal, window))
        dname = str(dt).replace("torch.", "")
        if not e < ATOL[dname]:
            raise AssertionError(f"flash_attention {tag}: {e}")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = functools.partial(F.scaled_dot_product_attention, qt, kt, vt,
                                enable_gqa=True)
        if causal:
            pos = torch.arange(S, device=dev)
            band = pos[:, None] >= pos[None, :]
            if window:
                band &= pos[None, :] > pos[:, None] - window
            # score pairs this causal (and windowed) attention needs
            pairs = int(band.sum())
            lib = functools.partial(lib, **(
                {"attn_mask": band} if window and window < S
                else {"is_causal": True}))
        else:
            pairs = S * Skv
        rows["flash_attention"][tag] = timed_row(
            f"q ({B},{S},{H},{hd}) k/v ({B},{Skv},{KVH},{hd}) {dname} "
            + ("causal" if causal else "non-causal")
            + (f" window {window}" if window else ""), e,
            functools.partial(fa_ops.flash_attention, q, k, v, causal=causal,
                              window=window),
            lambda: flash_plain(q, k, v, causal, window), lib,
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

    def gated_row(tag, B, S, W, dt=bf16):
        (ga, gx, xb, lam, h0, state, h), (e, rel) = gated_case(B, S, W, dt)
        if not rel < GATED_RTOL:
            raise AssertionError(f"rglru_gated {tag}: {e} ({rel})")
        dname = str(dt).replace("torch.", "")
        row = timed_row(
            f"ga/gx/xb ({B},{S},{W}) {dname}, log_lambda ({W},) f32, h0 "
            f"({B},{W}) f32", e,
            functools.partial(rg_ops.rglru_gated_scan, ga, gx, xb, lam,
                              state, h_last=state),
            lambda: rglru_gated_scan_ref(ga, gx, xb, lam, h0), None,
            nbytes(ga, gx, xb, lam, h0, h, state),
            GATED_FLOPS * ga.numel(), PEAK_FP32_FLOPS,
            plain_reps=1 if S > 256 else 2)
        row["rel_err"] = rel
        # the path before the gated route: the tail of _gates in PyTorch
        # (a and b through memory), then the (a, b) route
        row["before_ms"] = graph_ms(functools.partial(
            rglru_unfused, rg_ops, ga, gx, xb, lam, state, h_last=state))
        rows["rglru_gated"][tag] = row

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
        kern = functools.partial(wkv_ops.wkv6, r, k, v, lw, u, state,
                                 s_out=state)
        route = "rwkv6_chunked" if wkv_ops.chunked_route(S) else "rwkv6_scan"
        # the chunked route's products run 3xTF32 on the tensor cores, the
        # recurrence in scalar fp32
        peak = (PEAK_TF32X3_FLOPS if route == "rwkv6_chunked"
                else PEAK_FP32_FLOPS)
        rows[route][tag] = row = timed_row(
            f"r/k/v ({B},{S},{NH},{hs}) bf16, lw f32, state "
            f"({B},{NH},{hs},{hs}) f32", e, kern,
            lambda: wkv6_ref(r, k, v, lw, u, s0), None,
            nbytes(r, k, v, lw, u, s0, y, state), flops, peak,
            plain_reps=2)
        if route == "rwkv6_chunked":
            row["cold_ms"] = cold_ms(kern)
            row["blocks"] = 2 * NH * B * wkv_ops.n_chunks(S)
            row["by_kernel_ms"] = {k[k.find("wkv_"):k.find("<")]: t
                                   for k, t, _c in device_kernels(kern, 20)}

    for tag, (H, KVH, hd, window) in shapes["flash_attention"]:
        arch = tag.split()[0]
        lens = (NEW_PREFILL_LENS.get(arch, (256,)) if arch in NEW_ARCHS
                else PREFILL_LENS)
        for S in lens + ((BINDING_LEN,) if window else ()):
            flash_row(f"{tag} S={S}", H, KVH, hd, S, window)
    for tag, (H, KVH, hd) in whisper:
        flash_row(f"{tag} encoder T={WHISPER_FRAMES}", H, KVH, hd,
                  WHISPER_FRAMES, 0, causal=False)
        flash_row(f"{tag} decoder S={WHISPER_PROMPT}", H, KVH, hd,
                  WHISPER_PROMPT, 0)
        flash_row(f"{tag} cross S={WHISPER_PROMPT}", H, KVH, hd,
                  WHISPER_PROMPT, 0, Skv=WHISPER_FRAMES, causal=False)
        flash_row(f"{tag} cross decode", H, KVH, hd, 1, 0, B=SLOTS,
                  Skv=WHISPER_FRAMES, causal=False)
    # a prompt that is no multiple of K1's 64-row query tile, at head_dim
    # 128 and 256
    for tag, (H, KVH, hd, window) in shapes["flash_attention"]:
        if tag in RAGGED_TAGS:
            flash_row(f"{tag} S={RAGGED_LEN} ragged", H, KVH, hd, RAGGED_LEN,
                      window)
    for tag, (H, KVH, hd, _w) in shapes["decode_attention"]:
        decode_row(f"{tag} decode", H, KVH, hd)
    for tag, (H, KVH, hd) in whisper:
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
        gated_row(f"{rung} S=256", 1, 256, W)
        gated_row(f"{rung} decode", SLOTS, 1, W)
        if rung.endswith(" full"):
            gated_row(f"{rung} S={BINDING_LEN}", 1, BINDING_LEN, W)
    for W in smoke["rglru_scan"]:
        gated_row(f"smoke W={W} S={SMOKE_PROMPT}", 1, SMOKE_PROMPT, W,
                  dt=torch.float32)
        gated_row(f"smoke W={W} decode", SMOKE_SLOTS, 1, W,
                  dt=torch.float32)
    for rung, (NH, hs) in shapes["rwkv6_scan"]:
        wkv_row(f"{rung} S=256", 1, 256, NH, hs)
        wkv_row(f"{rung} decode", SLOTS, 1, NH, hs)

    for kname, by_tag in rows.items():
        for tag, r in by_tag.items():
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.5f}")
            split = (f"; n_split {r['n_split']} x {r['chunk']} keys, "
                     f"{r['blocks']} blocks" if "n_split" in r else "")
            if "before_ms" in r:
                split = (f"; before (the _gates tail + the (a, b) route) "
                         f"{r['before_ms']:.5f} ms; error relative to the "
                         f"largest |h| {r['rel_err']:.3g}")
            if "cold_ms" in r:
                split = (f"; cold L2 {r['cold_ms']:.5f} ms; "
                         f"{r['blocks']} blocks in its two chunk kernels; "
                         f"by kernel (torch.profiler, ms) "
                         f"{json.dumps(r['by_kernel_ms'])}")
            log(f"  {kname} {tag} [{r['shape']}]: device ms kernel "
                f"{r['ms']:.5f}, plain {r['plain_ms']:.5f}, library {lib}, "
                f"bound {r['bound_ms']:.5f} ({r['bound_by']}, "
                f"{r['peak']} peak); eager call {r['eager_ms']:.5f} ms; "
                f"max_abs_err {r['max_abs_err']:.3g}{split}")
    torch.cuda.synchronize()
    return rows


def rglru_unfused(rg, ga, gx, xb, lam, h0, *, h_last=None):
    """K3 as the model ran it before the gated route: the elementwise tail
    of ``_gates`` in PyTorch (a and b written to memory), then the (a, b)
    route."""
    from repro_torch.kernels.rglru_scan.ref import rglru_gates_ref
    a, b = rglru_gates_ref(ga, gx, xb, lam)
    return rg.rglru_scan(a, b, h0, h_last=h_last)


def phase_scan_path():
    """K3's (a, b) route on a standalone path of its own (the model calls
    the gated route): recurrentgemma-2b's RG-LRU scan unfused, a 256-token
    prefill then ``SCAN_PATH_STEPS`` decode steps of 4 slots from the
    prefill's state, in bf16, checked against the gated route. The
    counters are zeroed just before and read just after. Returns the
    (a, b) route's launches."""
    from repro_torch import configs

    rg = ops_modules()["rglru_scan"]
    W = configs.get_config("recurrentgemma-2b").rnn_width
    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    a_init = torch.empty(W, device=DEV).uniform_(0.9, 0.999, generator=g)
    lam = torch.log(torch.expm1(-torch.log(a_init) / 8.0))

    def gates(B, S):
        return [torch.randn((B, S, W), generator=g, device=DEV).to(
            torch.bfloat16) for _ in range(3)]

    pre = gates(1, 256)
    steps = [gates(SLOTS, 1) for _ in range(SCAN_PATH_STEPS)]
    torch.cuda.synchronize()
    reset_counts()
    h, state = rglru_unfused(rg, *pre, lam,
                             torch.zeros((1, W), device=DEV))
    state = state.expand(SLOTS, W).contiguous()
    outs = [rglru_unfused(rg, *x, lam, state, h_last=state)[0]
            for x in steps]
    torch.cuda.synchronize()
    got = read_counts(("rglru_scan", "rglru_gated"))
    want = {"rglru_scan": 1 + SCAN_PATH_STEPS, "rglru_gated": 0}
    if got != want:
        raise AssertionError(f"the unfused RG-LRU path launched {got}, "
                             f"want {want}")
    hg, sg = rg.rglru_gated_scan(*pre, lam, torch.zeros((1, W), device=DEV))
    sg = sg.expand(SLOTS, W).contiguous()
    e = err(h, hg)
    for x, o in zip(steps, outs):
        e = max(e, err(o, rg.rglru_gated_scan(*x, lam, sg, h_last=sg)[0]))
    log(f"  K3's (a, b) route on its standalone path (the unfused RG-LRU "
        f"of recurrentgemma-2b, W={W}: a 256-token prefill and "
        f"{SCAN_PATH_STEPS} decode steps of {SLOTS} slots): launches "
        f"{json.dumps(got)}; against the gated route max_abs_err {e:.3g}")
    if not e < GATED_RTOL * max(1.0, float(h.abs().max())):
        raise AssertionError(f"unfused and gated RG-LRU differ by {e}")
    return got["rglru_scan"]


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
    # the bf16 routes at reduced widths: split-K decode and one-range
    # prefill, bf16 and f32 outputs, two launches bit-equal
    n_sm = k6.sm_count(torch.cuda.current_device())
    for M, K, N in INT8_ROUTES:
        x = torch.randn((M, K), generator=g, device=DEV).to(torch.bfloat16)
        wq, sc = quantized(K, N)
        for out_dtype in (torch.bfloat16, torch.float32):
            out = k6.int8_matmul(x, wq, sc, out_dtype=out_dtype)
            again = k6.int8_matmul(x, wq, sc, out_dtype=out_dtype)
            e = err(out, k6.int8_matmul_torch(x, wq, sc,
                                              out_dtype=out_dtype))
            n_split, chunk = k6.plan_splitk(M, N, K, n_sm)
            log(f"  int8_matmul bfloat16 ({M},{K})x({K},{N}) -> "
                f"{str(out_dtype).replace('torch.', '')}: n_split "
                f"{n_split} x {chunk}; max_abs_err {e:.3g}; two launches "
                f"bit-equal {torch.equal(out, again)}")
            if not e < 10 * ATOL["bfloat16"] or not torch.equal(out, again):
                raise AssertionError(f"int8_matmul {(M, K, N)} "
                                     f"{out_dtype}: {e}")

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
            # at K = 25600 the outputs pass 32, where one bf16 ulp is 0.25:
            # two fp32 sums in different orders round to neighbouring bf16
            # values there. So the sums are held at the tolerance in fp32,
            # and the bf16 output must be the fp32 output rounded, exactly
            out32 = k6.int8_matmul(x, wq, sc, out_dtype=torch.float32)
            e32 = err(out32, k6.int8_matmul_torch(x, wq, sc,
                                                  out_dtype=torch.float32))
            exact = torch.equal(out, out32.to(bf16))
            log(f"  int8_matmul qwen3-32b {part} M={M}: bf16 output "
                f"max_abs_err {e:.3g} (largest |out| "
                f"{float(out32.abs().max()):.3g}); fp32 output max_abs_err "
                f"{e32:.3g}; bf16 output the fp32 output rounded: {exact}")
            if not e32 < 10 * ATOL["bfloat16"] or not exact:
                raise AssertionError(f"int8_matmul {part} M={M}: {e32}, "
                                     f"rounded exactly: {exact}")
            r = timed_row(
                f"x ({M},{K}) bf16 @ w_q ({K},{N}) int8 * scale ({N},) f32",
                e, functools.partial(k6.int8_matmul, x, wq, sc),
                functools.partial(k6.int8_matmul_torch, x, wq, sc),
                functools.partial(lib, x, wq, wqt, sc, scx),
                nbytes(x, wq, sc, out), 2 * M * N * K, PEAK_BF16_FLOPS,
                plain_reps=5)
            r["library"] = lib_name
            r["n_split"], r["k_chunk"] = k6.plan_splitk(M, N, K, n_sm)
            rows[f"qwen3-32b {part} M={M}"] = r
            log(f"  int8_matmul qwen3-32b {part} M={M} [{r['shape']}]: "
                f"device ms kernel {r['ms']:.5f}, plain "
                f"{r['plain_ms']:.5f}, library ({lib_name}) "
                f"{r['library_ms']:.5f}, bound {r['bound_ms']:.5f} "
                f"({r['bound_by']}, bf16 tensor core peak); eager call "
                f"{r['eager_ms']:.5f} ms; max_abs_err {e:.3g}; n_split "
                f"{r['n_split']} x {r['k_chunk']}")

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

@contextlib.contextmanager
def plain_attention():
    """The model's attention on its plain path (``flash_attention_plain``,
    ``decode_attention_dense``) on any device, for a reference computation
    on the card; never on a counted path."""
    from repro_torch.models import layers as L

    fa, dec = L.flash_attention, L.decode_attention
    L.flash_attention = L.flash_attention_plain
    L.decode_attention = L.decode_attention_dense
    try:
        yield
    finally:
        L.flash_attention, L.decode_attention = fa, dec


def parity(arch, num_layers, prompt_len, max_len, *, extra_len=0,
           ref_on_card=False, **cfg_kw):
    """Prefill ``prompt_len`` tokens and decode three, on the card and on
    the CPU from the same fp32 params; returns the worst logits error.
    ``extra_len`` seeded embeddings go before the prompt (llava's patches)
    or to the encoder (whisper's frames). With ``ref_on_card`` the
    reference is the plain attention path on the card, on the same
    params."""
    from repro_torch import bridge, configs
    from repro_torch.device import generator_for
    from repro_torch.models import model as MDL

    cfg = configs.get_config(arch).replace(
        num_layers=num_layers, param_dtype="float32",
        activation_dtype="float32", **cfg_kw)
    cuda = DEV
    ref = cuda if ref_on_card else torch.device("cpu")
    params = MDL.init_params(generator_for(cuda, SEED), cfg, device=cuda)
    params_ref = params if ref_on_card else bridge.params_from_jax(
        bridge.params_to_numpy(params), ref)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, prompt_len)).astype(np.int32))
    extra = None if not extra_len else torch.from_numpy(
        rng.standard_normal((2, extra_len, cfg.d_model)).astype(np.float32))
    cache_g = MDL.init_cache(cfg, 2, max_len, device=cuda)
    cache_c = MDL.init_cache(cfg, 2, max_len, device=ref)
    on_ref = plain_attention if ref_on_card else contextlib.nullcontext
    where = "plain path on the card" if ref_on_card else "cpu"
    worst = 0.0
    with torch.inference_mode():
        lg, _ = MDL.prefill(params, cfg, toks.to(cuda), cache_g,
                            None if extra is None else extra.to(cuda))
        with on_ref():
            lc, _ = MDL.prefill(params_ref, cfg, toks.to(ref), cache_c,
                                None if extra is None else extra.to(ref))
        lc = lc.cpu()
        for step in range(4):
            e = float((lg.cpu() - lc).abs().max())
            worst = max(worst, e)
            tg, tc = lg.argmax(-1).cpu(), lc.argmax(-1)
            log(f"  {arch} {'prefill' if step == 0 else f'decode {step}'}: "
                f"logits max_abs_err {e:.3g}, greedy card {tg.tolist()} "
                f"{where} {tc.tolist()}")
            if not e < LOGIT_ATOL or not torch.equal(tg, tc):
                raise AssertionError(f"{arch}: card and {where} disagree")
            if step == 3:
                break
            lg, _ = MDL.decode_step(params, cfg, tg.to(cuda), cache_g)
            with on_ref():
                lc, _ = MDL.decode_step(params_ref, cfg, tc.to(ref), cache_c)
            lc = lc.cpu()
    torch.cuda.synchronize()
    del params, params_ref, cache_g, cache_c
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def phase_parity():
    from repro_torch import configs

    out = {"qwen2.5-3b": parity("qwen2.5-3b", 2, 16, 32)}
    # 5 layers = one (rglru, rglru, local) cycle + the (rglru, rglru) tail;
    # 2100 > window 2048: banded on the CPU, windowed in K1, and the ring
    # of 2048 slots wraps in the prefill and again in the decode steps. Its
    # RG-LRU layers take K3's gated route, once a layer per call
    reset_counts()
    out["recurrentgemma-2b"] = parity("recurrentgemma-2b", 5, 2100, 2200)
    got = read_counts(("rglru_gated", "rglru_scan"))
    n_rglru = configs.get_config("recurrentgemma-2b").replace(
        num_layers=5).layer_kinds().count("rglru")
    want = {"rglru_gated": 4 * n_rglru, "rglru_scan": 0}
    log(f"  recurrentgemma-2b's card run launched K3 {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"recurrentgemma-2b parity launched K3 {got}, "
                             f"want {want} (the gated route, one launch a "
                             "layer per prefill and decode step)")
    out["rwkv6-3b"] = parity("rwkv6-3b", 2, 250, 256)
    out["qwen3-32b"] = parity("qwen3-32b", 2, 16, 32)
    # 2 x 16 tokens over 128 experts top-8: capacity 8 slots an expert
    out["qwen3-moe-30b-a3b"] = parity("qwen3-moe-30b-a3b", 2, 16, 32)
    out["qwen1.5-4b"] = parity("qwen1.5-4b", 2, 16, 32)
    # one (local x 5, global) cycle; 1100 > window 1024: banded on the
    # CPU, windowed in K1, and the local layers' ring of 1024 slots wraps
    # in the prefill and again in the decode steps
    out["gemma3-27b"] = parity("gemma3-27b", 6, 1100, 1104)
    out["llava-next-mistral-7b"] = parity(
        "llava-next-mistral-7b", 2, 64, 576 + 68, extra_len=576)
    out["whisper-medium"] = parity(
        "whisper-medium", 8, 64, 68, extra_len=WHISPER_FRAMES,
        num_encoder_layers=4, num_decoder_layers=4)
    # one fp32 layer of 128 experts (~53 GiB) fits the card once
    out["arctic-480b"] = parity("arctic-480b", 1, 16, 32, ref_on_card=True)
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


def time_calls(calls, n=10):
    """Per call of ``calls`` ({name: fn}): the host wall of an eager call
    (ending in a synchronize) against the device time of the same call
    replayed from a CUDA graph, medians of ``n``."""
    out = {}
    with torch.inference_mode():
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


def serving_calls(MDL, eng, prompt_len=256):
    """A decode step over all slots at ragged positions and a prefill of
    one prompt of ``prompt_len`` into a zeroed slot, on the engine's own
    params and a cache of its own."""
    cfg, dev = eng.cfg, eng.device
    with torch.inference_mode():
        cache = MDL.init_cache(cfg, SLOTS, MAX_LEN, device=dev)
        cache["pos"].copy_(torch.tensor([97, 161, 288, 400]))
    tok = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)
    prompt = torch.zeros((1, prompt_len), dtype=torch.int32, device=dev)
    return {"decode_step": lambda: MDL.decode_step(eng.params, cfg, tok,
                                                   cache),
            f"prefill_{prompt_len}": lambda: MDL.prefill(
                eng.params, cfg, prompt,
                MDL.cache_zero(MDL.cache_take_slot(cache, 0)))}


def profile_calls(calls, n=5):
    """Device time by kernel name (torch.profiler) over ``n`` runs of each
    of ``calls``, per call, and the device kernels and copies a call
    launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with torch.inference_mode():
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            kern = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0]
            kern.sort(key=lambda kv: -kv[1])
            total = sum(t for _, t, _c in kern)
            ours = sum(t for k, t, _c in kern if any(
                tag in k for tag in PORT_KERNEL_NAMES))
            out[name] = {"device_ms": total, "port_kernels_ms": ours,
                         "device_kernels": sum(c for _, _t, c in kern),
                         "n_kernel_names": len(kern),
                         "top": [(k[:60], t) for k, t, _c in kern[:6]]}
    return out


@contextlib.contextmanager
def unfused_rglru():
    """The model's RG-LRU scan as it ran before K3's gated route: the
    elementwise tail of ``_gates`` in PyTorch, then the (a, b) route. For
    a same-run "before" of the serving calls; never on a counted path."""
    from repro_torch.models import rglru as R

    rg = ops_modules()["rglru_scan"]
    gated = R.rglru_scan

    def scan(params, cfg, xb, h0=None, *, h_last=None):
        if h0 is None:
            h0 = torch.zeros((xb.shape[0], xb.shape[2]), device=xb.device)
        return rglru_unfused(rg, *R._gate_products(params, cfg, xb), xb,
                             params["log_lambda"], h0, h_last=h_last)

    R.rglru_scan = scan
    try:
        yield
    finally:
        R.rglru_scan = gated


def expected_launches(cfg, n_prefills, n_steps):
    """One launch per layer of each kind per prefill and per decode step;
    K3 takes its gated route only, K4's prefills its chunked route and its
    decode steps the recurrence."""
    from repro_torch.models.model import ATTN_KINDS

    kinds = cfg.layer_kinds()
    attn = sum(k in ATTN_KINDS for k in kinds)
    rwkv = kinds.count("rwkv")
    return {"flash_attention": attn * n_prefills,
            "decode_attention": attn * n_steps,
            "rglru_gated": kinds.count("rglru") * (n_prefills + n_steps),
            "rglru_scan": 0,
            "rwkv6_chunked": rwkv * n_prefills,
            "rwkv6_scan": rwkv * n_steps}


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
            reset_counts()
            reqs, t0 = serve(workers[sid], variant, batch, tag=tag)
            got = read_counts(SERVING + ("rglru_scan",))
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
        calls = serving_calls(MDL, eng_a)
        res["A_steps"] = time_calls(calls)
        log(f"  A {full.name} step breakdown: {json.dumps(res['A_steps'])}")
        res["A_profile"] = profile_calls(calls)
        for call, p in res["A_profile"].items():
            log(f"  A {full.name} {call} by kernel (torch.profiler, ms per "
                f"call): total {p['device_ms']:.3f}, the port's kernels "
                f"{p['port_kernels_ms']:.3f}; device kernels a call "
                f"{p['device_kernels']:.1f} ({p['n_kernel_names']} kernel "
                f"names); top {json.dumps(p['top'])}")
        if "rglru" in fc.layer_kinds():
            # the same calls with the RG-LRU scan unfused, as before K3's
            # gated route, on this card in this run
            with unfused_rglru():
                res["A_steps_unfused"] = time_calls(calls)
                res["A_profile_unfused"] = profile_calls(calls)
            for call, p in res["A_profile_unfused"].items():
                st, su = res["A_steps"], res["A_steps_unfused"]
                log(f"  A {full.name} {call}, the RG-LRU scan unfused: "
                    f"device kernels a call {p['device_kernels']:.1f} "
                    f"(gated: {res['A_profile'][call]['device_kernels']:.1f})"
                    f", profiled device ms {p['device_ms']:.3f} (gated: "
                    f"{res['A_profile'][call]['device_ms']:.3f}), graph "
                    f"device ms {su[f'{call}_device_ms']:.3f} (gated: "
                    f"{st[f'{call}_device_ms']:.3f}), host wall "
                    f"{su[f'{call}_wall_ms']:.3f} ms (gated: "
                    f"{st[f'{call}_wall_ms']:.3f})")

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


def phase_whisper():
    """whisper-medium at full width and depth in bf16 through the model's
    entry points: each of ``SLOTS`` slots gets a 1500-frame encode and a
    64-token prefill, then ``WHISPER_STEPS`` decode steps run over all
    slots; K1/K2 launches held to one per attention a call, the cached
    cross K/V held to ``_cross_kv`` recomputed, then the prefill and the
    decode step timed and profiled."""
    from repro_torch import configs
    from repro_torch.device import generator_for
    from repro_torch.models import encdec
    from repro_torch.models import model as MDL

    cfg = configs.get_config("whisper-medium")
    n_enc, n_dec = cfg.num_encoder_layers, cfg.num_decoder_layers
    if cfg.param_dtype != "bfloat16" or n_enc != 24 or n_dec != 24:
        raise AssertionError(f"{cfg.name} is not at full depth in bf16")
    res = {}
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        params = MDL.init_params(generator_for(DEV, SEED), cfg, device=DEV)
        res["params"] = MDL.param_count(params)
        rng = np.random.default_rng(SEED)
        frames = [torch.from_numpy(rng.standard_normal(
            (1, WHISPER_FRAMES, cfg.d_model)).astype(np.float32)).to(DEV)
            for _ in range(SLOTS)]
        prompts = [torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (1, WHISPER_PROMPT)).astype(np.int32)).to(DEV)
            for _ in range(SLOTS)]
        cache = MDL.init_cache(cfg, SLOTS, MAX_LEN, device=DEV)
        reset_counts()
        first = []
        for s in range(SLOTS):
            sub = MDL.cache_zero(MDL.cache_take_slot(cache, s))
            logits, _ = MDL.prefill(params, cfg, prompts[s], sub, frames[s])
            first.append(int(torch.argmax(logits[0])))
        tok = torch.tensor(first, dtype=torch.int32, device=DEV)
        for _ in range(WHISPER_STEPS):
            logits, _ = MDL.decode_step(params, cfg, tok, cache)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("whisper decode logits not finite")
            tok = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        got = read_counts(("flash_attention", "decode_attention"))
        want = {"flash_attention": SLOTS * (n_enc + 2 * n_dec)
                + WHISPER_STEPS * n_dec,
                "decode_attention": WHISPER_STEPS * n_dec}
        log(f"  {SLOTS} prefills ({WHISPER_FRAMES} frames + "
            f"{WHISPER_PROMPT} tokens) and {WHISPER_STEPS} decode steps "
            f"over {SLOTS} slots: launches {json.dumps(got)}; positions "
            f"{cache['pos'].tolist()}, logits {tuple(logits.shape)} finite")
        if got != want:
            raise AssertionError(f"whisper launches {got}, want {want} (K1 "
                                 "per encoder layer, decoder self and cross "
                                 "attention; K2 per decoder layer a step)")
        if cache["pos"].tolist() != [WHISPER_PROMPT + WHISPER_STEPS] * SLOTS:
            raise AssertionError(f"positions {cache['pos'].tolist()}")
        enc = encdec.encode(params, cfg, frames[SLOTS - 1])
        worst = 0.0
        for i in range(n_dec):
            kx, vx = encdec._cross_kv(encdec._layer(params["dec_layers"], i),
                                      cfg, enc)
            worst = max(worst, err(kx, cache["cross"]["k"][i, SLOTS - 1:]),
                        err(vx, cache["cross"]["v"][i, SLOTS - 1:]))
        res["cross_kv_max_abs_err"] = worst
        log(f"  slot {SLOTS - 1}'s cached cross K/V against _cross_kv "
            f"recomputed, {n_dec} layers: max_abs_err {worst:.3g}")
        if not worst < ATOL["bfloat16"]:
            raise AssertionError(f"cached cross K/V off by {worst}")
        sub = MDL.cache_take_slot(cache, 0)
        calls = {
            f"encode_prefill_{WHISPER_PROMPT}": lambda: MDL.prefill(
                params, cfg, prompts[0], MDL.cache_zero(sub), frames[0]),
            "decode_step": lambda: MDL.decode_step(params, cfg, tok, cache)}
    res["steps"] = time_calls(calls)
    res["profile"] = profile_calls(calls)
    for name in calls:
        wall = res["steps"][f"{name}_wall_ms"]
        devt = res["steps"][f"{name}_device_ms"]
        p = res["profile"][name]
        log(f"  {name} on whisper-medium:full: host wall {wall:.3f} ms, "
            f"device {devt:.3f} ms, device idle share "
            f"{1 - devt / wall:.3f}, device kernels a call "
            f"{p['device_kernels']:.1f}; the port's kernels "
            f"{p['port_kernels_ms']:.3f} of {p['device_ms']:.3f} profiled "
            f"ms; top {json.dumps(p['top'])}")
    res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  {res['params']} params; max_memory_allocated "
        f"{res['max_memory_allocated_bytes'] / 2**30:.3f} GiB")
    del params, cache, calls, sub
    gc.collect()
    torch.cuda.empty_cache()
    return res, got


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


def planner_instance(rng, tc, tv, slo=math.inf):
    """A random planning round on 100 servers in 4 sites: 20-300 apps of
    2-6 variants (each with latency SLO ``slo``), pre-placed primaries, a
    few dead servers, server and site exclusions, an alpha."""
    cluster = tc.make_cluster(4, 25, mem=rng.uniform(4e9, 16e9),
                              compute=rng.uniform(0.5, 2.0))
    apps = [tv.Application(
        id=f"a{i}", family=f"f{i}",
        variants=tv.synthetic_family(f"f{i}", rng.uniform(0.3e9, 6e9),
                                     n_variants=rng.randint(2, 6),
                                     spread=rng.uniform(1.5, 12.0)),
        request_rate=rng.uniform(0.2, 3.0), critical=rng.random() < 0.5,
        latency_slo=slo) for i in range(rng.randint(20, 300))]
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


def round_against_plain(inputs, lat=None):
    """The round kernel on copies of a round's inputs against its plain
    version (``place_chunk`` + ``upgrade_chunk``) on CPU copies, both
    gated by the latency mask ``lat`` when one is given: the (variant,
    server, upgrade) result and free/head/budget afterwards must be
    bit-equal. Returns the kernel's result and free/head/budget."""
    from repro_torch.core.planner.kernels import plan_round_plain
    from repro_torch.kernels.planner_argmax import ops as k5

    card = [t.clone() for t in inputs.args()]
    cpu = [t.to("cpu", copy=True) for t in inputs.args()]
    out = k5.plan_round(*card, lat=lat)
    want = plan_round_plain(*cpu, lat=None if lat is None else lat.cpu())
    for name, a, b in zip(("(variant, server, upgrade)", "free", "head",
                           "budget"), (out, *card[:3]), (want, *cpu[:3])):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"the round kernel's {name} differs from "
                                 "place_chunk + upgrade_chunk")
    return out, card[:3]


def phase_planner():
    """On each random instance, the round kernel bit-equal to its plain
    version, and plan_greedy_torch on the card against the port's numpy
    planner: assignments, their order, the unplaced list and the objective
    bits."""
    import random

    from repro_torch.core import cluster as tc
    from repro_torch.core import variants as tv
    from repro_torch.core.planner import PlannerState, plan_greedy
    from repro_torch.core.planner.torch_backend import (TorchPlanContext,
                                                        plan_greedy_torch,
                                                        prepare_round)

    # one context for every instance, though each reuses the ids a0, a1,
    # ... with other ladders: its demand cache must follow the new apps
    ctx = TorchPlanContext()
    n_apps = n_placed = 0
    for dtype in ("float64", "float32"):
        for seed in range(PLANNER_INSTANCES):
            cluster, apps, kw = planner_instance(random.Random(seed), tc, tv)
            r_np = plan_greedy(apps, cluster, state=PlannerState(
                cluster, subscribe=False, dtype=dtype), **kw)
            st = PlannerState(cluster, subscribe=False, dtype=dtype)
            st.sync()
            round_against_plain(prepare_round(
                apps, cluster, st, kw["exclude"], kw["site_exclude"],
                kw["alpha"], ctx)[3])
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
    log(f"  the round kernel equals place_chunk + upgrade_chunk (results "
        f"and free/head/budget bits), and plan_greedy_torch on the card "
        f"equals numpy, on {2 * PLANNER_INSTANCES} instances (float64 and "
        f"float32, {n_apps} apps, {n_placed} placed): assignments, order, "
        f"unplaced, objective bits")


def sim_config(backend, planner="greedy", coordinators=0):
    from repro_torch.core.simulation import SimConfig

    c = SIM_CELL
    return SimConfig(
        n_sites=c["n_servers"] // c["per_site"],
        servers_per_site=c["per_site"],
        server_mem=c["n_apps"] * AVG_FULL_MEM / (c["n_servers"]
                                                 * PRIMARY_UTIL),
        headroom=0.2, seed=SEED, planner=planner, planner_dtype="float64",
        planner_backend=backend, planner_coordinators=coordinators,
        traffic_rate_scale=c["rate_scale"],
        traffic_chunk_s=c["chunk_s"], event_mode="epoch")


def device_kernels(fn, n):
    """torch.profiler over ``n`` calls of ``fn``: [(kernel or copy name,
    device ms per call, count per call)], longest first. A session that
    recorded no device work at all is run again, up to three times (the
    tracer has once come back empty after a short window); then []."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kern = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if kern:
            return sorted(kern, key=lambda x: -x[1])
    return []


def profile_round(planner, req, n=3, n_prof=10):
    """One failover round's planning, replayed from its request before the
    round itself runs (a round is a pure function of the state it reads),
    in a run of its own whose plan walls are not reported: a first replay
    that also syncs the failed servers' rows into the device mirror, then
    the host wall of unprofiled replays ending in their host reads, and
    the device busy time per replay of ``n_prof`` profiled ones."""
    from repro_torch.core.planner.torch_backend import (plan_greedy_torch,
                                                        prepare_round)

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
    kern = device_kernels(replay, n_prof)
    wall = statistics.median(walls)
    if not kern:
        log("  torch.profiler recorded no device work in three sessions of "
            "the replayed round: its device busy time, idle share and "
            "kernels are not measured")
    busy = sum(t for _, t, _c in kern) if kern else float("nan")
    n_kernels = sum(c for _, _t, c in kern) if kern else float("nan")
    req.state.sync()
    inputs = prepare_round(req.apps, req.cluster, req.state, exclude,
                           site_exclude, req.alpha, planner._ctx)[3]
    return {"n_apps": len(req.apps), "wall_ms": wall,
            "device_kernels": n_kernels,
            "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "k5_device_ms": sum(t for k, t, _c in kern
                                if any(n in k for n in K5_KERNEL_NAMES)),
            "top": [(k[:50], t) for k, t, _c in kern[:5]], "inputs": inputs}


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
        n0, r0 = k5.LAUNCHES, k5.ROUND_LAUNCHES
        res = plan(req)
        rounds.append({"n_apps": len(req.apps), "wall_s": res.wall_s,
                       "round_launches": k5.ROUND_LAUNCHES - r0,
                       "argmax_launches": (k5.LAUNCHES - n0)
                       - (k5.ROUND_LAUNCHES - r0),
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
    reset_counts()
    runs = {"torch": run_sim("torch", k5)}
    launches = read_counts(("planner_round", "planner_argmax"))
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
    n_round = launches["planner_round"]
    if not t["torch_rounds"] or not n_round:
        raise AssertionError("the torch run planned no round on the card")
    planned = [r for r in runs["torch"][2] if r["n_apps"]]
    if any(r["round_launches"] != 1 or r["argmax_launches"]
           for r in planned) or launches["planner_argmax"]:
        raise AssertionError("a round on the card was not one launch of "
                             f"the round kernel: {launches}")
    t["k5_launches"] = launches
    log(f"  records, placement and traffic summary equal between torch and "
        f"numpy ({t['n_records']} records, recovery rate "
        f"{t['recovery_rate']}); round kernel launches on the torch run "
        f"{n_round} in {t['torch_rounds']} rounds "
        f"({n_round / t['torch_rounds']:.1f} per round; one in each of the "
        f"{len(planned)} rounds with apps), standalone argmax launches "
        f"{launches['planner_argmax']}")
    for name in ("torch", "numpy"):
        o = out[name]
        log(f"  {name}: plan_wall_s {o['plan_wall_s']:.6f}, peak failover "
            f"plan phase {o['plan_peak_s']:.6f} s, setup {o['setup_s']:.3f} "
            f"s, scenario {o['run_s']:.3f} s")
    inputs = prof.pop("inputs")
    t["profiled_failover_round"] = p = prof
    log(f"  one failover round on the card, replayed in a third run "
        f"({p['n_apps']} apps): host wall "
        f"{p['wall_ms']:.3f} ms, device busy {p['device_busy_ms']:.3f} ms, "
        f"device idle share {p['idle_share']:.4f}; {p['device_kernels']} "
        f"device kernels and copies per replay "
        f"({p['device_kernels'] / p['n_apps']:.3f} per app); K5 device "
        f"{p['k5_device_ms']:.3f} ms; top "
        f"{json.dumps(p['top'])}")
    row, argmax_launches = round_row(inputs)
    return (out, launches["planner_round"], row, argmax_launches, inputs,
            sim_records(*runs["torch"][:2]))


def round_row(inputs):
    """The replayed failover round on the round kernel, bit-equal to its
    plain version on the CPU and on the card, timed beside the plain
    version on the card and the bound. The plain run on the card is the
    standalone argmax's counted path (one launch per app). Returns (row,
    standalone argmax launches)."""
    from repro_torch.core.planner.kernels import plan_round_plain
    from repro_torch.kernels.planner_argmax import ops as k5

    out, state = round_against_plain(inputs)
    args = inputs.args()
    work = [t.clone() for t in args]

    def restore():
        for w, a in zip(work[:3], args[:3]):
            w.copy_(a)

    def kernel():
        restore()
        k5.plan_round(*work)

    plain_args = [t.clone() for t in args]
    reset_counts()
    plain_out = plan_round_plain(*plain_args)
    torch.cuda.synchronize()
    launches = read_counts(("planner_argmax",))["planner_argmax"]
    if not torch.equal(plain_out, out) or not all(
            torch.equal(a, b) for a, b in zip(plain_args[:3], state)):
        raise AssertionError("the plain round on the card differs from the "
                             "round kernel")

    def plain():
        restore()
        plan_round_plain(*work)

    ms = graph_ms(kernel, reps=5, n=10) - graph_ms(restore, reps=5, n=10)
    plain_ms = eager_ms(plain, n=3, warmup=1)
    # each input read once, each output written once; the comparisons the
    # sequential algorithm needs for this round's data: every variant an
    # app tries up to the one placed (all of them when unplaced), over the
    # alive servers, R thresholds and one headroom compare each, and the
    # upgrade tests
    A, V, R = inputs.dm.shape
    S_alive = int(inputs.alive.sum())
    jr = out[0].cpu().numpy()
    nv = (inputs.stop - inputs.start).cpu().numpy()
    tried = np.where(jr < nv, jr + 1, nv)
    jc = (inputs.start.cpu().numpy() + jr)[jr < nv]
    ops = int(tried.sum()) * S_alive * (R + 1) + int(jc.sum()) * 2 * R
    n_bytes = nbytes(*args) + nbytes(*args[:3]) + out.numel() * 4
    b_ms, b_by = bound(n_bytes, ops, PEAK_FP32_FLOPS)
    row = dict(shape=f"{A} apps x {V} variant columns x {R} resources over "
               f"{inputs.free.shape[0]} servers ({S_alive} alive), "
               f"{str(inputs.free.dtype)[6:]} state", max_abs_err=0.0,
               ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, peak="fp32 non-tensor", n_apps=A,
               per_app_us=ms * 1e3 / A, eager_ms=eager_ms(kernel, n=5))
    log(f"  planner_round failover round [{row['shape']}]: device ms kernel "
        f"{ms:.5f} ({row['per_app_us']:.3f} us per app in the chain), "
        f"plain (place_chunk + upgrade_chunk on the card, eager) "
        f"{plain_ms:.5f}, library none, bound {b_ms:.6f} ({b_by}); eager "
        f"call {row['eager_ms']:.5f} ms; standalone argmax launches of the "
        f"plain run {launches}; bit-equal to the plain run on the CPU and "
        f"on the card")
    return row, launches


# ---------------------------------------------------------------------------
# Phase 7: the rest of the planning and protection plane on the card
# ---------------------------------------------------------------------------

# (a): the apps' latency SLO (a tenth of it for every fifth app);
# `slo_latency` puts about half the (variant, server) pairs over it
LATENCY_SLO = 0.02
# the unmasked failover round's device ms on this card before the round
# kernel took a latency mask (PERF.md, kernel table)
BEFORE_MASK_ROUND_MS = 1.48168
# (c): tools/bench_mttr.py's (policy, planner, scheduler) CELLS at its
# --smoke shape (tools/bench_mttr.py:29-35, :116-117, :57-61)
MTTR_CELLS = [("faillite", None, "fifo"), ("faillite", None, "criticality"),
              ("faillite", "locality", "fifo"),
              ("faillite", "locality", "criticality"),
              ("full-cold", None, "fifo")]
MTTR_SPEC = dict(scenario="cold-load-storm", storage="edge", seed=SEED,
                 n_sites=3, servers_per_site=4, headroom=0.2)
MTTR_PHASES = ("detect", "plan", "queue", "fetch", "warmup", "route")
# (d): tools/bench_shardfail.py's --smoke cells (:124-127, :45-48)
SHARD_POLICIES = ("degrade", "reshard", "monolith")
SHARD_SPEC = dict(scenario="tp-shard-storm", seed=SEED, n_sites=3,
                  servers_per_site=4, headroom=0.25, storage="edge",
                  tp_degree=2)
# (e): tests/test_autopilot.py:208's chaos run
AUTOPILOT_CFG = dict(n_sites=3, servers_per_site=4, headroom=0.2,
                     policy="faillite", seed=SEED, autopilot=True,
                     traffic_diurnal_amplitude=0.5,
                     traffic_diurnal_period=120.0)
# (f): benchmarks/ilp_vs_heuristic.py's quick sizes (servers, apps)
ILP_SIZES = ((6, 8), (8, 12))


@functools.lru_cache(maxsize=None)
def _crc(text):
    return zlib.crc32(text.encode())


def slo_latency(app, variant, server):
    """A synthetic serving latency in seconds: over LATENCY_SLO on about
    half the (variant, server) pairs, NaN (which numpy counts as
    allowed) on one pair in seven; the same in every process."""
    h = (_crc(variant.name) * 31 + _crc(server.id)) % 97
    return math.nan if h % 7 == 3 else 0.04 * h / 97.0


def same_plan(a, b):
    """Assignments, their order, the unplaced list and the objective
    bits of two plans."""
    def key(r):
        return ([(k, v.name, s) for k, (v, s) in r.assignment.items()],
                list(getattr(r, "unplaced", ())), float(r.objective).hex())
    return key(a) == key(b)


def k5_counts():
    return read_counts(("planner_round", "planner_round_masked",
                        "planner_argmax"))


def phase_latency(failover_inputs):
    """(a) On random instances per state dtype with a latency_fn, the
    round kernel with the mask bit-equal to its plain version on the CPU,
    and the greedy planner on the card (one masked round launch a plan)
    equal to numpy's plan_greedy(latency_fn=...); then phase 5's failover
    round timed with an all-true mask and without one. Returns (row,
    masked launches of the planner calls)."""
    import random

    from repro_torch.core import cluster as tc
    from repro_torch.core import variants as tv
    from repro_torch.core.planner import (PlannerState, PlanRequest,
                                          get_planner, plan_greedy)
    from repro_torch.core.planner.torch_backend import (TorchPlanContext,
                                                        prepare_round)

    planner = get_planner("greedy")            # torch, on the card
    ctx = TorchPlanContext()
    masked = 0
    n_apps = n_placed = n_changed = 0
    allowed, pairs = 0, 0
    for dtype in ("float64", "float32"):
        for seed in range(PLANNER_INSTANCES):
            cluster, apps, kw = planner_instance(random.Random(1000 + seed),
                                                 tc, tv, slo=LATENCY_SLO)
            for a in apps[::5]:        # a tighter SLO: some go unplaced
                a.latency_slo = LATENCY_SLO / 10
            st = PlannerState(cluster, subscribe=False, dtype=dtype)
            st.sync()
            inputs = prepare_round(apps, cluster, st, kw["exclude"],
                                   kw["site_exclude"], kw["alpha"], ctx,
                                   slo_latency)[3]
            round_against_plain(inputs, lat=inputs.lat)
            live = inputs.lat[:, :, inputs.alive]
            allowed += int(live.sum())
            pairs += sum(len(a.variants) for a in apps) * live.shape[2]
            req = PlanRequest(apps=apps, cluster=cluster,
                              state=PlannerState(cluster, subscribe=False,
                                                 dtype=dtype),
                              latency_fn=slo_latency, **kw)
            reset_counts()
            r_t = planner.plan(req)
            n = k5_counts()
            if n != {"planner_round": 0, "planner_round_masked": 1,
                     "planner_argmax": 0}:
                raise AssertionError(f"a latency plan on the card was not "
                                     f"one masked round launch: {n}")
            masked += n["planner_round_masked"]
            state_np = PlannerState(cluster, subscribe=False, dtype=dtype)
            r_np = plan_greedy(apps, cluster, state=state_np,
                               latency_fn=slo_latency, **kw)
            if not same_plan(r_t, r_np):
                raise AssertionError(f"the latency plan {dtype} seed "
                                     f"{seed} differs from numpy's")
            free_plan = plan_greedy(apps, cluster, state=PlannerState(
                cluster, subscribe=False, dtype=dtype), **kw)
            n_changed += not same_plan(free_plan, r_np)
            n_apps += len(apps)
            n_placed += len(r_np.assignment)
    if not n_changed:
        raise AssertionError("the latency mask changed no plan")
    log(f"  (a) the round kernel with a latency mask equals place_chunk + "
        f"upgrade_chunk with it (results and free/head/budget bits), and "
        f"the greedy planner on the card equals numpy's plan_greedy("
        f"latency_fn=...) on {2 * PLANNER_INSTANCES} instances (float64 "
        f"and float32, {n_apps} apps, {n_placed} placed, "
        f"{allowed / pairs:.3f} of the (variant, alive server) pairs "
        f"within the SLO, {n_changed} plans changed by the mask): "
        f"assignments, order, unplaced, objective bits; masked round "
        f"launches {masked}, one a plan")
    return masked_round_row(failover_inputs), masked


def masked_round_row(inputs):
    """Phase 5's failover round with an all-true latency mask: bit-equal
    to the round without one and to the plain version on the CPU; both
    timed in one call, alternating, beside the time before the mask
    existed (``BEFORE_MASK_ROUND_MS``), the plain version
    on the card and the bound."""
    from repro_torch.core.planner.kernels import plan_round_plain
    from repro_torch.kernels.planner_argmax import ops as k5

    args = inputs.args()
    A, V, R = inputs.dm.shape
    S = inputs.free.shape[0]
    lat = torch.ones((A, V, S), dtype=torch.uint8, device=DEV)
    out, state = round_against_plain(inputs, lat=lat)
    bare, bare_state = round_against_plain(inputs)
    if not (torch.equal(out, bare) and all(
            torch.equal(a, b) for a, b in zip(state, bare_state))):
        raise AssertionError("an all-true mask changed the failover round")
    work = [t.clone() for t in args]

    def restore():
        for w, a in zip(work[:3], args[:3]):
            w.copy_(a)

    def kernel(mask):
        restore()
        k5.plan_round(*work, lat=mask)

    t_restore = graph_ms(restore, reps=5, n=10)
    times = {"none": [], "all-true": []}
    for _ in range(3):
        for tag, mask in (("none", None), ("all-true", lat)):
            times[tag].append(graph_ms(functools.partial(kernel, mask),
                                       reps=5, n=10) - t_restore)
    ms = {tag: statistics.median(v) for tag, v in times.items()}

    def plain():
        restore()
        plan_round_plain(*work, lat=lat)

    plain_ms = eager_ms(plain, n=3, warmup=1)
    # the round's work as round_row counts it, plus the mask bytes and
    # compares this run's data needs: one byte per tried (variant, alive
    # server) and per upgrade candidate
    S_alive = int(inputs.alive.sum())
    jr = out[0].cpu().numpy()
    nv = (inputs.stop - inputs.start).cpu().numpy()
    tried = int(np.where(jr < nv, jr + 1, nv).sum())
    n_up = int((inputs.start.cpu().numpy() + jr)[jr < nv].sum())
    mask_bytes = tried * S_alive + n_up
    ops = tried * S_alive * (R + 2) + n_up * (2 * R + 1)
    n_bytes = (nbytes(*args) + nbytes(*args[:3]) + out.numel() * 4
               + mask_bytes)
    b_ms, b_by = bound(n_bytes, ops, PEAK_FP32_FLOPS)
    row = dict(shape=f"{A} apps x {V} variant columns x {R} resources over "
               f"{S} servers ({S_alive} alive), "
               f"{str(inputs.free.dtype)[6:]} state, mask (A, V, S) uint8 "
               f"all set", max_abs_err=0.0, ms=ms["all-true"],
               plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, peak="fp32 non-tensor", n_apps=A,
               per_app_us=ms["all-true"] * 1e3 / A,
               unmasked_ms=ms["none"], mask_bytes_read=mask_bytes,
               times=times)
    log(f"  (a) failover round [{row['shape']}]: device ms with the mask "
        f"{ms['all-true']:.5f}, without {ms['none']:.5f} (alternating, "
        f"3 each: {json.dumps(times)}), before the mask existed "
        f"{BEFORE_MASK_ROUND_MS}; "
        f"plain with the mask (on the card, eager) {plain_ms:.5f}; bound "
        f"{b_ms:.6f} ({b_by}, {mask_bytes} mask bytes read); bit-equal to "
        f"the round without a mask and to the plain version on the CPU")
    return row


def phase_sharded(greedy_records):
    """(b) phase 5's 1000-server x 10,000-app site-outage cell with the
    sharded planner, on the torch backend and on numpy with 4
    coordinators: records, placements and traffic summary equal to phase
    5's greedy torch run. Returns the torch run's round launches."""
    from repro_torch.core.simulation import Simulation

    out = {}
    for label, backend, coordinators in (("torch", "torch", 0),
                                         ("numpy, 4 coordinators", "numpy",
                                          4)):
        reset_counts()
        t0 = time.perf_counter()
        sim = Simulation(sim_config(backend, "sharded", coordinators))
        sim.setup()
        res = sim.run_named_scenario(SIM_CELL["scenario"])
        wall = time.perf_counter() - t0
        n = k5_counts()
        stats = sim.controller.planner_stats()
        if sim_records(sim, res) != greedy_records:
            raise AssertionError(f"sharded ({label}) differs from greedy on "
                                 "the site-outage cell")
        ran = stats["torch_rounds"] if backend == "torch" \
            else stats["sharded_rounds"]
        want_k5 = stats["torch_rounds"] if backend == "torch" else 0
        if not ran or n["planner_round"] != want_k5 or \
                n["planner_argmax"] or n["planner_round_masked"]:
            raise AssertionError(f"sharded ({label}): rounds {stats}, K5 "
                                 f"launches {n}")
        out[label] = {"plan_wall_s": sim.controller.plan_wall_s,
                      "wall_s": wall, "stats": stats, "launches": n}
        log(f"  (b) sharded ({label}): plan wall "
            f"{sim.controller.plan_wall_s:.6f} s, setup + scenario "
            f"{wall:.3f} s, {json.dumps(stats)}, K5 launches "
            f"{json.dumps(n)}; records, placements and traffic summary "
            f"equal to phase 5's greedy torch run")
        del sim, res
        gc.collect()
    return out["torch"]["launches"]["planner_round"]


def run_on_both(make_spec, label):
    """One spec through run_experiment on the torch planner backend and on
    numpy: equal fingerprints; the torch run's K5 launches (counters
    zeroed just before it, read just after) one round kernel launch per
    round with apps wherever the torch planner planned, no argmax."""
    from repro_torch.experiment import run_experiment

    res = {}
    for backend in ("torch", "numpy"):
        reset_counts()
        res[backend] = run_experiment(make_spec(backend))
        if backend == "torch":
            n = k5_counts()
    if res["torch"].fingerprint() != res["numpy"].fingerprint():
        raise AssertionError(f"{label}: torch and numpy fingerprints differ")
    stats = res["torch"].extras["planner"]
    if n["planner_argmax"] or n["planner_round_masked"] or (
            stats.get("torch_rounds") and not n["planner_round"]):
        raise AssertionError(f"{label}: planner {stats}, K5 launches {n}")
    return res["torch"], n


def mttr_summary(res):
    """tools/bench_mttr.py's run_cell on one seed's RunResult."""
    records = list(res.records)
    recovered = [r for r in records if r.recovered]
    cold = [r for r in recovered if r.mode.startswith("cold")]
    downs = np.asarray([w.client_downtime for w in res.traffic.windows
                        if w.recovered and math.isfinite(w.client_downtime)],
                       dtype=float)
    phase_ms = {}
    for ph in MTTR_PHASES:
        vals = [r.phases.get(ph, 0.0) for r in cold if r.phases]
        phase_ms[ph] = 1e3 * sum(vals) / len(vals) if vals else 0.0
    return {"n": len(records),
            "recovery_rate": len(recovered) / max(len(records), 1),
            "ctl_mttr_ms": 1e3 * sum(r.mttr for r in recovered)
            / max(len(recovered), 1),
            "client_p50_ms": float(np.percentile(downs, 50)) * 1e3
            if downs.size else -1.0,
            "client_p99_ms": float(np.percentile(downs, 99)) * 1e3
            if downs.size else -1.0,
            "phase_ms": phase_ms}


def phase_mttr():
    """(c) tools/bench_mttr.py's five cells at its --smoke shape on both
    planner backends. Returns the torch runs' round launches."""
    from repro_torch.experiment import ExperimentSpec

    total = 0
    for policy, planner, scheduler in MTTR_CELLS:
        def spec(backend):
            return ExperimentSpec(policy=policy, planner=planner,
                                  scheduler=scheduler,
                                  planner_backend=backend, **MTTR_SPEC)
        label = f"{policy}/{planner or 'greedy'}/{scheduler}"
        res, n = run_on_both(spec, label)
        total += n["planner_round"]
        log(f"  (c) {label}: torch == numpy fingerprint; "
            f"{json.dumps(mttr_summary(res))}; planner "
            f"{json.dumps(res.extras['planner'])}; K5 round launches "
            f"{n['planner_round']}")
    return total


def phase_shardfail():
    """(d) tools/bench_shardfail.py's --smoke cells (tp_degree 2) on both
    planner backends. Returns the torch runs' round launches."""
    from repro_torch.experiment import ExperimentSpec

    total = 0
    for policy in SHARD_POLICIES:
        res, n = run_on_both(
            lambda backend: ExperimentSpec(shard_policy=policy,
                                           planner_backend=backend,
                                           **SHARD_SPEC), policy)
        total += n["planner_round"]
        t = res.traffic
        log(f"  (d) tp-shard-storm tp 2 {policy}: torch == numpy "
            f"fingerprint; client MTTR {t.client_mttr_avg * 1e3:.3f} ms, "
            f"availability {t.availability:.6f}, ladder actions "
            f"{json.dumps(res.extras['shard'].get('actions', {}))}; K5 "
            f"round launches {n['planner_round']}")
    return total


def phase_autopilot():
    """(e) the chaos run with the autopilot on both planner backends:
    equal fingerprints, promotions and demotions. Returns the torch run's
    round launches."""
    from repro_torch.core.simulation import SimConfig, Simulation

    fps, moves = {}, {}
    for backend in ("torch", "numpy"):
        sim = Simulation(SimConfig(planner_backend=backend, **AUTOPILOT_CFG))
        pilot = sim.controller.autopilot
        decide, tally = pilot.decide, {"promote": 0, "demote": 0,
                                       "sweeps": 0}

        def counted(view, decide=decide, tally=tally):
            dec = decide(view)
            tally["promote"] += len(dec.promote)
            tally["demote"] += len(dec.demote)
            tally["sweeps"] += 1
            return dec

        pilot.decide = counted
        reset_counts()
        sim.setup()
        fps[backend] = sim.run_named_scenario("chaos").fingerprint()
        if backend == "torch":
            n = k5_counts()
            stats = sim.controller.planner_stats()
        moves[backend] = tally
    if fps["torch"] != fps["numpy"] or moves["torch"] != moves["numpy"]:
        raise AssertionError(f"autopilot: torch and numpy differ {moves}")
    if not stats["torch_rounds"] or not n["planner_round"] or \
            n["planner_argmax"] or n["planner_round_masked"]:
        raise AssertionError(f"autopilot: planner {stats}, K5 {n}")
    log(f"  (e) chaos with the autopilot: torch == numpy fingerprint; "
        f"{moves['torch']['sweeps']} sweeps, "
        f"{moves['torch']['promote']} promotions, "
        f"{moves['torch']['demote']} demotions; K5 round launches "
        f"{n['planner_round']} in {stats['torch_rounds']} rounds")
    return n["planner_round"]


def phase_ilp():
    """(f) benchmarks/ilp_vs_heuristic.py's instances: the exact
    branch-and-bound (numpy and scipy, on the host) against the greedy
    planner on the card; the ILP's objective must be at least greedy's."""
    import random

    from repro_torch.core.cluster import make_cluster
    from repro_torch.core.planner import PlanRequest, get_planner
    from repro_torch.core.variants import Application, synthetic_family

    ilp = get_planner("ilp", node_limit=300, time_limit_s=20.0)
    greedy = get_planner("greedy")
    for n_servers, n_apps in ILP_SIZES:
        rng = random.Random(42)
        cluster = make_cluster(2, n_servers // 2, mem=12e9)
        apps = [Application(id=f"a{i}", family=f"f{i}",
                            variants=synthetic_family(
                                f"f{i}", rng.uniform(1e9, 5e9),
                                n_variants=4, spread=6.0),
                            critical=True,
                            request_rate=rng.uniform(0.5, 2.0))
                for i in range(n_apps)]
        primaries = {}
        servers = cluster.alive_servers()
        for i, a in enumerate(apps):
            sid = servers[i % len(servers)].id
            cluster.place(a.id, a.variants[-1], sid, "primary")
            primaries[a.id] = sid
        req = PlanRequest(apps=apps, cluster=cluster, primaries=primaries,
                          alpha=0.1)
        t0 = time.perf_counter()
        res = ilp.plan(req)
        t_ilp = time.perf_counter() - t0
        heur = greedy.plan(req)
        if res.objective < heur.objective - 1e-6:
            raise AssertionError(f"ilp {res.objective} < greedy "
                                 f"{heur.objective} at {n_servers} x "
                                 f"{n_apps}")
        log(f"  (f) ilp {n_servers} servers x {n_apps} apps: objective "
            f"{res.objective:.6f} (optimal {res.optimal}, {res.nodes} "
            f"nodes, wall {t_ilp:.3f} s) >= greedy on the card "
            f"{heur.objective:.6f}")


def phase_plane(failover_inputs, greedy_records):
    """Phase 7, (a)-(f). Returns the masked round's row and the round
    kernel's launches by path."""
    row, masked = phase_latency(failover_inputs)
    paths = {"planner_round": {
        "sim site-outage sharded torch (phase 7b)":
            phase_sharded(greedy_records),
        "bench_mttr smoke cells (phase 7c)": phase_mttr(),
        "bench_shardfail smoke cells (phase 7d)": phase_shardfail(),
        "chaos with the autopilot (phase 7e)": phase_autopilot()},
        "planner_round_masked": {
            "greedy planner with a latency_fn (phase 7a)": masked}}
    phase_ilp()
    return row, paths


# ---------------------------------------------------------------------------
# Phase 8: training on the card (K1, K3's gated route and K4, forward and
# backward kernels)
# ---------------------------------------------------------------------------

# (a): K1's backward against its plain version; each arch's heads, KV
# heads, head_dim and window from its published config
# (tag, arch or None, (B, Sq, Skv, H, KVH, hd, causal, window), dtypes);
# H/KVH/hd/window are filled from the arch's config where it is named
TRAIN_BWD_ROWS = (
    ("qwen2.5-3b full S=256", "qwen2.5-3b", (2, 256, 256, True),
     ("float32", "bfloat16")),
    ("gemma3-27b S=2100 window 1024", "gemma3-27b", (1, 2100, 2100, True),
     ("float32",)),
    ("whisper-medium encoder 1500x1500", "whisper-medium",
     (1, 1500, 1500, False), ("float32",)),
    ("whisper-medium cross 64x1500", "whisper-medium", (1, 64, 1500, False),
     ("float32",)),
    ("arctic-480b S=256 (G = 7)", "arctic-480b", (1, 256, 256, True),
     ("float32",)),
    ("recurrentgemma-2b local S=2100 (hd 256, window 2048)",
     "recurrentgemma-2b", (1, 2100, 2100, True), ("float32",)),
)
# the rows' backward device ms before the tensor-core redesign (the
# scalar kernel; PERF.md §6, on an H100 80GB HBM3 at 700 W)
BWD_BEFORE_MS = {
    "qwen2.5-3b full S=256 float32": 0.85909,
    "qwen2.5-3b full S=256 bfloat16": 0.86044,
    "gemma3-27b S=2100 window 1024 float32": 5.22133,
    "whisper-medium encoder 1500x1500 float32": 1.61975,
    "whisper-medium cross 64x1500 float32": 0.33814,
    "arctic-480b S=256 (G = 7) float32": 0.85630,
    "recurrentgemma-2b local S=2100 (hd 256, window 2048) float32": 15.35979,
}
# tolerance of the gradients, relative to the largest |reference|
BWD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# operations of the backward per (query, key) pair a head and head_dim
# element: S recomputed, dP, dV, dK, dQ, two each (the forward's 4 x 2.5)
BWD_FLOPS = 10
# (a), the recurrent backward kernels at their archs' published widths:
# K3's gated route (B, S, W) and K4 (B, NH, S, hs), f32 and bf16 each
REC_BWD_ROWS = {
    "rglru_gated_bwd": (("recurrentgemma-2b full B=1 S=256", (1, 256, 2560)),
                        ("recurrentgemma-2b full B=2 S=256", (2, 256, 2560)),
                        ("recurrentgemma-2b full B=1 S=2100",
                         (1, 2100, 2560))),
    "wkv6_bwd": (("rwkv6-3b full B=1 S=256", (1, 40, 256, 64)),
                 ("rwkv6-3b full B=2 S=256", (2, 40, 256, 64)),
                 ("rwkv6-3b full B=1 S=33", (1, 40, 33, 64))),
}
# K4's lw spread down to -20 in (a)'s rows: rwkv6-3b's decays have no clamp
REC_BWD_LW_MIN = -20.0
# dlw's tolerance, relative to its largest |reference|: its intra-chunk
# pairs cancel (tests/test_torch_recbwd.py measures the plain backward
# against jax.vjp)
DLW_RTOL = 1e-3
# the rows' backward device ms before this design (the scalar K4 and the
# two-pass K3; PERF.md §6's "before ms", on an H100 80GB HBM3 at 700 W)
REC_BWD_BEFORE_MS = {
    "recurrentgemma-2b full B=1 S=256 float32": 0.01914,
    "recurrentgemma-2b full B=1 S=256 bfloat16": 0.02043,
    "recurrentgemma-2b full B=2 S=256 float32": 0.03739,
    "recurrentgemma-2b full B=2 S=256 bfloat16": 0.03060,
    "recurrentgemma-2b full B=1 S=2100 float32": 0.14931,
    "recurrentgemma-2b full B=1 S=2100 bfloat16": 0.17422,
    "rwkv6-3b full B=1 S=256 float32": 0.16623,
    "rwkv6-3b full B=1 S=256 bfloat16": 0.16171,
    "rwkv6-3b full B=2 S=256 float32": 0.28850,
    "rwkv6-3b full B=2 S=256 bfloat16": 0.28484,
    "rwkv6-3b full B=1 S=33 float32": 0.06132,
    "rwkv6-3b full B=1 S=33 bfloat16": 0.06130,
}
# the rate each recurrent backward's operations run at: K3's in scalar
# fp32, K4's products as 3xTF32 on the tensor cores
REC_BWD_PEAK = {"rglru_gated_bwd": PEAK_FP32_FLOPS,
                "wkv6_bwd": PEAK_TF32X3_FLOPS}
# operations a (row, step, channel) of K3's gated backward: the gates
# recomputed (two sigmoids, two exps, a sqrt: ~15), the adjoint and the
# chain through the gates (~20)
RGLRU_BWD_FLOPS = 35
# operations a (row, head, step) of K4's backward, in units of hs^2: the
# recurrence's reverse, with the state's adjoint dS_{t-1} = w dS_t +
# r^T dy (3), dr = S_{t-1} dy (2), dk = dS_t v (2), dv = dS_t^T k (2),
# dlw = w (S_{t-1} . dS_t) (2) and the state recomputed (3)
WKV_BWD_FLOPS = 14
# (b): a smoke train step's batch, as tests/test_archs.py's
TRAIN_SMOKE_B, TRAIN_SMOKE_S = 2, 24
# (a), the launch plan: K1's backward under both of plan_bwd's plans for
# the dK/dV pass, at shapes on both sides of its split rule (each tag
# ends in the unsplit grid's blocks), causal: (tag, (B, S, H, KVH, hd,
# window), dtypes)
BWD_PLAN_ROWS = (
    ("qwen2.5-3b heads B=2 S=256 (16)", (2, 256, 16, 2, 128, 0),
     ("float32", "bfloat16")),
    ("qwen2.5-3b heads B=4 S=1024 (128)", (4, 1024, 16, 2, 128, 0),
     ("float32", "bfloat16")),
    ("qwen2.5-3b heads B=5 S=1024 (160)", (5, 1024, 16, 2, 128, 0),
     ("float32", "bfloat16")),
    ("qwen2.5-3b heads B=6 S=1024 (192)", (6, 1024, 16, 2, 128, 0),
     ("float32", "bfloat16")),
    ("qwen2.5-3b heads B=7 S=1024 (224)", (7, 1024, 16, 2, 128, 0),
     ("float32", "bfloat16")),
    ("qwen2.5-3b heads B=8 S=1024 (256)", (8, 1024, 16, 2, 128, 0),
     ("float32", "bfloat16")),
    ("qwen2.5-3b heads B=3 S=2048 (192)", (3, 2048, 16, 2, 128, 0),
     ("float32",)),
    ("qwen2.5-3b heads B=4 S=2048 (256)", (4, 2048, 16, 2, 128, 0),
     ("float32",)),
    ("arctic-480b S=256 G = 7 (32)", (1, 256, 56, 8, 128, 0),
     ("float32",)),
    ("arctic-480b B=2 S=1024 G = 7 (256)", (2, 1024, 56, 8, 128, 0),
     ("float32",)),
    ("recurrentgemma-2b S=2100 hd 256 (66)", (1, 2100, 10, 1, 256, 2048),
     ("float32",)),
    ("gemma3-27b S=2100 window 1024 (528)", (1, 2100, 32, 16, 128, 1024),
     ("float32", "bfloat16")),
)
# (c): each arch at its published widths and depth, fp32, B x S tokens;
# ``settle`` more steps are timed after the profiled one
TRAIN_FULL = dict(B=2, S=256, steps=3, settle=3)
TRAIN_FULL_ARCHS = ("qwen2.5-3b", "rwkv6-3b", "recurrentgemma-2b")
# (c)'s losses through the kernels against the plain paths', relative:
# three fp32 steps of a full-depth model through other operation orders
# (rwkv6-3b on an H100: 9.1e-6 at the third step)
LOSS_RTOL = 1e-4
# the caching allocator's counters logged for each step of (c)
ALLOC_STATS = ("num_alloc_retries", "num_device_alloc", "num_device_free")
# the attention leaves, every leaf of the RG-LRU ("rec") and RWKV
# time-mix ("tm") blocks, and the embedding: the gradients (c) holds
# against the plain path
ATTN_LEAVES = ("wq", "wk", "wv", "bq", "bk", "bv", "wo")
RECURRENT_BLOCKS = ("rec", "tm")
# the device kernels of K1, K3 and K4, forward and backward, by name
PORT_KERNEL_RE = re.compile(r"\b(?:fa_(?:tc_kernel|kernel|bwd_\w+)"
                            r"|rglru_\w+_kernel|wkv_\w+_kernel)")
# (b): the same gradient with remat and without through the kernels, one
# SMOKE arch per loop kind: a layer a region (qwen2.5-3b, rwkv6-3b, the
# MoE arch), a cycle a region with a tail outside (recurrentgemma-2b,
# gemma3-27b, whose window of 8 binds at S=24), gemma3-27b's per-layer
# route (a window past S) and the encoder-decoder
TRAIN_REMAT_CASES = (("qwen2.5-3b", {}), ("recurrentgemma-2b", {}),
                     ("gemma3-27b", {}), ("gemma3-27b", {"window_size": 32}),
                     ("rwkv6-3b", {}), ("qwen3-moe-30b-a3b", {}),
                     ("whisper-medium", {}))
# (c): the arch whose step is also profiled with remat=False
TRAIN_NO_REMAT_ARCH = "qwen2.5-3b"
# (d): ``train``'s crash and resume, for each arch
TRAIN_RESUME = dict(scale="20m", steps=12, batch=4, seq=128, ckpt_every=4,
                    seed=SEED)
TRAIN_RESUME_ARCHS = ("qwen2.5-3b", "rwkv6-3b")
TRAIN_CRASH_AT = 6


def bwd_shapes(arch, dims):
    """(B, Sq, Skv, H, KVH, hd, causal, window) of a phase 8 (a) row."""
    from repro_torch import configs

    c = configs.get_config(arch)
    B, Sq, Skv, causal = dims
    window = c.window_size if "local" in c.layer_kinds() else 0
    return (B, Sq, Skv, c.num_heads, c.num_kv_heads, c.head_dim, causal,
            window)


def attention_smoke_archs():
    """The archs whose SMOKE layers include attention (K1)."""
    from repro_torch import configs
    from repro_torch.models.model import ATTN_KINDS

    c = configs.get_smoke
    return [arch for arch in configs.ARCHS if c(arch).is_encoder_decoder
            or set(c(arch).layer_kinds()) & set(ATTN_KINDS)]


def smoke_attention_shapes(arch):
    """The K1 calls of a smoke train step of ``arch`` (phase 8 (b)):
    [(B, Sq, Skv, H, KVH, hd, causal, window)]."""
    from repro_torch import configs

    c = configs.get_smoke(arch)
    B, S = TRAIN_SMOKE_B, TRAIN_SMOKE_S
    heads = (c.num_heads, c.num_kv_heads, c.head_dim)
    if c.is_encoder_decoder:
        E = c.encoder_seq_len
        return [(B, E, E, *heads, False, 0), (B, S, S, *heads, True, 0),
                (B, S, E, *heads, False, 0)]
    S += c.num_patch_tokens
    kinds = set(c.layer_kinds())
    out = []
    if kinds & {"global", "moe", "moe_dense"}:
        out.append((B, S, S, *heads, True, 0))
    if "local" in kinds:
        out.append((B, S, S, *heads, True, c.window_size))
    return out


def phase_train_kernels():
    """Phase 8 (a): K1's backward kernel against ``flash_attention_bwd_ref``
    (same q, k, v, o, lse, dO) and against autograd through the model's
    plain attention path, bit-equal on a repeat, timed beside its plain
    version and the bound; K1's forward + backward timed beside SDPA's
    forward + backward (like with like). Also K1's lse against the plain
    version's, and ``plan_bwd``'s launch plan of each row. Returns
    ``{tag: row}``."""
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    from repro_torch.models import layers as L

    g = torch.Generator(device=DEV).manual_seed(SEED + 8)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rows = {}
    plan = [(tag, bwd_shapes(arch, dims), dtn)
            for tag, arch, dims, dtns in TRAIN_BWD_ROWS for dtn in dtns]
    plan += [(f"{arch} smoke #{i}", shape, "float32")
             for arch in attention_smoke_archs()
             for i, shape in enumerate(smoke_attention_shapes(arch))]
    for tag, (B, Sq, Skv, H, KVH, hd, causal, window), dtn in plan:
        dt = dts[dtn]
        q = torch.randn((B, Sq, H, hd), generator=g, device=DEV).to(dt)
        k, v = (torch.randn((B, Skv, KVH, hd), generator=g,
                            device=DEV).to(dt) for _ in range(2))
        do = torch.randn((B, Sq, H, hd), generator=g, device=DEV).to(dt)
        kw = dict(causal=causal, window=window)
        o, lse = fa_ops._forward(q, k, v, causal, window, True)
        t = [x.transpose(1, 2) for x in (q, k, v, o, do)]
        _, lse_ref = flash_attention_ref(*t[:3], return_lse=True, **kw)
        e_lse = err(lse, lse_ref)
        got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        ref = [x.transpose(1, 2) for x in flash_attention_bwd_ref(
            *t[:4], lse, t[4], **kw)]
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        with torch.enable_grad():
            out = L.flash_attention_plain(*leaves, **kw)
            auto = torch.autograd.grad(out, leaves, do)
        rel = {"ref": max(err(a, b) / float(b.abs().max().float())
                          for a, b in zip(got, ref)),
               "autograd": max(err(a, b) / float(b.abs().max().float())
                               for a, b in zip(got, auto))}
        shape = (f"q ({B},{Sq},{H},{hd}) k/v ({B},{Skv},{KVH},{hd}) {dtn} "
                 + ("causal" if causal else "non-causal")
                 + (f" window {window}" if window else ""))
        bwd_plan = fa_ops.plan_bwd(B, H, KVH, Sq, Skv, hd, sm_count(0))
        log(f"  flash_attention_bwd {tag} {dtn}: plan_bwd "
            f"{'splits the GQA group' if bwd_plan.split else 'no split'}, "
            f"{bwd_plan.blocks} dK/dV blocks of {bwd_plan.bk} keys, scratch "
            f"{bwd_plan.scratch_bytes} bytes")
        log(f"  flash_attention_bwd {tag} {shape}: dq/dk/dv max_abs_err / "
            f"max|ref| {rel['ref']:.3g} against flash_attention_bwd_ref, "
            f"{rel['autograd']:.3g} against autograd through "
            f"flash_attention_plain; lse max_abs_err {e_lse:.3g}; "
            f"repeat bit-equal {bit_equal}")
        if not (rel["ref"] < BWD_RTOL[dtn]
                and rel["autograd"] < BWD_RTOL[dtn]):
            raise AssertionError(f"flash_attention_bwd {tag} {dtn}: {rel} "
                                 f">= {BWD_RTOL[dtn]}")
        if not e_lse < 1e-4 * max(1.0, float(lse_ref.abs().max())):
            raise AssertionError(f"K1's lse {tag} {dtn}: {e_lse}")
        if not bit_equal:
            raise AssertionError(f"flash_attention_bwd {tag} {dtn}: two "
                                 "runs differ")
        del leaves, out, auto, again
        band = torch.ones((Sq, Skv), dtype=torch.bool, device=DEV)
        pos_q = torch.arange(Sq, device=DEV)[:, None]
        pos_k = torch.arange(Skv, device=DEV)[None, :]
        if causal:
            band &= pos_q >= pos_k
        if window:
            band &= pos_k > pos_q - window
        pairs = int(band.sum())
        lib_kw = ({"attn_mask": band} if window and window < Sq
                  else {"is_causal": causal})
        sq, sk, sv = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        sdo = do.transpose(1, 2)

        def library():
            with torch.enable_grad():
                out = F.scaled_dot_product_attention(sq, sk, sv,
                                                     enable_gqa=True,
                                                     **lib_kw)
                return torch.autograd.grad(out, (sq, sk, sv), sdo)

        bwd = functools.partial(fa_ops.flash_attention_bwd, q, k, v, o, lse,
                                do, **kw)
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_TF32X3_FLOPS
        b_ms, b_by = bound(nbytes(q, k, v, o, do, lse, *got),
                           BWD_FLOPS * hd * H * pairs * B, peak)
        rows[f"{tag} {dtn}"] = dict(
            shape=shape, max_abs_err=max(err(a, b) for a, b in
                                         zip(got, ref)),
            rel_err=rel, lse_err=e_lse, bit_equal=bit_equal,
            ms=graph_ms(bwd, reps=5, n=10),
            fwd_bwd_ms=graph_ms(lambda: fa_ops.flash_attention_bwd(
                q, k, v, *fa_ops._forward(q, k, v, causal, window, True),
                do, **kw), reps=5, n=10),
            plain_ms=graph_ms(lambda: flash_attention_bwd_ref(
                *t[:4], lse, t[4], **kw), reps=2, n=5),
            library_ms=graph_ms(library, reps=2, n=5),
            library="scaled_dot_product_attention forward + backward",
            bound_ms=b_ms, bound_by=b_by, split=bwd_plan.split,
            blocks=bwd_plan.blocks,
            peak=("bf16 tensor core" if dt == torch.bfloat16
                  else "tf32x3 tensor core"))
        r = rows[f"{tag} {dtn}"]
        # the scalar kernel's time is logged, not put in the row: the
        # kernels line holds this run's measurements only
        before = BWD_BEFORE_MS.get(f"{tag} {dtn}")
        log(f"    {tag} {dtn}: backward {r['ms']:.5f} ms"
            + (f" (before {before:.5f}, {before / r['ms']:.2f}x)"
               if before is not None else "")
            + f", plain {r['plain_ms']:.5f}, bound {b_ms:.5f} ({b_by}); "
            f"like with like: K1 forward with lse + backward "
            f"{r['fwd_bwd_ms']:.5f} against SDPA forward + backward "
            f"{r['library_ms']:.5f} ({r['fwd_bwd_ms'] / r['library_ms']:.2f}"
            f"x)")
        del q, k, v, o, lse, do, got, ref, t, sq, sk, sv
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def phase_bwd_plans():
    """Phase 8 (a), the launch plan: K1's backward at BWD_PLAN_ROWS under
    each of ``plan_bwd``'s two plans for the dK/dV pass, the GQA group
    split across blocks (as on a card of unbounded SMs) or walked by one
    block (as on a card of none), timed in turns (split, unsplit,
    unsplit, split; CUDA-graph replay, the mean of each plan's two); the
    two plans' gradients agree within BWD_RTOL of max|g|. Logs which is
    faster and which ``plan_bwd`` picks on this card; returns ``{tag:
    row}``."""
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.flash_attention import ops as fa_ops

    n_sm = sm_count(0)
    g = torch.Generator(device=DEV).manual_seed(SEED + 9)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rows = {}
    for tag, (B, S, H, KVH, hd, window), dtns in BWD_PLAN_ROWS:
        for dtn in dtns:
            dt = dts[dtn]
            q, do = (torch.randn((B, S, H, hd), generator=g,
                                 device=DEV).to(dt) for _ in range(2))
            k, v = (torch.randn((B, S, KVH, hd), generator=g,
                                device=DEV).to(dt) for _ in range(2))
            o, lse = fa_ops._forward(q, k, v, True, window, True)
            plans = {"split": fa_ops.plan_bwd(B, H, KVH, S, S, hd, 2**31 - 1),
                     "unsplit": fa_ops.plan_bwd(B, H, KVH, S, S, hd, 0)}
            calls = {name: functools.partial(fa_ops._bwd_launch, q, k, v, o,
                                             lse, do, True, window, plan)
                     for name, plan in plans.items()}
            a, b = calls["split"](), calls["unsplit"]()
            rel = max(err(x, y) / float(y.abs().max().float())
                      for x, y in zip(a, b))
            if not (plans["split"].split and rel < BWD_RTOL[dtn]):
                raise AssertionError(f"K1 backward plans at {tag} {dtn}: "
                                     f"{plans}, rel {rel}")
            times = {"split": [], "unsplit": []}
            for name in ("split", "unsplit", "unsplit", "split"):
                times[name].append(graph_ms(calls[name], reps=5, n=10))
            ms = {name: statistics.mean(t) for name, t in times.items()}
            chosen = ("split" if fa_ops.plan_bwd(B, H, KVH, S, S, hd,
                                                 n_sm).split else "unsplit")
            faster = min(ms, key=ms.get)
            rows[f"{tag} {dtn}"] = row = dict(
                blocks={n: p.blocks for n, p in plans.items()},
                ms=ms, times=times, rel_diff=rel, chosen=chosen,
                faster=faster)
            log(f"  flash_attention_bwd plans, {tag} {dtn}: split "
                f"{plans['split'].blocks} blocks {ms['split']:.5f} ms, "
                f"unsplit {plans['unsplit'].blocks} blocks "
                f"{ms['unsplit']:.5f} ms (unsplit / split "
                f"{ms['unsplit'] / ms['split']:.3f}); plan_bwd on "
                f"{n_sm} SMs picks {chosen}, the faster is {faster}; "
                f"gradients differ by {rel:.3g} of max|g|")
            del q, k, v, o, lse, do, a, b, calls
            gc.collect()
            torch.cuda.empty_cache()
    log("  " + json.dumps({"bwd_plans": rows}))
    return rows


def phase_rglru_bwd_plans():
    """Phase 8 (a), K3's backward plan: at each K3 row of REC_BWD_ROWS,
    the kernel under ``plan_chunks``'s plan and under its neighbours
    (half and twice the chunks, in blocks of 8 or 16 warps), each timed
    by CUDA-graph replay and its gradients held to the planned ones
    within BWD_RTOL of max|g|. Logs the plans by time; returns ``{tag:
    {plan: ms}}``."""
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.rglru_scan import ops as rg

    n_sm = sm_count(0)
    g = torch.Generator(device=DEV).manual_seed(SEED + 14)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rows = {}
    for (tag, dims), dtn in itertools.product(
            REC_BWD_ROWS["rglru_gated_bwd"], dts):
        ins, douts = rec_bwd_case("rglru_gated_bwd", dims, dts[dtn], g)
        h, _ = rg.rglru_gated_scan(*ins)
        B, S, W = dims
        chosen = rg.plan_chunks(B, S, W, rg.bwd_vec(W), n_sm)
        slots = chosen[0] * chosen[1]
        plans = [chosen] + [
            (n // nw, nw, -(-S // n)) for n in (slots // 2, slots, 2 * slots)
            for nw in (8, 16)
            if nw <= n and n // nw <= rg.MAX_CLUSTER and n <= 128
            and (n // nw, nw) != chosen[:2]]
        want = rg._bwd_launch(*ins, h, *douts, chosen)
        ms = {}
        for plan in plans:
            call = functools.partial(rg._bwd_launch, *ins, h, *douts, plan)
            got = call()
            rel = max(err(a, b) / max(float(b.abs().max().float()), 1e-30)
                      for a, b in zip(got, want))
            if not rel < BWD_RTOL[dtn]:
                raise AssertionError(f"K3 backward plan {plan} at {tag} "
                                     f"{dtn}: {rel}")
            ms[str(plan)] = graph_ms(call, reps=5, n=10)
        rows[f"{tag} {dtn}"] = ms
        log(f"  rglru_gated_bwd plans (cl, nw, L), {tag} {dtn}: "
            + ", ".join(f"{p} {t:.5f} ms" for p, t in
                        sorted(ms.items(), key=lambda x: x[1]))
            + f"; plan_chunks on {n_sm} SMs picks {chosen}")
        del ins, douts, h, want
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def rec_bwd_case(name, dims, dt, g):
    """A phase 8 (a) row's inputs on the card, drawn from ``g``: K3's
    (ga, gx, xb, log_lambda as the model draws it, h0) or K4's (r, k, v,
    lw spread over [REC_BWD_LW_MIN, -0.05], u, s0), then the gradients of
    the forward's outputs."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=DEV) * scale

    if name == "rglru_gated_bwd":
        B, S, W = dims
        a_init = 0.9 + 0.099 * torch.rand(W, generator=g, device=DEV)
        lam = torch.log(torch.expm1(-torch.log(a_init) / 8.0))
        ins = [randn(B, S, W).to(dt) for _ in range(3)] + [lam, randn(B, W)]
        return ins, [randn(B, S, W), randn(B, W)]
    B, NH, S, hs = dims
    lo, hi = math.log(0.05), math.log(-REC_BWD_LW_MIN)
    lw = -torch.exp(lo + (hi - lo) * torch.rand((B, S, NH, hs), generator=g,
                                                device=DEV))
    ins = ([randn(B, S, NH, hs).to(dt) for _ in range(3)]
           + [lw, randn(NH, hs, scale=0.3), randn(B, NH, hs, hs, scale=0.3)])
    return ins, [randn(B, S, NH, hs), randn(B, NH, hs, hs)]


def phase_train_rec_kernels():
    """Phase 8 (a), the recurrent backward kernels: K3's gated backward
    against ``rglru_gated_scan_bwd_ref`` and K4's against
    ``wkv6_chunked_bwd_ref(..., sub=16, tf32x3=True)`` (the kernel's
    algorithm and rounding) on the same inputs (the forward's h, or the
    states the forward kept), and against autograd through the plain
    forward (``rglru_gated_scan_ref``, ``wkv6_ref``) on the card; two runs
    bit-equal; f32 within 1e-4 of each gradient's largest |reference|
    (dlw DLW_RTOL), bf16 2e-2. Timed by CUDA-graph replay beside the plain
    backward and the bound (K4's operations at the 3xTF32 rate), with the
    earlier design's time (REC_BWD_BEFORE_MS) logged beside it. Returns
    ``{kernel: {tag: row}}``."""
    from repro_torch.kernels.rglru_scan.ref import (rglru_gated_scan_bwd_ref,
                                                    rglru_gated_scan_ref)
    from repro_torch.kernels.rwkv6_scan.ref import (wkv6_chunked_bwd_ref,
                                                    wkv6_ref)

    m = ops_modules()
    rg, wkv = m["rglru_scan"], m["rwkv6_scan"]
    g = torch.Generator(device=DEV).manual_seed(SEED + 13)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rows = {name: {} for name in REC_BWD_ROWS}
    for name, cases in REC_BWD_ROWS.items():
        for (tag, dims), dtn in itertools.product(cases, dts):
            ins, douts = rec_bwd_case(name, dims, dts[dtn], g)
            if name == "rglru_gated_bwd":
                h, _ = rg.rglru_gated_scan(*ins)
                args = (*ins, h, *douts)
                kern = functools.partial(rg.rglru_gated_scan_bwd, *args)
                plain = functools.partial(rglru_gated_scan_bwd_ref, *args)
                fwd_plain, read = rglru_gated_scan_ref, (*ins, h, *douts)
                B, S, W = dims
                flops = RGLRU_BWD_FLOPS * B * S * W
            else:
                _, _, states = wkv._forward(*ins)
                kern = functools.partial(wkv.wkv6_bwd, *ins, states, *douts)
                plain = functools.partial(wkv6_chunked_bwd_ref, *ins,
                                          *douts, sub=16, tf32x3=True)
                fwd_plain = wkv6_ref
                read = (*ins[:5], states, *douts)
                B, NH, S, hs = dims
                flops = WKV_BWD_FLOPS * hs * hs * B * NH * S
            got, again, ref = kern(), kern(), plain()
            bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
            leaves = [x.detach().clone().requires_grad_() for x in ins]
            with torch.enable_grad():
                auto = torch.autograd.grad(fwd_plain(*leaves), leaves, douts)
            tol = [BWD_RTOL[dtn]] * len(got)
            if name == "wkv6_bwd":
                tol[3] = max(tol[3], DLW_RTOL)
            rel = {what: [err(a, b) / max(float(b.abs().max().float()),
                                          1e-30) for a, b in zip(got, other)]
                   for what, other in (("ref", ref), ("autograd", auto))}
            worst = max(r / t for rs in rel.values() for r, t in zip(rs, tol))
            shape = f"{tuple(dims)} {dtn}"
            log(f"  {name} {tag} {dtn}: max_abs_err / max|ref| of each "
                f"gradient {[f'{x:.3g}' for x in rel['ref']]} against the "
                f"plain backward, {[f'{x:.3g}' for x in rel['autograd']]} "
                f"against autograd through the plain forward (worst "
                f"{worst:.3g} of its tolerance); repeat bit-equal "
                f"{bit_equal}")
            if not (worst < 1.0 and bit_equal):
                raise AssertionError(f"{name} {tag} {dtn}: {rel}, bit-equal "
                                     f"{bit_equal}")
            peak = REC_BWD_PEAK[name]
            b_ms, b_by = bound(nbytes(*read, *got), flops, peak)
            rows[name][f"{tag} {dtn}"] = r = dict(
                shape=shape, max_abs_err=max(err(a, b)
                                             for a, b in zip(got, ref)),
                rel_err=rel, bit_equal=bit_equal,
                ms=graph_ms(kern, reps=5, n=10),
                plain_ms=graph_ms(plain, reps=2, n=5), library_ms=None,
                bound_ms=b_ms, bound_by=b_by, peak=PEAK_NAMES[peak])
            # the earlier time is logged, not put in the row: the kernels line
            # holds this run's measurements only
            before = REC_BWD_BEFORE_MS[f"{tag} {dtn}"]
            log(f"    {name} {tag} {dtn}: backward {r['ms']:.5f} ms (before "
                f"{before:.5f}, {before / r['ms']:.2f}x), plain "
                f"{r['plain_ms']:.5f}, bound {b_ms:.5f} ({b_by}, "
                f"{r['peak']})")
            del ins, douts, got, again, ref, leaves, auto, kern, plain, read
            gc.collect()
            torch.cuda.empty_cache()
    return rows


def grads_close(a, b, what):
    """Each leaf of two gradient trees within 1e-4 x max(1, max|leaf of
    a|); returns the worst ratio of error to that bound."""
    from repro_torch.training.tree import tree_leaves

    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        tol = 1e-4 * max(1.0, float(x.abs().max()))
        worst = max(worst, err(x.cpu(), y.cpu()) / tol)
    if not worst < 1.0:
        raise AssertionError(f"{what}: a gradient leaf is {worst:.3g}x its "
                             "tolerance")
    return worst


def train_routes(cfg):
    """The forward and backward routes a train step of ``cfg`` launches:
    K1's where it has attention, K3's gated route's where it has RG-LRU
    layers, K4's chunked route's where it has RWKV layers."""
    from repro_torch.models.model import ATTN_KINDS

    kinds = set(cfg.layer_kinds())
    routes = []
    if cfg.is_encoder_decoder or kinds & set(ATTN_KINDS):
        routes += ["flash_attention", "flash_attention_bwd"]
    if "rglru" in kinds:
        routes += ["rglru_gated", "rglru_gated_bwd"]
    if "rwkv" in kinds:
        routes += ["rwkv6_chunked", "wkv6_bwd"]
    return routes


# every route a train step can launch, forward and backward
TRAIN_ROUTES = ("flash_attention", "flash_attention_bwd", "rglru_gated",
                "rglru_gated_bwd", "rwkv6_chunked", "wkv6_bwd")


def phase_train_smoke():
    """Phase 8 (b): two steps of ``make_train_step`` on SMOKE params of
    every arch, on the card and on the CPU from the same params and
    ``data.batch(0)``: losses within 1e-5 relative, the gradients at step
    0 leaf by leaf within 1e-4 x max(1, max|g|), params moved; the forward
    and backward kernels of the arch's layers (K1, K3's gated route, K4)
    launched by the card steps (counters zeroed just before them, read
    just after). Returns the launches by arch."""
    from repro_torch import bridge, configs
    from repro_torch.device import generator_for
    from repro_torch.launch.steps import (batch_to, loss_and_grads,
                                          make_train_step)
    from repro_torch.models import model as MDL
    from repro_torch.training.data import DataConfig, SyntheticTokenStream
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.tree import tree_leaves

    cpu = torch.device("cpu")
    launches = {}
    for arch in configs.ARCHS:
        cfg = configs.get_smoke(arch)
        opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
        step = make_train_step(cfg, opt)
        data = SyntheticTokenStream(DataConfig(
            cfg.vocab_size, TRAIN_SMOKE_B, TRAIN_SMOKE_S, seed=SEED))
        batch = data.batch(0, cfg)
        params = MDL.init_params(generator_for(DEV, SEED), cfg, device=DEV)
        params_cpu = bridge.params_from_jax(bridge.params_to_numpy(params),
                                            cpu)
        _, _, g_card = loss_and_grads(cfg, params, batch_to(batch, DEV))
        _, _, g_cpu = loss_and_grads(cfg, params_cpu, batch_to(batch, cpu))
        worst = grads_close(g_cpu, g_card, f"{arch} smoke gradients")
        reset_counts()
        p, s, losses = params, opt.init(params), []
        for _ in range(2):
            p, s, m = step(p, s, batch)
            losses.append(float(m["loss"]))
        got = read_counts(TRAIN_ROUTES)
        p_c, s_c, losses_c = params_cpu, opt.init(params_cpu), []
        for _ in range(2):
            p_c, s_c, m = step(p_c, s_c, batch)
            losses_c.append(float(m["loss"]))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, losses_c))
        moved = any(not torch.equal(a, b) for a, b in
                    zip(tree_leaves(params), tree_leaves(p)))
        log(f"  {arch} smoke: losses card {losses} cpu {losses_c} (rel "
            f"{rel:.3g}); gradients at step 0 within {worst:.3g} of their "
            f"tolerance; params moved {moved}; launches {json.dumps(got)}")
        if not (rel < 1e-5 and moved and all(np.isfinite(losses))):
            raise AssertionError(f"{arch} smoke train step: card {losses} "
                                 f"cpu {losses_c}, moved {moved}")
        idle = [r for r in train_routes(cfg) if not got[r]]
        if idle:
            raise AssertionError(f"{arch}: {idle} not launched by the train "
                                 f"steps: {got}")
        launches[arch] = got
        del params, params_cpu, p, s, p_c, s_c, g_card, g_cpu
    return launches


def train_step_launches(cfg, seq, remat):
    """The launches of K1, K3's gated route and K4's chunked route,
    forward and backward, that one gradient of ``cfg`` at ``seq`` tokens
    makes: a forward for each attention (two in an encoder-decoder's
    decoder layer: self and cross) and recurrence of every layer, a
    backward for each forward, and with ``remat`` the forwards of every
    checkpointed layer again in the backward's recompute. Which layers
    are checkpointed is stated here from the config alone, as the JAX
    model's ``forward_features`` chooses them, not read from the port's
    ``remat_regions``: every encoder and decoder layer; every layer of a
    uniform attention stack (a pattern of more than one kind, all
    ``local``/``global``) with a full cycle where no window binds at
    ``seq`` (its merged per-layer scan); elsewhere the layers of the
    scanned cycles, never the tail's."""
    n = dict.fromkeys(TRAIN_ROUTES, 0)
    bwd = {"flash_attention": "flash_attention_bwd",
           "rglru_gated": "rglru_gated_bwd", "rwkv6_chunked": "wkv6_bwd"}

    def add(route, calls, region):
        n[route] += calls * (2 if remat and region else 1)
        n[bwd[route]] += calls

    if cfg.is_encoder_decoder:
        add("flash_attention",
            cfg.num_encoder_layers + 2 * cfg.num_decoder_layers, True)
        return n
    pattern = cfg.block_pattern
    plen = len(pattern)
    scanned = cfg.num_layers // plen * plen if cfg.scan_layers else 0
    merged = (scanned > 0 and plen > 1
              and set(pattern) <= {"local", "global"}
              and not ("local" in pattern and cfg.window_size < seq))
    route = {"rglru": "rglru_gated", "rwkv": "rwkv6_chunked"}
    for i in range(cfg.num_layers):
        add(route.get(pattern[i % plen], "flash_attention"), 1,
            merged or i < scanned)
    return n


def phase_train_remat():
    """Phase 8 (b), remat: for each of ``TRAIN_REMAT_CASES`` (SMOKE
    params on the card, ``data.batch(0)``), one gradient with
    ``remat=False`` and one with ``remat=True`` through the kernels, the
    counters zeroed just before each and read just after: the gradients
    bit-equal (the kernels repeat their bits and use no atomics; the MoE
    arch within 1e-4 x max(1, max|g|), its dispatch's ``index_add_``),
    and each run's launches exactly ``train_step_launches``: the forward
    kernels twice in every checkpointed layer, the backward kernels once.
    Returns the launches of the remat runs, summed."""
    from repro_torch import configs
    from repro_torch.device import generator_for
    from repro_torch.launch.steps import batch_to, loss_and_grads
    from repro_torch.models import model as MDL
    from repro_torch.training.data import DataConfig, SyntheticTokenStream
    from repro_torch.training.tree import tree_leaves

    total = dict.fromkeys(TRAIN_ROUTES, 0)
    for arch, kw in TRAIN_REMAT_CASES:
        cfg = configs.get_smoke(arch).replace(**kw)
        data = SyntheticTokenStream(DataConfig(
            cfg.vocab_size, TRAIN_SMOKE_B, TRAIN_SMOKE_S, seed=SEED))
        batch = batch_to(data.batch(0, cfg), DEV)
        params = MDL.init_params(generator_for(DEV, SEED), cfg, device=DEV)
        grads, got, want = {}, {}, {}
        for remat in (False, True):
            c = cfg.replace(remat=remat)
            reset_counts()
            _, _, g = loss_and_grads(c, params, batch)
            got[remat] = read_counts(TRAIN_ROUTES)
            want[remat] = train_step_launches(c, batch["tokens"].shape[1],
                                              remat)
            grads[remat] = g
        equal = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(grads[False]), tree_leaves(grads[True])))
        tag = f"{arch}{' ' + json.dumps(kw) if kw else ''}"
        worst = grads_close(grads[False], grads[True], f"{tag} remat")
        log(f"  (b) remat {tag}: gradients with and without remat "
            f"bit-equal {equal} (within {worst:.3g} of the tolerance); "
            f"launches without {json.dumps(got[False])}, with "
            f"{json.dumps(got[True])}")
        if not (equal or cfg.num_experts):
            raise AssertionError(f"{tag}: the remat gradients are not "
                                 "bit-equal to the gradients without")
        for remat in (False, True):
            if got[remat] != want[remat]:
                raise AssertionError(f"{tag} remat={remat}: launches "
                                     f"{got[remat]}, expected "
                                     f"{want[remat]}")
        if got[True] == got[False]:
            raise AssertionError(f"{tag}: remat recomputed no kernel")
        for k, v in got[True].items():
            total[k] += v
        del params, grads
    return total


def grad_leaves(grads):
    """{name: gradient} of the embedding table, of the attention leaves
    and of every leaf of the recurrent blocks of each layer (stacked by
    cycle position)."""
    from repro_torch.parallel.sharding import _tree_paths

    out = {"embed": grads["embed"]["table"]}
    for pos, tree in enumerate(grads["cycles"]):
        for name in ATTN_LEAVES:
            if name in tree.get("attn", {}):
                out[f"cycles/{pos}/attn/{name}"] = tree["attn"][name]
        for block in RECURRENT_BLOCKS:
            if block in tree:
                for path, leaf in _tree_paths(tree[block]):
                    out[f"cycles/{pos}/{block}/{path}"] = leaf
    return out


@contextlib.contextmanager
def plain_recurrence():
    """The model's recurrences on their plain paths under autograd on any
    device: K3's gated route as ``rglru_gated_scan_ref``, K4 as the
    model's ``wkv_chunked`` (the port of the JAX model's prefill form),
    for a reference gradient on the card; never on a counted path."""
    import types

    from repro_torch.kernels.rglru_scan.ref import rglru_gated_scan_ref
    from repro_torch.models.rwkv6 import wkv_chunked

    m = ops_modules()
    rg, wkv = m["rglru_scan"], m["rwkv6_scan"]
    fns = rg.RGLRUGatedScanFn, wkv.WKV6Fn
    rg.RGLRUGatedScanFn = types.SimpleNamespace(apply=rglru_gated_scan_ref)
    wkv.WKV6Fn = types.SimpleNamespace(apply=wkv_chunked)
    try:
        yield
    finally:
        rg.RGLRUGatedScanFn, wkv.WKV6Fn = fns


def phase_train_full(arch):
    """Phase 8 (c): ``arch`` at its published config (qwen2.5-3b: 36
    layers, d 2048, 16/2 heads, hd 128, d_ff 11008, vocab 151936;
    rwkv6-3b: 32 RWKV-6 layers, d 2560, head size 64; recurrentgemma-2b:
    26 layers of (RG-LRU, RG-LRU, local attention) cycles, d 2560, LRU
    width 2560, 10 heads of 256, vocab 256000), fp32, B=2 x S=256, not
    cut. First one gradient through the kernels' autograd Functions and
    one through the plain paths on the card (``plain_attention``,
    ``plain_recurrence``), held on the attention and recurrent leaves and
    the embedding; then 3 steps of ``make_train_step`` through the plain
    paths, and from the same params 3 through the kernels (counters
    zeroed just before, read just after): the same losses within
    LOSS_RTOL, finite loss and grad norm, the arch's forward and backward
    kernels launched; with the profiled step and ``settle`` more, the
    loss falls over the run (its last step's below the first's). Prints
    host wall, device ms
    (torch.profiler), idle share, device kernels a step, the port's
    kernels' share by name, tokens/s and peak memory; then the walls of
    ``settle`` more steps after the profiled one, and the caching
    allocator's retries, device allocations and frees in each timed
    step."""
    from repro_torch import configs
    from repro_torch.device import generator_for
    from repro_torch.launch.steps import (batch_to, loss_and_grads,
                                          make_train_step)
    from repro_torch.models import model as MDL
    from repro_torch.training.data import DataConfig, SyntheticTokenStream
    from repro_torch.training.optimizer import AdamW

    c = TRAIN_FULL
    cfg = configs.get_config(arch).replace(
        param_dtype="float32", activation_dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    params = MDL.init_params(generator_for(DEV, SEED), cfg, device=DEV)
    data = SyntheticTokenStream(DataConfig(cfg.vocab_size, c["B"], c["S"],
                                           seed=SEED))
    batch = batch_to(data.batch(0, cfg), DEV)
    g_k, grad_peak = grad_and_peak(cfg, params, batch)
    g_k = grad_leaves(g_k)
    with plain_attention(), plain_recurrence():
        _, _, g_p = loss_and_grads(cfg, params, batch)
    g_p = grad_leaves(g_p)
    worst = {}
    for name, a in g_k.items():
        tol = 1e-4 * max(1.0, float(g_p[name].abs().max()))
        worst[name] = err(a, g_p[name]) / tol
    top = sorted(worst.items(), key=lambda x: -x[1])[:12]
    log(f"  {arch}: gradients through the kernels vs the plain paths, "
        f"error / tolerance (1e-4 x max(1, max|g|)), the worst 12 of "
        f"{len(worst)} leaves: "
        f"{json.dumps({k: round(v, 4) for k, v in top})}")
    if not max(worst.values()) < 1.0:
        raise AssertionError(f"{arch} full-width gradients disagree: {top}")
    del g_k, g_p, params
    gc.collect()
    torch.cuda.empty_cache()

    # the training driver's optimizer for a run of this many steps
    # (launch/train.py): lr 3e-4 reached after a warmup of 10 steps (at
    # the full rate from step 0, qwen2.5-3b on an H100: losses 12.458,
    # 10.925, 13.833)
    opt = AdamW(lr=3e-4, warmup_steps=max(10, c["steps"] // 20),
                total_steps=c["steps"])
    step = make_train_step(cfg, opt)
    # the reference trajectory: the same steps through the plain paths,
    # from the same params (drawn again from the seed; one tree at a time)
    params = MDL.init_params(generator_for(DEV, SEED), cfg, device=DEV)
    state, plain_losses = opt.init(params), []
    with plain_attention(), plain_recurrence():
        for _ in range(c["steps"]):
            params, state, m = step(params, state, batch)
            plain_losses.append(float(m["loss"]))
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # one param tree at a time: the update is not in place
    holder = {"p": MDL.init_params(generator_for(DEV, SEED), cfg,
                                   device=DEV)}
    holder["s"] = opt.init(holder["p"])
    reset_counts()
    steps = [timed_train_step(step, holder, batch)
             for _ in range(c["steps"])]
    losses, gnorms, walls, enqueues, allocs = map(list, zip(*steps))
    launches = read_counts(TRAIN_ROUTES)
    peak = torch.cuda.max_memory_allocated()

    # device time of one more step on the same batch, by torch.profiler
    # (the sum of its device kernels' times)
    def one():
        holder["p"], holder["s"], m = step(holder["p"], holder["s"], batch)
        run_losses.append(float(m["loss"]))

    run_losses = list(losses)
    kern = device_kernels(one, 1)
    # more steps after the profiled one: the warm walls
    after = [timed_train_step(step, holder, batch)
             for _ in range(c["settle"])]
    run_losses += [a[0] for a in after]
    settled = [a[2] for a in after]
    settled_enqueue = [a[3] for a in after]
    dev_ms = sum(t for _, t, _c in kern)
    n_kern = sum(cnt for _, _t, cnt in kern)
    # the port's kernels by name: K1's forward and its backward's D pass,
    # dK/dV, group reduction and dQ kernels; K3's and K4's forward and
    # backward kernels
    by_name = {}
    for name, t, cnt in kern:
        m = PORT_KERNEL_RE.search(name)
        if m:
            ms, n = by_name.get(m.group(0), (0.0, 0.0))
            by_name[m.group(0)] = (ms + t, n + cnt)
    port_ms = sum(t for t, _n in by_name.values())
    wall = statistics.median(walls)
    warm = statistics.median(settled)
    out = {"arch": arch, "losses": losses, "plain_losses": plain_losses,
           "run_losses": run_losses, "grad_norms": gnorms,
           "wall_ms": walls, "enqueue_ms": enqueues,
           "device_ms_profiler": dev_ms,
           "idle_share": 1 - dev_ms / wall,
           "idle_share_settled": 1 - dev_ms / warm,
           "device_kernels": n_kern,
           "port_kernels_ms": port_ms, "port_kernels_by_name": by_name,
           "tokens_per_s": c["B"] * c["S"] / (wall / 1e3),
           "settled_wall_ms": settled, "settled_enqueue_ms": settled_enqueue,
           "tokens_per_s_settled": c["B"] * c["S"] / (warm / 1e3),
           "allocator_by_step": allocs,
           "max_memory_allocated_bytes": peak, "launches": launches,
           "remat": cfg.remat, "grad_peak_bytes": grad_peak,
           "grad_check_worst": dict(top),
           "top": [(k[:60], t) for k, t, _c in kern[:8]]}
    log("  " + json.dumps({"train_full": out}))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    log(f"  {arch} full width fp32 B={c['B']} S={c['S']}: losses "
        f"{losses} (through the plain paths {plain_losses}, rel "
        f"{loss_rel:.3g}), grad norms {gnorms}, the whole run's losses "
        f"{run_losses}; step host wall {wall:.3f} ms "
        f"(median of {c['steps']}), device {dev_ms:.3f} ms (torch.profiler, "
        f"one step), idle share {1 - dev_ms / wall:.3f}, device kernels a "
        f"step {n_kern:.0f} (the port's kernels {port_ms:.3f} ms), "
        f"{out['tokens_per_s']:.1f} tokens/s, max_memory_allocated "
        f"{peak / 2**30:.3f} GiB (a gradient's own peak "
        f"{grad_peak / 2**30:.3f} GiB), remat {cfg.remat}; launches "
        f"{json.dumps(launches)}")
    log(f"  step walls {[round(w, 1) for w in walls]} ms, then after the "
        f"profiled step {[round(w, 1) for w in settled]} ms "
        f"({out['tokens_per_s_settled']:.1f} tokens/s and idle share "
        f"{out['idle_share_settled']:.3f} at their median; the host enqueued "
        f"them in {[round(w, 1) for w in settled_enqueue]} ms); "
        f"the caching allocator a step ({', '.join(ALLOC_STATS)}): "
        + "; ".join(" ".join(str(a[k]) for k in ALLOC_STATS)
                    for a in allocs))
    log(f"  the port's kernels' share of the step's device time: "
        f"{port_ms:.3f} of {dev_ms:.3f} ms ({port_ms / dev_ms:.4f}); by "
        "kernel (ms, launches a step): "
        + "; ".join(f"{k} {t:.3f} ({n:.0f})" for k, (t, n) in
                    sorted(by_name.items(), key=lambda x: -x[1][0])))
    # the loss falls over the run (its last step below its first); a
    # step may rise: Adam's first updates move every weight by about lr,
    # and the second or third overshoots on the fresh model, through the
    # plain paths as through the kernels (on an H100 with this schedule:
    # qwen2.5-3b 12.458, 10.590, 10.982; rwkv6-3b 11.560, 9.825, 13.174,
    # then 10.896, 10.970, 8.859, 8.848)
    if not (all(np.isfinite(run_losses)) and all(np.isfinite(gnorms))
            and loss_rel < LOSS_RTOL and run_losses[-1] < run_losses[0]):
        raise AssertionError(f"{arch} full-width losses {losses}, through "
                             f"the plain paths {plain_losses}, over the run "
                             f"{run_losses}, grad norms {gnorms}")
    want = {r: c["steps"] * n for r, n in
            train_step_launches(cfg, c["S"], cfg.remat).items()}
    if launches != want:
        raise AssertionError(f"{arch} full-width steps launched "
                             f"{launches}, expected {want}")
    del holder
    gc.collect()
    torch.cuda.empty_cache()
    if arch == TRAIN_NO_REMAT_ARCH:
        out["no_remat"] = train_step_no_remat(cfg, opt, batch)
        r = out["no_remat"]
        log(f"  {arch} remat=False beside it: device {r['device_ms']:.3f} ms "
            f"(torch.profiler, one step) against {dev_ms:.3f} with remat, "
            f"{r['device_kernels']:.0f} device kernels a step against "
            f"{n_kern:.0f}; warm step host wall (median of the "
            f"{c['settle']} after the profiled one) {r['warm_wall_ms']:.3f} "
            f"ms against {warm:.3f}, enqueued by the host in "
            f"{r['warm_enqueue_ms']:.3f} ms against "
            f"{statistics.median(settled_enqueue):.3f}, "
            f"{r['tokens_per_s_settled']:.1f} tokens/s against "
            f"{out['tokens_per_s_settled']:.1f}, idle share "
            f"{r['idle_share_settled']:.3f} against "
            f"{out['idle_share_settled']:.3f}; max_memory_allocated "
            f"{r['peak_bytes'] / 2**30:.3f} GiB against "
            f"{peak / 2**30:.3f}, a gradient's own peak "
            f"{r['grad_peak_bytes'] / 2**30:.3f} GiB against "
            f"{grad_peak / 2**30:.3f}, loss {r['loss']} (with remat "
            f"{losses[0]})")
        if r["loss"] != losses[0]:
            raise AssertionError(f"{arch}: the first step's loss is "
                                 f"{r['loss']} without remat, {losses[0]} "
                                 "with it")
    return out, launches


def grad_and_peak(cfg, params, batch):
    """``loss_and_grads``' gradients and the bytes its call allocated at
    its peak above what was allocated before it (the gradients
    included)."""
    from repro_torch.launch.steps import loss_and_grads

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, _, grads = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    return grads, torch.cuda.max_memory_allocated() - before


def timed_train_step(step, holder, batch):
    """One ``step`` on ``holder``'s params and state, updated in place:
    (loss, grad norm, host wall ms, host enqueue ms — until ``step``
    returned, before the loss's read waits for the card —, the caching
    allocator's ``ALLOC_STATS`` deltas)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()
    t0 = time.perf_counter()
    holder["p"], holder["s"], m = step(holder["p"], holder["s"], batch)
    enqueue = (time.perf_counter() - t0) * 1e3
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    wall = (time.perf_counter() - t0) * 1e3
    after = torch.cuda.memory_stats()
    return loss, gnorm, wall, enqueue, {
        k: after.get(k, 0) - before.get(k, 0) for k in ALLOC_STATS}


def train_step_no_remat(cfg, opt, batch):
    """(c) with ``remat=False`` from the same params: a gradient's own
    peak (``grad_and_peak``), then the steps of the remat run with the
    peak reset: the first (its loss), one profiled (device ms and kernels
    by torch.profiler), and ``TRAIN_FULL["settle"]`` warm ones (host wall
    and enqueue ms, tokens/s and idle share at their median), with
    ``max_memory_allocated`` over them."""
    from repro_torch.device import generator_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as MDL

    c = TRAIN_FULL
    cfg = cfg.replace(remat=False)
    holder = {"p": MDL.init_params(generator_for(DEV, SEED), cfg,
                                   device=DEV)}
    grads, grad_peak = grad_and_peak(cfg, holder["p"], batch)
    del grads
    step = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    holder["s"] = opt.init(holder["p"])
    loss = timed_train_step(step, holder, batch)[0]

    def one():
        holder["p"], holder["s"], _ = step(holder["p"], holder["s"], batch)

    kern = device_kernels(one, 1)
    dev_ms = sum(t for _, t, _c in kern)
    after = [timed_train_step(step, holder, batch)
             for _ in range(c["settle"])]
    warm = statistics.median(a[2] for a in after)
    out = {"loss": loss, "device_ms": dev_ms,
           "device_kernels": sum(cnt for _, _t, cnt in kern),
           "settled_wall_ms": [a[2] for a in after],
           "settled_enqueue_ms": [a[3] for a in after], "warm_wall_ms": warm,
           "warm_enqueue_ms": statistics.median(a[3] for a in after),
           "tokens_per_s_settled": c["B"] * c["S"] / (warm / 1e3),
           "idle_share_settled": 1 - dev_ms / warm,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "grad_peak_bytes": grad_peak}
    del holder
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_host_split(arch=TRAIN_NO_REMAT_ARCH):
    """Where a train step's host time goes, with and without remat (not
    run by ``main``; alone: ``phase_build()`` first): ``arch`` at its
    published config in fp32 at ``TRAIN_FULL``'s shape, two steps (the
    first pays the allocator's growth), then one step under
    torch.profiler, its CPU events split by thread — the caller's (the
    forward, the loss and the update) and autograd's device thread (the
    backward and, with remat, the recompute) — into
    each thread's host span (first event's start to last event's end),
    the self CPU time of its aten operations, and its kernel launches;
    and the step's device ms. Returns {remat: {thread: ...}}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.device import generator_for
    from repro_torch.launch.steps import batch_to, make_train_step
    from repro_torch.models import model as MDL
    from repro_torch.training.data import DataConfig, SyntheticTokenStream
    from repro_torch.training.optimizer import AdamW

    c = TRAIN_FULL
    base = configs.get_config(arch).replace(
        param_dtype="float32", activation_dtype="float32")
    data = SyntheticTokenStream(DataConfig(base.vocab_size, c["B"], c["S"],
                                           seed=SEED))
    out = {}
    for remat in (True, False):
        cfg = base.replace(remat=remat)
        batch = batch_to(data.batch(0, cfg), DEV)
        opt = AdamW(lr=3e-4, warmup_steps=10, total_steps=c["steps"])
        step = make_train_step(cfg, opt)
        holder = {"p": MDL.init_params(generator_for(DEV, SEED), cfg,
                                       device=DEV)}
        holder["s"] = opt.init(holder["p"])
        walls = [timed_train_step(step, holder, batch)[2] for _ in range(2)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            holder["p"], holder["s"], m = step(holder["p"], holder["s"],
                                               batch)
            float(m["loss"])
        threads = {}
        dev_us = 0.0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CPU:
                dev_us += e.self_device_time_total
                continue
            t = threads.setdefault(e.thread, {
                "start": e.time_range.start, "end": e.time_range.end,
                "aten_self_ms": 0.0, "launches": 0, "events": 0})
            t["start"] = min(t["start"], e.time_range.start)
            t["end"] = max(t["end"], e.time_range.end)
            t["events"] += 1
            if e.name.startswith("aten::"):
                t["aten_self_ms"] += e.self_cpu_time_total / 1e3
            if "LaunchKernel" in e.name:
                t["launches"] += 1
        # the caller's thread runs the step's first event
        order = sorted(threads, key=lambda k: threads[k]["start"])
        threads = {("caller" if i == 0 else f"thread {k}"): threads[k]
                   for i, k in enumerate(order)}
        for t in threads.values():
            t["span_ms"] = (t.pop("end") - t.pop("start")) / 1e3
        out[remat] = {"threads": threads, "device_ms": dev_us / 1e3,
                      "walls_before_ms": walls}
        log(f"  {arch} remat={remat}: device {dev_us / 1e3:.3f} ms, the "
            f"walls before {[round(w, 1) for w in walls]} ms; by thread "
            + "; ".join(f"{k}: span {t['span_ms']:.3f} ms, aten self "
                        f"{t['aten_self_ms']:.3f} ms, {t['launches']} "
                        f"launches, {t['events']} events"
                        for k, t in threads.items()))
        del holder, step, prof
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_train_resume(arch, mesh=None):
    """Phase 8 (d): ``train(arch=arch, scale="20m")`` crashes at step 6 (a
    checkpoint at step 4), resumes, and its losses are bit-equal to one
    uninterrupted run's; the last checkpoint restores on the CPU as on
    the card, bit for bit. Counters zeroed before the three runs, read
    after: the arch's forward and backward kernels launched. With
    ``mesh`` (phase 9 (b)) the resume restores through ``shardings=``
    onto that mesh."""
    from repro_torch import configs
    from repro_torch.device import generator_for
    from repro_torch.launch.train import scale_config, train
    from repro_torch.models import model as MDL
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.tree import tree_leaves

    kw = dict(TRAIN_RESUME, arch=arch)
    cfg = scale_config(configs.get_config(arch), kw["scale"])
    root = ROOT / "build" / "phase8_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    try:
        reset_counts()
        crashed = train(**kw, ckpt_dir=str(root / "a"),
                        simulate_failure_at=TRAIN_CRASH_AT)
        resumed = train(**kw, ckpt_dir=str(root / "a"), resume=True,
                        mesh=mesh)
        whole = train(**kw, ckpt_dir=str(root / "b"))
        launches = read_counts(TRAIN_ROUTES)
        ckpt = root / "a" / f"{arch}-{kw['scale']}"
        last = CKPT.latest_step(ckpt)
        opt = AdamW()
        a, b = (CKPT.restore_checkpoint(ckpt, last, tmpl,
                                        opt.state_shapes(tmpl), device=dev)
                for dev in (DEV, torch.device("cpu"))
                for tmpl in [MDL.init_params(generator_for(dev, 1), cfg,
                                             device=dev)])
        same = all(torch.equal(x.cpu(), y) for x, y in zip(
            tree_leaves((a[1], a[2].m, a[2].v)),
            tree_leaves((b[1], b[2].m, b[2].v))))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    start = kw["steps"] - len(resumed["losses"])
    out = {"arch": arch, "crashed_at": crashed.get("crashed_at"),
           "resumed_from": start, "losses_resumed": resumed["losses"],
           "losses_whole": whole["losses"], "last_checkpoint": last,
           "cpu_restore_equal": same, "launches": launches}
    log("  " + json.dumps({"train_resume": out}))
    if not (crashed.get("crashed_at") == TRAIN_CRASH_AT and start == 4
            and crashed["losses"] == whole["losses"][:TRAIN_CRASH_AT]
            and resumed["losses"] == whole["losses"][start:]):
        raise AssertionError(f"{arch}: resumed losses are not the "
                             f"uninterrupted run's: {out}, crashed "
                             f"{crashed['losses']}")
    if not (same and a[0] == b[0] == last):
        raise AssertionError(f"{arch}: the checkpoint restores differently "
                             "on the CPU")
    idle = [r for r in train_routes(cfg) if not launches[r]]
    if idle:
        raise AssertionError(f"{arch}: the three train runs launched "
                             f"{launches}: {idle} idle")
    log(f"  {arch}: crash at step {TRAIN_CRASH_AT}, resumed from step "
        f"{start}: losses bit-equal to the uninterrupted run's "
        f"({len(resumed['losses'])} steps); step {last}'s checkpoint "
        f"restores bit-equal on the CPU; launches {json.dumps(launches)}")
    return out, launches


def phase_train():
    """Phase 8, (a)-(d). Returns the backward kernels' rows by kernel and
    the launches of the train routes by path."""
    t0 = time.monotonic()
    rows = {"flash_attention_bwd": phase_train_kernels()}
    phase_bwd_plans()
    rows.update(phase_train_rec_kernels())
    phase_rglru_bwd_plans()
    log(f"  phase 8 (a) took {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    smoke = phase_train_smoke()
    remat = phase_train_remat()
    log(f"  phase 8 (b) took {time.monotonic() - t0:.1f} s")
    full, resume = {}, {}
    for arch in TRAIN_FULL_ARCHS:
        t0 = time.monotonic()
        _, full[arch] = phase_train_full(arch)
        log(f"  phase 8 (c) {arch} took {time.monotonic() - t0:.1f} s")
    for arch in TRAIN_RESUME_ARCHS:
        t0 = time.monotonic()
        _, resume[arch] = phase_train_resume(arch)
        log(f"  phase 8 (d) {arch} took {time.monotonic() - t0:.1f} s")
    paths = {}
    for name in TRAIN_ROUTES:
        paths[name] = {
            f"train smoke steps, {len(smoke)} archs (phase 8b)":
                sum(n[name] for n in smoke.values()),
            f"remat gradients, {len(TRAIN_REMAT_CASES)} cases (phase 8b)":
                remat[name],
            **{f"train {arch} full width (phase 8c)": n[name]
               for arch, n in full.items() if n[name]},
            **{f"train() {arch} crash + resume (phase 8d)": n[name]
               for arch, n in resume.items() if n[name]}}
    return rows, paths


# ---------------------------------------------------------------------------
# Phase 6: the live failover testbed through the entry points, on the card
# ---------------------------------------------------------------------------

def phase_testbed_smoke(archs=None, need=None):
    """tests/test_experiment.py:185's spec with ``archs`` (the default
    list when None) on the port's testbed backend, then on its sim
    backend. Every kernel counter is zeroed just before the testbed run
    and read just after; each route of ``need`` (every main-path route
    when None) must have launched."""
    from repro_torch.experiment import ExperimentSpec, run_experiment

    spec = ExperimentSpec(backend="testbed",
                          **{**TESTBED_SPEC, "archs": archs})
    reset_counts()
    t0 = time.monotonic()
    tb = run_experiment(spec)
    launches = read_counts()
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
    log("  " + json.dumps({"testbed_smoke": out, "archs": archs},
                          default=str))
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
    idle = [k for k in need or KERNELS
            if k not in STANDALONE + LATENCY_ONLY + TRAINING_ONLY
            and not launches[k]]
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
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
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
    launches = read_counts()
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


def ptxas_spills(lines):
    """``{function: spill line}`` for every function of a ptxas log whose
    spill stores or loads are not 0."""
    out, fn = {}, None
    for ln in lines:
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", ln)
        if m:
            fn = m.group(1)
        elif fn and re.search(r"[1-9]\d* bytes spill (stores|loads)", ln):
            out[fn] = ln.strip()
    return out


# the functions that must not spill, by name fragment: K1-K3, K4's chunked
# kernels, the backward kernels of K1, K3 and K4, K5's round kernel, K6's
# tensor-core kernel and its combine
NO_SPILL = {"flash_attention": ("",), "flash_attention_bwd": ("",),
            "decode_attention": ("",),
            "rglru_scan": ("",), "rwkv6_scan": ("wkv_chunk",),
            "rglru_scan_bwd": ("",), "rwkv6_scan_bwd": ("",),
            "planner_argmax": ("plan_round",),
            "int8_matmul": ("int8_mm_tc", "int8_combine")}


def phase_build():
    """Build every kernel (one nvcc each, all at once), print each
    kernel's ptxas registers and spills, fail on any spill in ``NO_SPILL``,
    and print the HMMA count of each bf16 (tensor-core) instantiation of
    K1, of every dK/dV and dQ instantiation of K1's backward (bf16 and
    f32), of K4's chunked kernels, of K4's backward kernels and of K6,
    failing if one has none."""
    from repro_torch.kernels import _build

    packages = sorted({v[0] for v in KERNELS.values()})
    t0 = time.monotonic()
    secs = _build.build(packages)
    log(f"  built {sorted(secs)} in {time.monotonic() - t0:.2f} s "
        f"(per kernel {json.dumps({k: round(v, 2) for k, v in secs.items()})})")
    for name in packages:
        lines = (_build.BUILD_DIR / f"{name}.log").read_text().splitlines()
        regs = [ln.split(":", 1)[1].strip() for ln in lines
                if "registers" in ln]
        spills = sorted({ln.strip() for ln in lines if "spill" in ln})
        log(f"  ptxas {name}: {'; '.join(regs)} | {'; '.join(spills)}")
        if name in NO_SPILL:
            spilled = {fn: ln for fn, ln in ptxas_spills(lines).items()
                       if any(part in fn for part in NO_SPILL[name])}
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
    dt_name = {"13__nv_bfloat16": "bf16", "f": "f32"}
    bwd = {f"{m.group(1)} {dt_name[m.group(2)]} hd {m.group(3)}": n
           for fn, n in sass_counts("flash_attention_bwd", "HMMA").items()
           for m in [re.search(r"fa_bwd_(dkdv|dq)_kernelI(13__nv_bfloat16|f)"
                               r"Li(\d+)E", fn)] if m}
    log(f"  HMMA instructions in K1's backward (dK/dV and dQ, bf16 and "
        f"f32 3xTF32): {json.dumps(bwd)}")
    if len(bwd) != 20 or not all(bwd.values()):
        raise AssertionError(f"K1's backward kernels lack tensor-core mma: "
                             f"{bwd}")
    wkv = {fn: n for fn, n in sass_counts("rwkv6_scan", "HMMA").items()
           if "wkv_chunk_state" in fn or "wkv_chunk_out" in fn}
    log(f"  HMMA instructions in K4's chunked kernels: "
        f"{json.dumps(sorted(wkv.values()))}")
    if len(wkv) != 16 or not all(wkv.values()):
        raise AssertionError(f"K4's chunked kernels lack tensor-core mma: "
                             f"{wkv}")
    wkv = {fn: n for fn, n in sass_counts("rwkv6_scan_bwd", "HMMA").items()
           if "wkv_bwd_chunk" in fn or "wkv_bwd_out" in fn}
    log(f"  HMMA instructions in K4's backward kernels (G and the "
        f"per-chunk gradients, f32 and bf16, hs 8-64): "
        f"{json.dumps(sorted(wkv.values()))}")
    if len(wkv) != 16 or not all(wkv.values()):
        raise AssertionError(f"K4's backward kernels lack tensor-core mma: "
                             f"{wkv}")
    k6 = {fn: n for fn, n in sass_counts("int8_matmul", "HMMA").items()
          if "int8_mm_tc" in fn}
    log(f"  HMMA instructions in K6's bf16 instantiations: "
        f"{json.dumps(sorted(k6.values()))}")
    if len(k6) != 4 or not all(k6.values()):
        raise AssertionError(f"K6's bf16 kernels lack tensor-core mma: {k6}")


def shard_apps():
    """Phase 6 (d)'s applications: each arch's published config, bf16."""
    from repro_torch import configs
    from repro_torch.core.variants import Application, build_ladder

    return [Application(id=f"{arch}-tp{i}", family=arch,
                        variants=build_ladder(configs.get_config(arch)),
                        critical=critical)
            for i, (arch, critical) in enumerate(SHARD_APPS)]


def shard_prompts(apps):
    rng = np.random.default_rng(SEED)
    return {a.id: rng.integers(0, a.full.config.vocab_size, SHARD_PROMPT,
                               dtype=np.int64).astype(np.int32)
            for a in apps}


def monolith_tokens(apps, prompts):
    """Each app's :full greedy tokens from an engine that
    `WorkerServer.load` built on the card, one app at a time."""
    from repro_torch.core.heartbeat import FailureDetector, WallClock
    from repro_torch.serving.server import WorkerServer

    out = {}
    for app in apps:
        w = WorkerServer("monolith", FailureDetector(WallClock()))
        w.load(app, app.full)
        out[app.id] = fresh_engine_tokens(w.engines[app.full.name],
                                          prompts[app.id])
        w.kill()
        del w
        gc.collect()
        torch.cuda.empty_cache()
    return out


def prefill_logits(eng, prompt):
    """The last position's logits of ``prompt`` on ``eng``'s params."""
    from repro_torch.models import model as MDL

    with torch.inference_mode():
        cache = MDL.init_cache(eng.cfg, 1, eng.max_len, device=eng.device)
        logits, _ = MDL.prefill(eng.params, eng.cfg,
                                torch.as_tensor(prompt,
                                                device=eng.device)[None],
                                cache)
    return logits.float()


def shard_run(policy, apps, prompts, want):
    """One full-width testbed with ``tp_degree=2`` under ``policy``: a
    non-lead member of each group killed ("auto"), or of the first group
    only ("monolith"). Counters zeroed just before the testbed is built,
    read just after it shuts down; the launches of the checks on its
    engines are taken out (the gathered engines' tokens before the kill,
    on the quiet testbed) or made after the read (the rest)."""
    from repro_torch.core.scenario import Scenario, ShardFail
    from repro_torch.core.shardgroup import degraded_name
    from repro_torch.serving.testbed import MiniTestbed

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.monotonic()
    tb = MiniTestbed(apps=apps, n_sites=3, servers_per_site=2,
                     headroom=0.35, seed=SEED + 2, tp_degree=2,
                     shard_policy=policy)
    try:
        tb.deploy()
        deploy_s = time.monotonic() - t0
        groups = {a.id: tb.shards.groups[a.id] for a in apps}
        layout = {aid: {r: m.server_id for r, m in g.members.items()}
                  for aid, g in groups.items()}
        leads = {aid: g.lead.server_id for aid, g in groups.items()}
        quiet = time.monotonic() + 60.0
        while not tb.executor.idle():
            if time.monotonic() > quiet:
                raise AssertionError("the testbed still loads a minute "
                                     "after deploy")
            time.sleep(0.05)
        before = read_counts()
        gathered = {a.id: fresh_engine_tokens(
            tb.workers[leads[a.id]].engines[a.full.name], prompts[a.id])
            for a in apps}
        checks = {k: v - before[k] for k, v in read_counts().items()}
        hit = apps if policy == "auto" else apps[:1]
        victims = {a.id: groups[a.id].members[max(groups[a.id].members)]
                   .server_id for a in hit}
        if set(victims.values()) & set(leads.values()):
            raise AssertionError(f"a victim leads a group: {layout}")
        events = [ShardFail(t=2.0 + 0.5 * i, server=sid) for i, sid in
                  enumerate(sorted(set(victims.values())))]
        res = tb.run_scenario(
            Scenario(name=f"tp-shard-{policy}", horizon=events[-1].t,
                     events=events), settle_s=120.0, client_hz=10.0)
        shard = res["shard"]
        after, engines = {}, {}
        for a in apps:
            g = groups[a.id]
            row = {"state": g.state,
                   "members": {r: m.server_id for r, m in g.members.items()},
                   "route": tb.router.lookup(a.id)}
            if g.state == "degraded":
                lead = tb.workers[g.lead.server_id]
                dv = degraded_name(a.full, len(g.members), 2)
                engines[a.id] = (lead.engines[a.full.name], lead.engines[dv])
                row["degraded_is_rebuilt"] = \
                    engines[a.id][1] is not engines[a.id][0]
            elif g.state == "live":
                engines[a.id] = tb.workers[g.lead.server_id].engines[
                    a.full.name]
            else:
                sid, vname = row["route"]
                row["resident"] = tb.workers[sid].has(vname)
                row["recovered"] = [
                    (r.recovered, r.mode, r.variant) for r in
                    res["records"] if r.app_id == a.id]
            after[a.id] = row
        wall = time.monotonic() - t0
    finally:
        tb.shutdown()
    launches = {k: v - checks[k] for k, v in read_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    for aid, eng in engines.items():
        if isinstance(eng, tuple):
            full = prefill_logits(eng[0], prompts[aid])
            deg = prefill_logits(eng[1], prompts[aid])
            after[aid].update(
                degraded_finite=bool(torch.isfinite(deg).all()),
                degraded_vs_full_max_abs=float((deg - full).abs().max()))
        else:
            after[aid]["tokens_after"] = fresh_engine_tokens(eng,
                                                             prompts[aid])
    del engines
    t = res["traffic"]
    out = {"policy": policy, "layout": layout, "victims": victims,
           "deploy_s": deploy_s, "wall_s": wall,
           "tokens_equal_monolith": {a: gathered[a] == want[a]
                                     for a in gathered},
           "after": after, "actions": shard["actions"],
           "states": shard["states"],
           "repartition_scale": shard["repartition_scale"],
           "measured": shard["measured"],
           "client_mttr_avg_s": t.client_mttr_avg,
           "availability": t.availability, "n_offered": t.n_offered,
           "refused_no_slot": res["refused_no_slot"],
           "detect_latency_s": res["detect_latency_s"],
           "load_errors": res["load_errors"],
           "max_memory_allocated_bytes": peak, "launches": launches,
           "check_launches": checks}
    log("  " + json.dumps({"testbed_tp_shard": out}, default=str))
    if res["load_errors"]:
        raise AssertionError(f"testbed errors: {res['load_errors']}")
    if gathered != want:
        raise AssertionError(f"gathered tokens {gathered} != monolith {want}")
    dead = set(victims.values())
    for a in apps:
        row, g = after[a.id], groups[a.id]
        if not dead & set(layout[a.id].values()):
            if g.state != "live":
                raise AssertionError(f"untouched group {a.id}: {row}")
        elif policy == "monolith":
            if not (g.state == "fallen-back" and row["resident"]
                    and row["recovered"]
                    and all(r[0] for r in row["recovered"])):
                raise AssertionError(f"{a.id} did not fall back: {row}")
        elif a.critical:
            if not (g.state == "degraded" and set(g.members) == {0}
                    and row["route"][0] == leads[a.id]
                    and row["degraded_finite"]
                    and row["degraded_vs_full_max_abs"] > 0
                    and row["degraded_is_rebuilt"]):
                raise AssertionError(f"{a.id} did not degrade: {row}")
        else:
            # tests/test_shardgroup.py:176-204
            if not (g.state == "live" and len(g.members) == 2
                    and victims[a.id] not in row["members"].values()
                    and row["tokens_after"] == want[a.id]):
                raise AssertionError(f"{a.id} did not reshard: {row}")
    meas = shard["measured"]
    if policy == "auto":
        if not (meas["slice_fetch_s"]["n"] >= 1
                and meas["reshard_mttr_s"]["n"] >= 1
                and meas["reshard_mttr_s"]["avg_s"] > 0
                and meas["degrade_rebuild_s"]["n"] >= 1
                and shard["repartition_scale"] != 1.0):
            raise AssertionError(f"measured {meas}, scale "
                                 f"{shard['repartition_scale']}")
    need = ("flash_attention", "decode_attention", "rwkv6_chunked",
            "rwkv6_scan") + (("planner_round",) if policy == "monolith"
                             else ())
    idle = [k for k in need if not launches[k]]
    if idle:
        raise AssertionError(f"{idle} never launched in the {policy} run")
    log(f"  {policy}: gathered tokens == monolith load's; states "
        f"{json.dumps(shard['states'])}, actions "
        f"{json.dumps(shard['actions'])}, repartition scale "
        f"{shard['repartition_scale']:.6f}; client MTTR "
        f"{t.client_mttr_avg * 1e3:.2f} ms, availability "
        f"{t.availability:.6f} of {t.n_offered} requests "
        f"({res['refused_no_slot']} refused for want of a free batch "
        f"slot); max_memory_allocated {peak / 2**30:.3f} GiB; run "
        f"{wall:.1f} s; launches {json.dumps(launches)} (the checks' "
        f"own apart: {json.dumps(checks)})")
    for k, v in meas.items():
        log(f"    measured {k}: n {v['n']}, avg {v['avg_s']:.6f} s, max "
            f"{v['max_s']:.6f} s")
    return out, launches


def phase_testbed_shard():
    """Phase 6 (d): runs under "auto" and "monolith"; the launches of
    both, summed."""
    apps = shard_apps()
    prompts = shard_prompts(apps)
    want = monolith_tokens(apps, prompts)
    auto, n_auto = shard_run("auto", apps, prompts, want)
    mono, n_mono = shard_run("monolith", shard_apps(), prompts, want)
    return ({"auto": auto, "monolith": mono},
            {k: n_auto[k] + n_mono[k] for k in n_auto})


# ---------------------------------------------------------------------------
# Phase 9: launch and layout — the local mesh, the elastic restore on the
# card, the dry run's accounting held against the card, the full-size sweep
# ---------------------------------------------------------------------------

LAYOUT_ARCH = "qwen2.5-3b"
LAYOUT_RESUME_ARCH = "rwkv6-3b"
# (c): qwen2.5-3b's published config on the (1, 1) mesh, at shapes cut
# from SHAPES to fit one card: prefill_32k's B 32 -> 1 and S 32768 ->
# 4096, decode_32k's B 128 -> 32 and cache 32768 -> 4096, train_4k's B
# 256 -> 2 at its own S of 4096 (with the config's remat, as the JAX
# step: without it S 2048 alone peaked at 66 GiB)
LAYOUT_CELLS = (("prefill_32k", "prefill", 4096, 1),
                ("decode_32k", "decode", 4096, 32),
                ("train_4k", "train", 4096, 2))
LAYOUT_TIMED = 10                  # step timings, median of
DRYRUN_SUMMARY = "dry-run summary: 33 ok, 0 failed, 7 skipped"
DRYRUN_WAIT_S = 400    # (d) waits at most this long after phase 10


def start_dryrun():
    """Phase 9 (d)'s sweep, ``python -m repro_torch.launch.dryrun --all
    --no-save`` (33 cells of meta traces, a process a host core), started
    in the background at the lowest CPU priority so that it runs beside
    (b), which keeps the card and the disk busy."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen(
        ["nice", "-n", "19", sys.executable, "-m", "repro_torch.launch.dryrun",
         "--all", "--no-save"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)


def stop_dryrun(proc):
    """Kill the sweep and its worker processes (its session)."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()


def phase_local_mesh():
    """(a): ``make_local_mesh()`` is a (1, 1) ("data", "model") mesh over
    cuda:0 with its process group of one; ``current_mesh()`` returns it
    inside ``with`` and None outside."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as SH
    mesh = make_local_mesh()
    if not (mesh.device_type == "cuda"
            and tuple(mesh.mesh_dim_names) == ("data", "model")
            and tuple(mesh.mesh.shape) == (1, 1)
            and dist.get_world_size() == 1 and dist.get_backend() == "nccl"):
        raise AssertionError(f"the local mesh is {mesh}, backend "
                             f"{dist.get_backend()}")
    if SH.current_mesh() is not None:
        raise AssertionError("a mesh is current outside every scope")
    with mesh:
        inside = SH.current_mesh()
    if inside is not mesh or SH.current_mesh() is not None:
        raise AssertionError(f"current_mesh gave {inside} inside the "
                             "local mesh's scope")
    log(f"  (a) {mesh}: backend {dist.get_backend()}, world "
        f"{dist.get_world_size()}; current_mesh() is it inside with, None "
        "outside")
    return mesh


def phase_layout_restore(mesh):
    """(b): qwen2.5-3b's full-width bf16 params as the worker draws them,
    saved, restored through ``shardings=param_shardings(param_shapes(cfg),
    mesh, serving=True)``: each local shard bit-equal to the saved leaf,
    and an engine on ``local_tree`` of them gives the greedy tokens of an
    engine on the params never saved, for phase 4's first prompt (K1, K2
    launched, counted). Then phase 8 (d)'s crash and resume of rwkv6-3b
    with the resume's restore through ``shardings=`` on the mesh. Returns
    the launches by path."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.core.variants import Application, build_ladder
    from repro_torch.models import model as MDL
    from repro_torch.parallel import sharding as SH
    from repro_torch.serving.engine import InferenceEngine, Request
    from repro_torch.serving.server import draw_params
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.tree import tree_leaves

    cfg = configs.get_config(LAYOUT_ARCH)
    app = Application(id=f"{LAYOUT_ARCH}/app0", family=cfg.name,
                      variants=build_ladder(cfg))
    params = draw_params(app.full, DEV)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 257, SLOTS)
    prompt = rng.integers(0, cfg.vocab_size, lens[0]).astype(np.int32)
    root = ROOT / "build" / "phase9_checkpoint"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.monotonic()
        CKPT.save_checkpoint(root, 0, params)
        t_save = time.monotonic() - t0
        tmpl = MDL.param_shapes(app.full.config)
        t0 = time.monotonic()
        _, restored, _, _ = CKPT.restore_checkpoint(
            root, 0, tmpl, shardings=SH.param_shardings(tmpl, mesh,
                                                        serving=True))
        torch.cuda.synchronize()
        t_restore = time.monotonic() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    leaves = tree_leaves(restored)
    if not all(isinstance(t, DTensor) and t.device_mesh is mesh
               for t in leaves):
        raise AssertionError("a restored leaf is not a DTensor on the mesh")
    same = sum(torch.equal(a, b.to_local())
               for a, b in zip(tree_leaves(params), leaves))
    if same != len(leaves):
        raise AssertionError(f"{len(leaves) - same} of {len(leaves)} "
                             "restored leaves differ from the saved ones")

    def tokens(p):
        eng = InferenceEngine(app.full.config, p, batch_slots=SLOTS,
                              max_len=MAX_LEN, device=DEV)
        r = Request(id="r", prompt=prompt, max_new_tokens=NEW_TOKENS)
        if not eng.try_admit(r):
            raise AssertionError("an engine refused a request")
        while eng.active_count():
            eng.step()
        return r.tokens

    reset_counts()
    want = tokens(params)
    got = tokens(CKPT.local_tree(restored))
    launches = read_counts(("flash_attention", "decode_attention"))
    if got != want or len(got) != NEW_TOKENS + 1:
        raise AssertionError(f"the restored engine's tokens {got} are not "
                             f"the original's {want}")
    idle = [k for k, n in launches.items() if not n]
    if idle:
        raise AssertionError(f"(b)'s engines launched {launches}: {idle} "
                             "idle")
    log(f"  (b) {LAYOUT_ARCH} full width bf16: {len(leaves)} leaves saved in "
        f"{t_save:.3f} s, restored through shardings= onto {mesh} in "
        f"{t_restore:.3f} s, every local shard bit-equal; greedy tokens "
        f"equal ({len(got)}) for a {len(prompt)}-token prompt; launches "
        f"{json.dumps(launches)}")
    del params, restored, leaves
    gc.collect()
    torch.cuda.empty_cache()
    _, resume = phase_train_resume(LAYOUT_RESUME_ARCH, mesh=mesh)
    paths = {k: {f"restored {LAYOUT_ARCH} engine (phase 9b)": n}
             for k, n in launches.items()}
    for k, n in resume.items():
        if n:
            paths.setdefault(k, {})[
                f"train() {LAYOUT_RESUME_ARCH} resume onto the mesh "
                "(phase 9b)"] = n
    return paths


def requested_bytes(stat="current"):
    """The caching allocator's requested bytes (``current`` or ``peak``):
    what callers asked for, before its rounding."""
    return torch.cuda.memory_stats()[f"requested_bytes.all.{stat}"]


def placed_bytes(make):
    """The caching allocator's growth over ``make()``: (bytes allocated,
    bytes requested, what ``make`` made)."""
    def now():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(), requested_bytes()
    a0, r0 = now()
    out = make()
    a1, r1 = now()
    return a1 - a0, r1 - r0, out


def alloc_slack(tensors):
    """How far ``memory_allocated`` may exceed the requested bytes of
    ``tensors``: the dry run's ``block_slack`` of each (512 bytes of
    rounding a block, and up to 1 MiB more for a block over 1 MiB, whose
    segment's rest the allocator does not split off)."""
    from repro_torch.launch.dryrun import block_slack
    return sum(block_slack(t.numel() * t.element_size()) for t in tensors)


def phase_layout_accounting(mesh):
    """(c): for each of ``LAYOUT_CELLS``, ``lower_cell`` on the mesh, its
    per-device argument bytes against the allocator's growth when the same
    params (drawn on the card), AdamW state or cache, and batch are placed
    (requested bytes equal, allocated within ``alloc_slack``), and the real step's time (CUDA events
    around the eager call, median of ``LAYOUT_TIMED``) against
    max(model flops / PEAK_FLOPS, argument bytes / HBM_BW), and the step's
    own peak (the allocator's peak over the timed runs less its count just
    before them) against the record's bounds: at or under ``temp_bytes``
    in requested bytes, and at or under ``temp_bytes + temp_alloc_slack``
    in allocated bytes. Returns the rows and the steps' launches."""
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.device import generator_for
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.models import model as MDL
    from repro_torch.training.optimizer import AdamW

    cfg = configs.get_config(LAYOUT_ARCH)
    rows, launches = {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    for name, kind, seq, batch in LAYOUT_CELLS:
        cell = ShapeCell(name, kind, seq, batch)
        tag = f"{name} cut to B={batch} S={seq}"
        t0 = time.monotonic()
        rec = D.lower_cell(LAYOUT_ARCH, cell, mesh)
        t_dry = time.monotonic() - t0
        want = rec["memory"]["argument_bytes"]
        opt = AdamW()
        held = []

        def make(cell=cell, opt=opt):
            p = MDL.init_params(generator_for(DEV, SEED), cfg, device=DEV)
            st = (opt.init(p) if cell.kind == "train" else
                  MDL.init_cache(cfg, cell.global_batch, cell.seq_len,
                                 device=DEV))
            g = torch.Generator(device=DEV).manual_seed(SEED)
            shape = ((cell.global_batch,) if cell.kind == "decode" else
                     (cell.global_batch, cell.seq_len))
            b = {k: torch.randint(0, cfg.vocab_size, shape, generator=g,
                                  device=DEV, dtype=torch.int32)
                 for k in (("tokens", "labels") if cell.kind == "train"
                           else ("tokens",))}
            held.extend(D._leaves((p, st, b)))
            return p, st, b

        grown, asked, (params, state, batch_) = placed_bytes(make)
        n_t, slack = len(held), alloc_slack(held)
        if asked != want or not 0 <= grown - want <= slack:
            raise AssertionError(f"{tag}: {asked} bytes requested and "
                                 f"{grown} allocated for {n_t} tensors "
                                 f"(slack {slack}), the dry run reckons "
                                 f"{want}")
        step = D._cell_step(cfg, cell, opt, 1)
        if kind == "train":
            def run():
                step(params, state, batch_)
        elif kind == "prefill":
            def run():
                state["pos"].zero_()
                step(params, state, batch_)
        else:
            def run():
                state["pos"].fill_(seq - 2 * (LAYOUT_TIMED + 2))
                step(params, state, batch_)
        reset_counts()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        asked_before = requested_bytes()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode(kind != "train"):
            ms = eager_ms(run, n=LAYOUT_TIMED, warmup=2)
        step_peak = torch.cuda.max_memory_allocated() - before
        step_asked = requested_bytes("peak") - asked_before
        temp = rec["memory"]["temp_bytes"]
        temp_slack = rec["memory"]["temp_alloc_slack"]
        launches[tag] = read_counts(("flash_attention", "decode_attention",
                                     "flash_attention_bwd"))
        r = rec["roofline"]
        floor_s = max(r["model_flops"] / H.PEAK_FLOPS, want / H.HBM_BW)
        row = {"argument_bytes": want, "requested_growth": asked,
               "allocated_growth": grown, "allocator_slack": slack,
               "tensors": n_t, "temp_bytes": temp,
               "temp_alloc_slack": temp_slack,
               "step_peak_bytes": step_peak,
               "step_peak_requested_bytes": step_asked, "measured_ms": ms,
               "floor_ms": floor_s * 1e3, "compute_ms": r["compute_s"] * 1e3,
               "memory_ms": r["memory_s"] * 1e3,
               "useful_flop_frac": r["useful_flop_frac"],
               "global_flops": rec["cost"]["global_flops"],
               "global_bytes": rec["cost"]["global_bytes"],
               "dry_run_s": t_dry}
        rows[tag] = row
        log(f"  (c) {tag}: argument bytes {want} reckoned, {asked} "
            f"requested, {grown} allocated ({n_t} tensors, +{grown - want} "
            f"of the allocator's {slack}); step "
            f"{ms:.3f} ms measured against the floor "
            f"{floor_s * 1e3:.3f} ms (model flops / peak, argument bytes "
            f"/ HBM), the trace's compute_s {r['compute_s'] * 1e3:.3f} ms "
            f"and memory_s {r['memory_s'] * 1e3:.3f} ms (unfused), "
            f"useful_flop_frac {r['useful_flop_frac']:.3f}; the step's "
            f"own peak {step_asked} bytes requested against temp_bytes "
            f"{temp}, {step_peak} allocated against temp_bytes + "
            f"temp_alloc_slack {temp + temp_slack}; dry run {t_dry:.1f} s; "
            f"launches {json.dumps(launches[tag])}")
        if ms < floor_s * 1e3:
            raise AssertionError(f"{tag}: the step took {ms:.3f} ms, under "
                                 f"its floor {floor_s * 1e3:.3f} ms: the "
                                 "roofline is miscounted")
        # the trace reckons storages' bytes, as the allocator's requested
        # bytes count them (the argument check above matches the two
        # exactly); what the card holds, its allocated bytes, adds each
        # block's rounding and the unsplit rest of a large block's segment,
        # which the trace bounds by ``temp_alloc_slack``
        if step_asked > temp or step_peak > temp + temp_slack:
            raise AssertionError(
                f"{tag}: the step's own peak, {step_asked} bytes requested "
                f"and {step_peak} allocated, exceeds temp_bytes {temp} or "
                f"temp_bytes + temp_alloc_slack {temp + temp_slack}, which "
                "claim to bound it")
        if not launches[tag]["flash_attention" if kind != "decode"
                             else "decode_attention"]:
            raise AssertionError(f"{tag}: no attention kernel launched")
        del params, state, batch_, held, run
        gc.collect()
        torch.cuda.empty_cache()
    return rows, launches


def phase_layout_dryrun(proc):
    """(d): the sweep started by ``start_dryrun`` must end with rc 0 and
    ``DRYRUN_SUMMARY``; each cell's line is logged."""
    try:
        out, _ = proc.communicate(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        stop_dryrun(proc)
        raise AssertionError(f"the dry run did not end within "
                             f"{DRYRUN_WAIT_S} s of phase 10")
    for line in out.splitlines():
        if line.strip():
            log(f"  (d) {line}")
    if proc.returncode != 0 or DRYRUN_SUMMARY not in out:
        raise AssertionError(f"the dry run exited {proc.returncode} without "
                             f"'{DRYRUN_SUMMARY}'")


# ---------------------------------------------------------------------------
# Phase 10: the example ports through their own entry points
# ---------------------------------------------------------------------------

# each example port at its smallest settings, in a process of its own
EXAMPLE_RUNS = (("quickstart", ()), ("failure_storm", ()),
                ("site_failure_sim", ()),
                ("train_lm", ("--scale", "toy", "--steps", "50")),
                ("edge_failover", ("--settle", "2")))
# the simulator examples, run again with --device cpu: the same output
SIM_EXAMPLES = ("quickstart", "failure_storm", "site_failure_sim")
# the live testbed's heartbeats run on a wall clock: it runs alone, after
# the others, which run at once
ALONE = "edge_failover"
# what an example's output must hold
EXAMPLE_MARKS = {"edge_failover": ("recovery: 100%", "detected in"),
                 "train_lm": ("resumed from step 25", "final loss:")}
EXAMPLE_TIMEOUT_S = 300


def start_example(name, args):
    """``examples/<name>_torch.py`` with ``args`` in a subprocess."""
    return subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"), *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_example(name, args, proc, t0):
    """Wait for ``proc``; it must exit 0 and print ``EXAMPLE_MARKS``.
    Returns its output."""
    out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
    tail = out.strip().splitlines()[-4:]
    log(f"  examples/{name}_torch.py {' '.join(args)}: exit "
        f"{proc.returncode} after {time.monotonic() - t0:.1f} s; "
        + " | ".join(tail))
    if proc.returncode != 0:
        raise AssertionError(f"examples/{name}_torch.py {' '.join(args)} "
                             f"exited {proc.returncode}: {err[-3000:]}")
    missing = [m for m in EXAMPLE_MARKS.get(name, ()) if m not in out]
    if missing:
        raise AssertionError(f"examples/{name}_torch.py printed no "
                             f"{missing}: {out[-3000:]}")
    return out


def phase_examples():
    """Phase 10: each of ``EXAMPLE_RUNS`` on the card in a subprocess must
    exit 0 (and print ``EXAMPLE_MARKS``), ``ALONE`` after the others;
    each simulator example's output must equal that of its ``--device
    cpu`` run, started beside them."""
    cpu_args = ("--device", "cpu")
    t0 = time.monotonic()
    procs = {(name, args): start_example(name, args)
             for name, args in EXAMPLE_RUNS if name != ALONE}
    procs.update({(name, cpu_args): start_example(name, cpu_args)
                  for name in SIM_EXAMPLES})
    try:
        outs = {key: finish_example(*key, proc, t0)
                for key, proc in procs.items()}
        for name, args in EXAMPLE_RUNS:
            if name == ALONE:
                t0 = time.monotonic()
                finish_example(name, args, start_example(name, args), t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for name in SIM_EXAMPLES:
        card, cpu = outs[(name, ())], outs[(name, cpu_args)]
        if card != cpu:
            raise AssertionError(f"examples/{name}_torch.py on the card "
                                 f"printed\n{card}\nand with --device "
                                 f"cpu\n{cpu}")
        log(f"  examples/{name}_torch.py: the card's {len(card.splitlines())}"
            " lines equal the CPU's")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist
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
    scan_launches = phase_scan_path()
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
            n_kern = serves[arch]["A_profile"][name]["device_kernels"]
            log(f"  {name} on {arch}:full: host wall {wall:.3f} ms, device "
                f"{devt:.3f} ms, device idle share {1 - devt / wall:.3f}, "
                f"device kernels a call {n_kern:.1f}")
        log(f"  phase 4 {arch} took {time.monotonic() - t0:.1f} s")
    log("phase 4 (w): whisper-medium's encoder-decoder path at full width")
    t0 = time.monotonic()
    whisper, whisper_launches = phase_whisper()
    log("  " + json.dumps({"whisper": whisper}))
    log(f"  phase 4 (w) took {time.monotonic() - t0:.1f} s")

    log("phase 5: the simulator's failover planning on the card (K5)")
    t0 = time.monotonic()
    rows["planner_argmax"] = phase_argmax()
    phase_planner()
    (_, k5_launches, round_row_, argmax_launches, failover_inputs,
     greedy_records) = phase_sim()
    rows["planner_round"] = {KERNELS["planner_round"][3]: round_row_}
    log(f"  phase 5 took {time.monotonic() - t0:.1f} s")

    log("phase 6: the live failover testbed on the card")
    t0 = time.monotonic()
    _, tb_smoke = phase_testbed_smoke()
    log(f"  phase 6 (a) took {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    _, tb_full = phase_testbed_full()
    log(f"  phase 6 (b) took {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    # the four decoder-only archs beyond the testbed's five; the spec's
    # plans load only their smoke :full rungs, none of the :w075 (3 query
    # heads on 2 KV heads, R8)
    _, tb_new = phase_testbed_smoke(
        list(NEW_ARCHS), ("flash_attention", "decode_attention",
                          "planner_round"))
    log(f"  phase 6 (c) took {time.monotonic() - t0:.1f} s")
    log("phase 6 (d): the testbed's tensor-parallel shard plane at full "
        "width")
    t0 = time.monotonic()
    _, tb_shard = phase_testbed_shard()
    log(f"  phase 6 (d) took {time.monotonic() - t0:.1f} s")

    log("phase 7: the planning and protection plane on the card")
    t0 = time.monotonic()
    masked_row, plane_paths = phase_plane(failover_inputs, greedy_records)
    rows["planner_round_masked"] = {
        KERNELS["planner_round_masked"][3]: masked_row}
    log(f"  phase 7 took {time.monotonic() - t0:.1f} s")

    log("phase 8: training on the card")
    t0 = time.monotonic()
    train_rows, train_paths = phase_train()
    rows.update(train_rows)
    log(f"  phase 8 took {time.monotonic() - t0:.1f} s")

    # phase 9: (a) and (c) on a quiet host, then (d)'s sweep in the
    # background beside (b) and phase 10, whose subprocesses leave the
    # host's cores to it while they start
    log("phase 9: launch and layout on the card")
    t0 = time.monotonic()
    mesh = phase_local_mesh()
    layout_rows, layout_steps = phase_layout_accounting(mesh)
    log(f"  phase 9 (a) and (c) took {time.monotonic() - t0:.1f} s")
    dryrun = start_dryrun()
    try:
        t0 = time.monotonic()
        layout_paths = phase_layout_restore(mesh)
        log(f"  phase 9 (b) took {time.monotonic() - t0:.1f} s, beside the "
            "sweep")
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 10: the example ports on the card, beside phase 9 "
            "(d)'s sweep")
        t0 = time.monotonic()
        phase_examples()
        log(f"  phase 10 took {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        phase_layout_dryrun(dryrun)
        log(f"  phase 9 (d) waited {time.monotonic() - t0:.1f} s for the "
            "sweep")
    finally:
        stop_dryrun(dryrun)
    for tag, n in layout_steps.items():
        for k, v in n.items():
            if v:
                layout_paths.setdefault(k, {})[
                    f"{LAYOUT_ARCH} {tag} (phase 9c)"] = v
    log("  " + json.dumps({"layout": layout_rows}))

    kernels = []
    for name, (_pkg, src, replaces, headline) in KERNELS.items():
        r = rows[name][headline]
        if name == "int8_matmul":
            by_path = {INT8_PATH: k6_launches}
        elif name == "rglru_scan":
            by_path = {SCAN_PATH: scan_launches}
        elif name == "planner_argmax":
            by_path = {ARGMAX_PATH: argmax_launches}
        elif name in TRAINING_ONLY:
            by_path = dict(train_paths[name])
            by_path.update(layout_paths.get(name, {}))
        else:
            by_path = {f"{arch}:{tag}": n[name]
                       for arch, runs in launches.items()
                       for tag, n in runs.items() if n.get(name)}
            if name == "planner_round":
                by_path[f"sim {SIM_CELL['scenario']} torch"] = k5_launches
            if name in whisper_launches:
                by_path["whisper-medium:full (phase 4w)"] = \
                    whisper_launches[name]
            by_path["testbed smoke (phase 6a)"] = tb_smoke[name]
            by_path["testbed full width (phase 6b)"] = tb_full[name]
            if tb_new[name]:
                by_path["testbed, qwen1.5/gemma3/llava/arctic (phase 6c)"] = \
                    tb_new[name]
            if tb_shard[name]:
                by_path["testbed TP shard (phase 6d)"] = tb_shard[name]
            by_path.update(plane_paths.get(name, {}))
            by_path.update(train_paths.get(name, {}))
            by_path.update(layout_paths.get(name, {}))
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
                                             "bound_by", "max_abs_err",
                                             "before_ms", "cold_ms",
                                             "per_app_us", "n_split",
                                             "unmasked_ms", "fwd_bwd_ms",
                                             "rel_err", "split", "blocks")
                           if k in x}
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
