"""Heterogeneous variant ladders — FailLite's core object.

A copy of ``repro/core/variants.py`` (the port imports nothing from
``repro``); ``tests/test_torch_control.py`` holds it against the original.

Every served architecture derives a ladder of smaller variants (width-
scaled, depth-scaled, weight-only int8) with profiled memory, compute
cost, normalized accuracy, and load time.  The accuracy proxy is
calibrated to the paper's Fig. 2a shape: accuracy falls very slowly as
capacity shrinks (ConvNeXt-T is 5.1x smaller than -L for -1.89%:
a = ratio^k with k ≈ 0.012); quantization adds a small constant penalty
(int8 ≈ -0.3%, cf. the quantization literature the paper cites).

Load time follows Fig. 2b: bytes / (host->HBM bandwidth) + warmup.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.models.config import ModelConfig

ACC_EXP = 0.012          # Fig 2a calibration: acc = capacity_ratio ** k
INT8_PENALTY = 0.003
LOAD_BW = 8e9            # bytes/s host->HBM (profiled on testbed, see fig2)
WARMUP_S = 0.040         # per-instance compile/alloc warmup


@dataclass(frozen=True)
class Variant:
    name: str
    family: str                   # app/model family id (arch name)
    mem_bytes: float              # accelerator-resident bytes
    compute: float                # fraction of a cell's compute at rate q=1
    accuracy: float               # normalized to the family's full model
    quant_bits: int = 16
    width_mult: float = 1.0
    depth_mult: float = 1.0
    config: Optional[ModelConfig] = None

    @property
    def demand(self) -> Dict[str, float]:
        return {"mem": self.mem_bytes, "compute": self.compute}

    @property
    def demand_vec(self):
        """Cached demand vector in `cluster.RESOURCES` order
        (("mem", "compute") — asserted by tests/test_scale.py).

        `demand` builds a fresh dict per access, and the planner's
        worst-fit rebuilt an array from it once per placement attempt
        on the failover hot path; this caches the array on the frozen
        instance instead. Variants are immutable, so the cache can
        never go stale — treat the returned array as read-only."""
        v = self.__dict__.get("_demand_vec")
        if v is None:
            v = np.array([self.mem_bytes, self.compute], np.float64)
            object.__setattr__(self, "_demand_vec", v)
        return v

    def load_time(self, bw: float = LOAD_BW) -> float:
        return self.mem_bytes / bw + WARMUP_S


def _scaled_config(cfg: ModelConfig, width: float, depth: float,
                   bits: int) -> ModelConfig:
    def r8(x, m):     # round to multiple of m, >= m
        return max(m, int(round(x / m)) * m)

    d = r8(cfg.d_model * width, 64)
    heads = max(1, int(round(cfg.num_heads * width))) if cfg.num_heads else 0
    kvh = max(1, min(cfg.num_kv_heads, heads)) if cfg.num_kv_heads else 0
    if heads and cfg.num_kv_heads:
        kvh = max(1, int(round(cfg.num_kv_heads * width)))
    plen = len(cfg.block_pattern)
    layers = max(plen, int(round(cfg.num_layers * depth / plen)) * plen)
    kw = dict(
        num_layers=layers,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kvh,
        d_ff=r8(cfg.d_ff * width, 64),
        rnn_width=r8(cfg.rnn_width * width, cfg.rnn_blocks * 8)
        if cfg.rnn_width else 0,
        quant_bits=bits,
        width_mult=width,
        depth_mult=depth,
    )
    if cfg.num_experts:
        kw["moe_d_ff"] = r8(cfg.moe_d_ff * width, 64)
        kw["num_experts"] = max(cfg.top_k,
                                int(round(cfg.num_experts * width)))
    if cfg.dense_residual_d_ff:
        kw["dense_residual_d_ff"] = r8(cfg.dense_residual_d_ff * width, 64)
    if cfg.is_encoder_decoder:
        kw["num_encoder_layers"] = max(1, int(round(
            cfg.num_encoder_layers * depth)))
        kw["num_decoder_layers"] = max(1, int(round(
            cfg.num_decoder_layers * depth)))
        kw["num_layers"] = kw["num_encoder_layers"] + kw["num_decoder_layers"]
    return cfg.replace(**kw)


# ladder steps: (tag, width, depth, bits)
LADDER_STEPS = [
    ("full", 1.0, 1.0, 16),
    ("w075", 0.75, 1.0, 16),
    ("w050", 0.5, 1.0, 16),
    ("d050", 1.0, 0.5, 16),
    ("int8", 1.0, 1.0, 8),
    ("w050-int8", 0.5, 1.0, 8),
    ("w025", 0.25, 1.0, 16),
]


def build_ladder(cfg: ModelConfig, *, cell_mem: float = 16e9,
                 cell_flops: float = 197e12) -> List[Variant]:
    """Variant ladder for one architecture, largest to smallest."""
    full_active = None
    out = []
    for tag, w, dpt, bits in LADDER_STEPS:
        vcfg = _scaled_config(cfg, w, dpt, bits)
        mem = vcfg.param_bytes() * 1.15          # +15% runtime buffers
        active = vcfg.active_param_count()
        if full_active is None:
            full_active = active
        ratio = active / full_active
        acc = ratio ** ACC_EXP
        if bits == 8:
            acc -= INT8_PENALTY
        compute = 2.0 * active / cell_flops      # cell-seconds per token
        out.append(Variant(
            name=f"{cfg.name}:{tag}", family=cfg.name, mem_bytes=mem,
            compute=compute * 1e3,               # per 1k req/s unit rate
            accuracy=acc, quant_bits=bits, width_mult=w, depth_mult=dpt,
            config=vcfg))
    out.sort(key=lambda v: -v.mem_bytes)
    return out


@dataclass
class Application:
    """One served model = the paper's 'application'."""
    id: str
    family: str
    variants: List[Variant]          # sorted large -> small
    request_rate: float = 1.0        # q_i
    latency_slo: float = math.inf    # L_i (seconds)
    critical: bool = False           # i in K

    @property
    def full(self) -> Variant:
        return self.variants[0]

    @property
    def smallest(self) -> Variant:
        return self.variants[-1]

    def variant_by_name(self, name: str) -> Variant:
        for v in self.variants:
            if v.name == name:
                return v
        raise KeyError(name)

    def demand_matrix(self) -> np.ndarray:
        """Cached (n_variants, len(RESOURCES)) demand matrix, rows
        large -> small — the planner's per-round `_demand_matrix`
        rebuilt this on every call. The variants list is never mutated
        after construction; treat the array as read-only."""
        dm = self.__dict__.get("_demand_matrix")
        if dm is None:
            dm = np.array([[v.mem_bytes, v.compute] for v in self.variants],
                          np.float64)
            self.__dict__["_demand_matrix"] = dm
        return dm


def synthetic_family(name: str, full_mem: float, n_variants: int = 4,
                     spread: float = 4.0) -> List[Variant]:
    """Profile-only ladder (no ModelConfig) for large-scale simulation.

    `spread` = mem ratio between largest and smallest (the paper's
    Small/Medium/Large family classes differ exactly in this spread).
    """
    out = []
    for i in range(n_variants):
        ratio = spread ** (-i / max(1, n_variants - 1))
        mem = full_mem * ratio
        acc = ratio ** ACC_EXP
        out.append(Variant(
            name=f"{name}:v{i}", family=name, mem_bytes=mem,
            compute=mem / 32e9, accuracy=acc))   # ~50% compute at 50% mem
    return out
