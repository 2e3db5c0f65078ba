"""Model configuration, copied from ``repro/models/config.py``.

The fields and sizing arithmetic are the JAX package's, so variant
ladders price the same bytes; only the dtype accessors differ: ``pdtype``
and ``adtype`` return torch dtypes through ``torch_dtype``.

Original docstring:

One frozen dataclass covers all 10 assigned architecture families:
dense GQA transformers (qwen*, gemma3, llava backbone), MoE (qwen3-moe,
arctic), hybrid recurrent (recurrentgemma), attention-free (rwkv6) and
encoder-decoder (whisper).  Family-specific behaviour is selected by
``block_pattern`` / ``family`` rather than subclassing, so configs stay
declarative and serializable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

# Layer kinds usable in ``block_pattern`` (cycled over the layer stack):
#   "global"     full (causal) attention + FFN
#   "local"      sliding-window causal attention + FFN
#   "rglru"      RG-LRU recurrent block + FFN            (RecurrentGemma)
#   "rwkv"       RWKV-6 time-mix + channel-mix           (Finch)
#   "moe"        attention + top-k MoE FFN
#   "moe_dense"  attention + dense-FFN residual + MoE    (Arctic)
LAYER_KINDS = ("global", "local", "rglru", "rwkv", "moe", "moe_dense")

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """torch dtype for a ``param_dtype``/``activation_dtype`` string."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- layer stack -------------------------------------------------------
    block_pattern: Tuple[str, ...] = ("global",)
    window_size: int = 4096          # sliding window for "local" layers

    # --- attention flavour -------------------------------------------------
    qk_norm: bool = False            # qwen3 / gemma3
    qkv_bias: bool = False           # qwen1.5 / qwen2.5
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0    # gemma3: different theta on local layers
    logit_softcap: float = 0.0       # gemma-style final-logit softcap (0=off)
    scale_embedding: bool = False    # gemma-style sqrt(d) embedding scale

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    dense_residual_d_ff: int = 0     # Arctic: dense FFN residual next to MoE
    capacity_factor: float = 1.25

    # --- recurrent (rglru / rwkv) ------------------------------------------
    rnn_width: int = 0               # RG-LRU recurrent width (lru_width)
    rnn_blocks: int = 8              # block-diagonal gate blocks (Griffin)
    conv1d_width: int = 4            # temporal conv in recurrent block
    rwkv_head_size: int = 64

    # --- encoder-decoder ----------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    num_decoder_layers: int = 0
    encoder_seq_len: int = 1500      # whisper frame count after conv stub

    # --- multimodal stub -----------------------------------------------------
    num_patch_tokens: int = 0        # llava: image-patch prefix length

    # --- numerics / implementation -----------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    use_pallas: bool = False         # kernels (interpret-mode on CPU tests)

    # --- variant ladder metadata (FailLite heterogeneous replication) ------
    width_mult: float = 1.0          # applied scaling vs. the full model
    depth_mult: float = 1.0
    quant_bits: int = 16             # 16 = bf16, 8 = weight-only int8

    def __post_init__(self):
        for k in self.block_pattern:
            if k not in LAYER_KINDS:
                raise ValueError(f"unknown layer kind {k!r}")
        if self.family == "moe" and self.num_experts <= 0:
            raise ValueError("moe family requires num_experts > 0")

    # -- derived ------------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return all(k in ("rwkv",) for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer kind attends to unbounded full history."""
        return all(k in ("local", "rglru", "rwkv") for k in self.block_pattern)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.activation_dtype)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Concrete per-layer kind list, cycling block_pattern."""
        n = self.num_layers
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(n))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- sizing (used by the FailLite variant ladder & roofline napkin math) -
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + norms)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        embed = v * d
        unembed = 0 if self.tie_embeddings else v * d
        total = embed + unembed + d  # final norm

        def attn_params() -> int:
            p = d * h * hd + 2 * d * kv * hd + h * hd * d
            if self.qkv_bias:
                p += h * hd + 2 * kv * hd
            if self.qk_norm:
                p += 2 * hd
            return p

        def ffn_params(width: int) -> int:
            return 3 * d * width  # SwiGLU: gate, up, down

        kinds = self.layer_kinds()
        if self.is_encoder_decoder:
            # encoder: self-attn + ffn; decoder: self + cross + ffn (GELU mlp)
            enc = self.num_encoder_layers * (attn_params() + 2 * d * ff + 2 * d)
            dec = self.num_decoder_layers * (2 * attn_params() + 2 * d * ff + 3 * d)
            return total + enc + dec

        for kind in kinds:
            total += 2 * d  # pre norms
            if kind in ("global", "local"):
                total += attn_params() + ffn_params(ff)
            elif kind == "rglru":
                w = self.rnn_width or d
                # x/gate in-projections, temporal conv, block-diagonal
                # recurrence/input gates (W_a, W_x), Λ, out-proj, shared FFN.
                nb = self.rnn_blocks
                total += 2 * d * w + self.conv1d_width * w
                total += 2 * nb * (w // nb) ** 2 + w
                total += w * d
                total += ffn_params(ff)
            elif kind == "rwkv":
                hs = self.rwkv_head_size
                nh = d // hs
                # time-mix: r,k,v,g,o projections + decay MLPs; channel-mix
                total += 5 * d * d + 2 * d * 64 + 64 * d + nh * hs
                total += 2 * d * ff
            elif kind in ("moe", "moe_dense"):
                total += attn_params()
                total += self.num_experts * 3 * d * self.moe_d_ff  # experts
                total += d * self.num_experts                       # router
                if kind == "moe_dense" or self.dense_residual_d_ff:
                    total += 3 * d * (self.dense_residual_d_ff or ff)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        kinds = self.layer_kinds()
        n_moe = sum(1 for k in kinds if k in ("moe", "moe_dense"))
        all_exp = n_moe * self.num_experts * 3 * self.d_model * self.moe_d_ff
        act_exp = n_moe * self.top_k * 3 * self.d_model * self.moe_d_ff
        return full - all_exp + act_exp

    def param_bytes(self) -> int:
        bits = self.quant_bits
        return self.param_count() * bits // 8

    def kv_bytes_per_token(self) -> int:
        """KV-cache bytes per token per sequence (window-capped for local)."""
        if self.attention_free:
            return 0
        per_layer = 2 * self.num_kv_heads * self.head_dim * 2  # bf16 K+V
        kinds = self.layer_kinds()
        n_attn = sum(1 for k in kinds if k not in ("rwkv", "rglru"))
        if self.is_encoder_decoder:
            n_attn = self.num_decoder_layers
        return n_attn * per_layer
