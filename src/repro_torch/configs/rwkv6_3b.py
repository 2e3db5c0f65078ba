"""rwkv6-3b — Finch: attention-free, data-dependent decay
(copy of ``repro/configs/rwkv6_3b.py``).

[arXiv:2404.05892; hf] 32L d_model=2560 (attn-free) d_ff=8960
vocab=65536, head_size 64 (40 heads).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    block_pattern=("rwkv",),
    rwkv_head_size=64,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=64, d_ff=128, vocab_size=503, rwkv_head_size=16,
    param_dtype="float32", activation_dtype="float32", remat=False,
)
