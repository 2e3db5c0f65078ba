"""qwen3-moe-30b-a3b — MoE, 128 experts top-8, qk_norm GQA (copy of
``repro/configs/qwen3_moe_30b_a3b.py``).

[hf:Qwen/Qwen3-30B-A3B; hf] 48L d_model=2048 32H (GQA kv=4) expert
d_ff=768 vocab=151936, head_dim 128, rope 1e6.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151_936,
    block_pattern=("moe",),
    num_experts=128,
    top_k=8,
    moe_d_ff=768,
    capacity_factor=1.25,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=503, num_experts=8, top_k=2, moe_d_ff=32,
    capacity_factor=4.0,
    param_dtype="float32", activation_dtype="float32", remat=False,
)
