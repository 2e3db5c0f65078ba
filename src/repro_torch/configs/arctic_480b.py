"""arctic-480b — dense-MoE hybrid: 128 experts top-2 + dense residual MLP
(copy of ``repro/configs/arctic_480b.py``).

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
expert d_ff=4864 vocab=32000, head_dim 128, rope 10k. The dense residual
MLP runs in parallel with the MoE FFN on every layer (Arctic's
"dense-MoE hybrid" design); its hidden size is set to d_model.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    block_pattern=("moe_dense",),
    num_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual_d_ff=7168,
    capacity_factor=1.25,
    rope_theta=10_000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=503, num_experts=8, top_k=2, moe_d_ff=32,
    dense_residual_d_ff=64, capacity_factor=4.0,
    param_dtype="float32", activation_dtype="float32", remat=False,
)
