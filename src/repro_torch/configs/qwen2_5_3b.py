"""qwen2.5-3b — dense GQA with QKV bias (copy of ``repro/configs/qwen2_5_3b.py``).

[hf:Qwen/Qwen2.5-0.5B family; hf] 36L d_model=2048 16H (GQA kv=2)
d_ff=11008 vocab=151936, head_dim 128, qkv_bias, tied embeddings, rope 1e6.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11_008,
    vocab_size=151_936,
    block_pattern=("global",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=503,
    param_dtype="float32", activation_dtype="float32", remat=False,
)
