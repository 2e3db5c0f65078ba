"""qwen3-32b — dense GQA with qk_norm (copy of ``repro/configs/qwen3_32b.py``).

[hf:Qwen/Qwen3-8B family; hf] 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, head_dim 128, qk_norm, untied embeddings, rope 1e6.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab_size=151_936,
    block_pattern=("global",),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=503,
    param_dtype="float32", activation_dtype="float32", remat=False,
)
