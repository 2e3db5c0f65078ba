"""qwen1.5-4b — dense MHA (kv == q heads) with QKV bias (copy of
``repro/configs/qwen1_5_4b.py``).

[hf:Qwen/Qwen1.5-0.5B family; hf] 40L d_model=2560 20H (kv=20) d_ff=6912
vocab=151936, head_dim 128, qkv_bias, rope 5e6.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151_936,
    block_pattern=("global",),
    qkv_bias=True,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=503,
    param_dtype="float32", activation_dtype="float32", remat=False,
)
