"""gemma3-27b — dense GQA, 5:1 local:global interleave, 128k context
(copy of ``repro/configs/gemma3_27b.py``).

[hf:google/gemma-3 family; unverified] 62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144, head_dim 128, qk_norm, window 1024,
rope 1e6 (global) / 10k (local), sqrt(d) embedding scale.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21_504,
    vocab_size=262_144,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    window_size=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    scale_embedding=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=8,                      # 1 cycle + 2 local tail
    d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=503, window_size=8,
    param_dtype="float32", activation_dtype="float32", remat=False,
)
