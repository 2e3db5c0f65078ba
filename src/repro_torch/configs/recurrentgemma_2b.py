"""recurrentgemma-2b — Griffin: RG-LRU + local attention, 1:2 ratio
(copy of ``repro/configs/recurrentgemma_2b.py``).

[arXiv:2402.19427; hf] 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, local window 2048, lru_width 2560, head_dim 256.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local"),
    window_size=2048,
    rnn_width=2560,
    rnn_blocks=8,
    conv1d_width=4,
    rope_theta=10_000.0,
    scale_embedding=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=8,                      # 2 cycles + (rglru, rglru) tail
    d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=503, rnn_width=64, rnn_blocks=4,
    window_size=8,
    param_dtype="float32", activation_dtype="float32", remat=False,
)
