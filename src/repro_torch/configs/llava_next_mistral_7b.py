"""llava-next-mistral-7b — VLM: Mistral-7B backbone, anyres patch STUB
(copy of ``repro/configs/llava_next_mistral_7b.py``).

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000, head_dim 128, rope 1e6 (Mistral
v0.2: no sliding window). ``input_specs()`` supplies 576 precomputed
patch embeddings prepended to the text tokens.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    block_pattern=("global",),
    num_patch_tokens=576,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=503, num_patch_tokens=8,
    param_dtype="float32", activation_dtype="float32", remat=False,
)
