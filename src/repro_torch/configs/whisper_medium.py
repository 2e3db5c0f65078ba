"""whisper-medium — encoder-decoder; conv audio frontend is a STUB (copy of
``repro/configs/whisper_medium.py``).

[arXiv:2212.04356; unverified] 24L encoder + 24L decoder, d_model=1024,
16H (kv=16) d_ff=4096 vocab=51865, head_dim 64, qkv_bias (whisper uses
biased projections). ``input_specs()`` supplies precomputed frame
embeddings (B, frames, d_model).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=48,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    is_encoder_decoder=True,
    num_encoder_layers=24,
    num_decoder_layers=24,
    encoder_seq_len=1500,
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=6, num_encoder_layers=3, num_decoder_layers=3,
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=503, encoder_seq_len=24,
    param_dtype="float32", activation_dtype="float32", remat=False,
)
