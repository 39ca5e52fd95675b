"""whisper-base [audio] — encoder-decoder; the conv/mel frontend is a STUB:
input_specs() provides precomputed frame embeddings (per assignment)
[arXiv:2212.04356; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,           # decoder layers
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    head_dim=64,
    act="gelu",
    tie_embeddings=True,
)
