"""gemma3-27b [dense] — 5:1 local:global interleaved attention, 128k context
[hf:google/gemma-3-1b-pt pattern; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab=262144,
    head_dim=128,
    rope_theta=1e6,
    act="silu",
    local_window=1024,
    pattern=("local", "local", "local", "local", "local", "global"),
    tie_embeddings=True,
)
