"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2 recurrent : 1 attn
[arXiv:2402.19427; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    rope_theta=1e4,
    act="silu",
    local_window=2048,
    pattern=("recurrent", "recurrent", "local"),
    d_rnn=2560,
    tie_embeddings=True,
)
