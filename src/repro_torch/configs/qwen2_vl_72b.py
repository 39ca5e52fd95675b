"""qwen2-vl-72b [vlm] — qwen2-72b backbone + M-RoPE; the vision frontend is a
stub: a prompt is precomputed patch embeddings with (B, S, 3) positions
(``{"embeds", "pos"}``) [arXiv:2409.12191; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    act="silu",
    mrope=True,
)
