"""deepseek-moe-16b [moe] — fine-grained experts: 2 shared + 64 routed top-6,
first layer dense [arXiv:2401.06066; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,          # dense first-layer FFN width
    vocab=102400,
    head_dim=128,
    rope_theta=1e4,
    act="silu",
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense=1,
)
