"""Architecture configs (--arch <id>) + shapes + the parallel config: every
configuration of the JAX package (``repro.configs``)."""
import dataclasses

from .base import SHAPES, AxPolicy, ModelConfig, ParallelConfig, ShapeConfig
from .deepseek_moe_16b import CONFIG as deepseek_moe_16b
from .gemma3_27b import CONFIG as gemma3_27b
from .granite_moe_1b import CONFIG as granite_moe_1b_a400m
from .mamba2_370m import CONFIG as mamba2_370m
from .qwen15_110b import CONFIG as qwen15_110b
from .qwen2_72b import CONFIG as qwen2_72b
from .qwen2_vl_72b import CONFIG as qwen2_vl_72b
from .recurrentgemma_2b import CONFIG as recurrentgemma_2b
from .starcoder2_15b import CONFIG as starcoder2_15b
from .whisper_base import CONFIG as whisper_base

ARCHS = {
    c.name: c
    for c in (
        qwen2_72b,
        gemma3_27b,
        starcoder2_15b,
        qwen15_110b,
        qwen2_vl_72b,
        deepseek_moe_16b,
        granite_moe_1b_a400m,
        recurrentgemma_2b,
        whisper_base,
        mamba2_370m,
    )
}

# long_500k requires a sub-quadratic path; pure full-attention archs skip it
LONG_CONTEXT_OK = {"gemma3-27b", "recurrentgemma-2b", "mamba2-370m"}


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A small same-family config for CPU tests (the same cut as the JAX
    package's ``repro.configs.reduced``)."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        head_dim=32,
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = min(max(1, cfg.n_kv_heads * 4 // max(cfg.n_heads, 1)), 4) or 1
    if cfg.n_experts:
        kw["n_experts"] = 8
        kw["top_k"] = min(cfg.top_k, 2)
        kw["moe_d_ff"] = 64
        kw["n_shared_experts"] = min(cfg.n_shared_experts, 1)
        kw["moe_capacity"] = 16.0
    if cfg.local_window:
        kw["local_window"] = 64
    if cfg.d_rnn:
        kw["d_rnn"] = 128
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 2
    if cfg.family == "ssm":
        kw["ssm_state"] = 32
        kw["ssm_head_dim"] = 32
        kw["ssm_chunk"] = 32
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)


__all__ = ["ARCHS", "LONG_CONTEXT_OK", "SHAPES", "AxPolicy", "ModelConfig", "ParallelConfig",
           "ShapeConfig",
           "get_config", "reduced", "qwen2_72b", "gemma3_27b", "starcoder2_15b",
           "qwen15_110b", "qwen2_vl_72b", "deepseek_moe_16b", "granite_moe_1b_a400m",
           "recurrentgemma_2b", "whisper_base", "mamba2_370m"]
