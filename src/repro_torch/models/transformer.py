"""Decoder-only stack for the dense family (``repro.models.transformer``).

Parameters are a dict ``{"embed", "ln_f", "lm_head", "layers": [...]}``
whose ``layers`` is a plain list of per-layer dicts (the JAX package
scan-stacks them; ``repro_torch.convert`` unstacks).  The decode cache is a
list of ``{"k", "v"}`` tensors, one per layer, written in place by decode
steps.  Other families (moe, hybrid, ssm, encdec, vlm) come with their own
slices of the port.

Modes:
    train   — logits for next-token loss, no caches
    prefill — logits + decode-ready cache (padded to max_cache_len);
              ``prompt_lens`` selects the pad-mask prefill
    decode  — single-token step against the cache at ``cache_index``: a
              scalar (the whole batch) or a (B,) vector of per-slot
              positions, ``write_mask`` gating each slot's cache write

Decode positions never reach the host: a scalar ``cache_index`` becomes a
(B,) device vector here, so one step reads nothing back from the card and
can be captured in a CUDA graph (``serve/graph.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig

from repro_torch.quant.ax import weight_cast

from .layers import attn_apply, attn_init, make_rope, mlp_apply, mlp_init, ninit, rmsnorm

__all__ = ["init_params", "init_cache", "forward"]


def _check_dense(cfg: ModelConfig):
    if cfg.family != "dense" or any(k != "global" for k in cfg.layer_kinds()):
        raise NotImplementedError(
            f"{cfg.name}: only the dense family with global attention layers "
            f"is ported so far (family {cfg.family!r})")


def _layer_init(cfg: ModelConfig, dtype, generator, device):
    return {
        "ln1": {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)},
        "attn": attn_init(cfg, dtype, generator, device),
        "ln2": {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)},
        "mlp": mlp_init(cfg.d_model, cfg.d_ff, cfg.act, dtype, generator, device,
                        bias=cfg.qkv_bias and cfg.act == "gelu"),
    }


def _layer_apply(p, x, cfg: ModelConfig, *, pos, inv_freq, mode, cache=None,
                 cache_index=None, max_cache_len=0, prompt_lens=None, write_mask=None):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = attn_apply(p["attn"], h, cfg, pos=pos, inv_freq=inv_freq,
                              mode=mode, cache=cache, cache_index=cache_index,
                              max_cache_len=max_cache_len, prompt_lens=prompt_lens,
                              write_mask=write_mask)
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp_apply(p["mlp"], h, cfg.act, cfg.ax)
    return x, new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Empty decode cache: one ``{"k", "v"}`` of (B, max_len, KV, hd) per layer."""
    _check_dense(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    shp = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return [{"k": torch.zeros(shp, dtype=dtype, device=device),
             "v": torch.zeros(shp, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=None):
    """Random weights from a seeded ``torch.Generator`` on ``device``."""
    _check_dense(cfg)
    dtype = dtype or getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    V = cfg.padded_vocab
    params = {
        "embed": {"w": ninit((V, cfg.d_model), dtype, gen, device, scale=0.02)},
        "ln_f": {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": ninit((V, cfg.d_model), dtype, gen, device, scale=0.02)}
    params["layers"] = [_layer_init(cfg, dtype, gen, device) for _ in range(cfg.n_layers)]
    return params


def _positions(cache_index, B: int, device) -> torch.Tensor:
    """A decode position as an int64 (B,) tensor on ``device``: a Python
    int fills one on the device, a tensor is broadcast (no host read)."""
    if torch.is_tensor(cache_index):
        ci = cache_index.to(device=device, dtype=torch.int64)
        return ci.expand(B) if ci.dim() == 0 else ci.reshape(B)
    return torch.full((B,), int(cache_index), dtype=torch.int64, device=device)


def forward(params, batch, cfg: ModelConfig, *, mode: str = "train",
            cache=None, cache_index=None, max_cache_len: int = 0,
            prompt_lens=None, write_mask=None):
    """Returns (logits, new_cache); ``new_cache`` is None in train mode.

    ``cache_index`` — decode position, a scalar or an int (B,) vector of
    per-slot positions; ``write_mask`` — optional (B,) bool gating each
    slot's decode cache write; ``prompt_lens`` — optional (B,) real prompt
    lengths for the pad-mask prefill (``repro.models.transformer.forward``).
    """
    _check_dense(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    tok = batch["tokens"]
    B, S = tok.shape
    emb = params["embed"]["w"]
    x = emb[tok.to(torch.int64)].to(dtype)
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model, dtype=dtype) ** 0.5
    ci = None
    if mode == "decode":
        ci = _positions(cache_index, B, x.device)
        pos = ci[:, None]
    else:
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
    pl = None
    if prompt_lens is not None and mode != "decode":
        pl = torch.as_tensor(prompt_lens, device=x.device).reshape(B)
    wm = write_mask if mode == "decode" else None
    inv_freq = make_rope(cfg.head_dim_, cfg.rope_theta, device=x.device)

    new_cache = []
    for i, lp in enumerate(params["layers"]):
        lc = cache[i] if mode == "decode" else None
        x, nc = _layer_apply(lp, x, cfg, pos=pos, inv_freq=inv_freq, mode=mode,
                             cache=lc, cache_index=ci, max_cache_len=max_cache_len,
                             prompt_lens=pl, write_mask=wm)
        new_cache.append(nc)

    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    head_w = params["embed"]["w"] if cfg.tie_embeddings else params["lm_head"]["w"]
    logits = torch.einsum("bsd,vd->bsv", x, weight_cast(head_w, x.dtype))
    return logits, (new_cache if mode != "train" else None)
