"""Model entry points (``repro.models.registry``): init / prefill / decode
for every decoder-only family (``transformer``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from . import transformer

__all__ = ["init_params", "init_cache", "prefill", "decode_step"]


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=None):
    return transformer.init_params(cfg, seed=seed, device=device, dtype=dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    return transformer.init_cache(cfg, batch, max_len, device=device)


def prefill(params, batch, cfg: ModelConfig, *, max_cache_len: int, prompt_lens=None):
    """Logits for the prompt (``{"tokens"}``, or ``{"embeds", "pos"}`` for
    the vlm family) and a decode cache of ``max_cache_len``.
    ``prompt_lens`` — optional (B,) real prompt lengths: the pad-mask
    prefill (right-padded prompts attend only to real tokens; full-attention
    stacks only, ``ValueError`` otherwise)."""
    return transformer.forward(params, batch, cfg, mode="prefill",
                               max_cache_len=max_cache_len, prompt_lens=prompt_lens)


def decode_step(params, cache, tokens, cache_index, cfg: ModelConfig, write_mask=None):
    """One serving step: tokens (B, 1) at ``cache_index``, a scalar (the
    whole batch) or an int (B,) vector of per-slot positions; ``write_mask``
    (B,) bool gates each slot's attention-cache write (recurrent and SSM
    state advances regardless, as in JAX).  The cache is updated in place
    and returned."""
    return transformer.forward(params, {"tokens": tokens}, cfg, mode="decode",
                               cache=cache, cache_index=cache_index,
                               write_mask=write_mask)
