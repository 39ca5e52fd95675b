"""Batched serving loop (``repro.serve.engine``, scalar path): prefill once,
then one decode step per token against the KV cache.

The JAX package fuses the token loop into one ``lax.scan``; here it is a
Python loop over ``decode_step`` (a CUDA graph of the step is a later
lever).  Greedy decoding (``temperature == 0``) is ``argmax`` with the first
maximum winning, as in JAX.  ``temperature > 0`` samples from a
``torch.Generator`` seeded with ``ServeConfig.seed`` on the params' device:
deterministic for a seed, but not JAX's threefry stream.

Per-slot positions, pad-mask prefill, EOS retirement, per-request seeds and
the adaptive path arrive with later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, prefill

__all__ = ["ServeConfig", "generate"]


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0   # 0 => greedy
    seed: int = 0


def _sample(logits, temperature: float, gen: Optional[torch.Generator]):
    lg = logits[:, -1].to(torch.float32)
    if temperature > 0:
        probs = torch.softmax(lg / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.argmax(lg, dim=-1)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, prompt_batch, cfg: ModelConfig, scfg: ServeConfig, *,
             max_cache_len: Optional[int] = None, stats: Optional[dict] = None):
    """prompt_batch: {'tokens': (B, S)}.  Returns (B, max_new_tokens) int32
    on the params' device.

    ``stats`` — optional dict that receives ``prefill_s`` (prefill and the
    first token) and ``decode_s`` (the remaining steps), host-clock walls
    taken after a device synchronise.
    """
    device = params["embed"]["w"].device
    tokens = torch.as_tensor(prompt_batch["tokens"], device=device)
    B, S = tokens.shape
    max_len = max_cache_len or (S + scfg.max_new_tokens + 1)
    if max_len < S + scfg.max_new_tokens + 1:
        raise ValueError(f"max_cache_len {max_len} < prompt {S} + "
                         f"{scfg.max_new_tokens} new tokens + 1")
    gen = None
    if scfg.temperature > 0:
        gen = torch.Generator(device=device).manual_seed(scfg.seed)

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens}, cfg, max_cache_len=max_len)
        tok = _sample(logits, scfg.temperature, gen)
        if stats is not None:
            _sync(device)
            stats["prefill_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = [tok]
        for i in range(scfg.max_new_tokens - 1):
            logits, cache = decode_step(params, cache, tok[:, None], S + i, cfg)
            tok = _sample(logits, scfg.temperature, gen)
            out.append(tok)
        if stats is not None:
            _sync(device)
            stats["decode_s"] = time.perf_counter() - t0
    return torch.stack(out, dim=1).to(torch.int32)
