"""Batched serving loop (``repro.serve.engine``, scalar path): prefill once,
then one decode step per token against the KV cache.

The JAX package fuses the token loop into one ``lax.scan``; here it is a
Python loop over ``decode_step`` (a CUDA graph of the step is a later
lever).  Greedy decoding (``temperature == 0``) is ``argmax`` with the first
maximum winning, as in JAX.  ``temperature > 0`` samples from a
``torch.Generator`` seeded with ``ServeConfig.seed`` on the params' device:
deterministic for a seed, but not JAX's threefry stream.

With an :class:`~repro_torch.runtime.AdaptiveController` attached, every
decode step runs inside an adaptive-runtime scope: the SWAPPER configs of
``cfg.ax.targets`` are the controller's int32 device tensors, observed
steps (``ServeConfig.observe_every``) emit telemetry records, and the
controller folds them in and re-tunes.  Prefill runs the static policy, as
in JAX.  Two schedules, both the JAX package's:

* ``fused=True`` (the JAX default, one ``lax.scan`` there): the policy is
  read once and frozen for the generation; the observed steps' records are
  copied to the host as the steps finish and folded into the controller in
  step order after the loop.
* ``fused=False``, or any ``param_hook``: the policy is read before every
  step, and step i-1's records are observed after step i was issued (one
  step stale): their copy to the host starts without waiting, and the
  host waits only for step i-1, so the controller's work overlaps step i
  on the card.

Per-slot positions, pad-mask prefill, EOS retirement, per-request seeds, the
fleet mesh and the token-granular API arrive with later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, prefill
from repro_torch.runtime.scope import ax_scope
from repro_torch.runtime.telemetry import finish_host_copy, start_host_copy

__all__ = ["ServeConfig", "generate"]


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0   # 0 => greedy
    seed: int = 0
    fused: bool = True         # adaptive: one frozen policy per generation
    observe_every: int = 1     # adaptive telemetry decimation period (k >= 1)


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
             adaptive=None, param_hook: Optional[Callable] = None,
             max_cache_len: Optional[int] = None, stats: Optional[dict] = None):
    """prompt_batch: {'tokens': (B, S)}.  Returns (B, max_new_tokens) int32
    on the params' device.

    ``adaptive`` — optional AdaptiveController driving the dynamic SWAPPER
    policy of ``cfg.ax.targets`` during decode (see the module note).
    ``param_hook(step, params) -> params`` — optional per-step parameter
    transform (synthetic drift); forces the stepwise schedule.
    ``stats`` — optional dict that receives ``prefill_s`` (prefill and the
    first token) and ``decode_s`` (the remaining steps, the adaptive
    controller's work included), host-clock walls taken after a device
    synchronise.
    """
    device = params["embed"]["w"].device
    tokens = torch.as_tensor(prompt_batch["tokens"], device=device)
    B, S = tokens.shape
    max_len = max_cache_len or (S + scfg.max_new_tokens + 1)
    if max_len < S + scfg.max_new_tokens + 1:
        raise ValueError(f"max_cache_len {max_len} < prompt {S} + "
                         f"{scfg.max_new_tokens} new tokens + 1")
    if scfg.observe_every < 1:
        raise ValueError(f"observe_every must be >= 1: {scfg.observe_every}")
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
        steps = range(scfg.max_new_tokens - 1)
        sample = lambda lg: _sample(lg, scfg.temperature, gen)
        if adaptive is None and param_hook is None:
            for i in steps:
                logits, cache = decode_step(params, cache, tok[:, None], S + i, cfg)
                tok = sample(logits)
                out.append(tok)
        elif adaptive is not None and param_hook is None and scfg.fused:
            _decode_fused_adaptive(params, cache, tok, S, cfg, scfg, adaptive, sample, out)
        else:
            _decode_stepwise(params, cache, tok, S, cfg, scfg, adaptive, param_hook,
                             sample, out)
        if stats is not None:
            _sync(device)
            stats["decode_s"] = time.perf_counter() - t0
    return torch.stack(out, dim=1).to(torch.int32)


def _adaptive_step(params, cache, tok, pos: int, cfg, dyn, gate: bool, tile_rows: int):
    """One decode step inside an adaptive scope: (logits, cache, records)
    with the step's stacked device records, or None when not observed."""
    with ax_scope(dyn, collect=True, gate=gate, tile_rows=tile_rows) as sc:
        logits, cache = decode_step(params, cache, tok[:, None], pos, cfg)
    return logits, cache, (sc.collected() if gate else None)


def _dyn_on(adaptive, device):
    return {k: v.to(device) for k, v in adaptive.dyn_tree().items()}


def _decode_fused_adaptive(params, cache, tok, S, cfg, scfg, adaptive, sample, out):
    """The policy frozen for the generation; observed steps' records folded
    into the controller in step order after the loop (``engine.py:527``)."""
    device = tok.device
    dyn = _dyn_on(adaptive, device)
    k = scfg.observe_every
    copies = []
    for i in range(scfg.max_new_tokens - 1):
        logits, cache, rec = _adaptive_step(params, cache, tok, S + i, cfg, dyn,
                                            i % k == 0, adaptive.tile_rows)
        tok = sample(logits)
        out.append(tok)
        if rec is not None:
            copies.append(start_host_copy(rec))
    for copy in copies:
        adaptive.observe(finish_host_copy(copy))


def _decode_stepwise(params, cache, tok, S, cfg, scfg, adaptive, param_hook, sample, out):
    """One step at a time (``engine.py:558``): the params hook and the
    per-step policy read come before each step; step i-1's records are
    observed after step i was issued, while it runs."""
    k = scfg.observe_every
    pending = None
    for i in range(scfg.max_new_tokens - 1):
        if param_hook is not None:
            params = param_hook(i, params)
        if adaptive is None:
            logits, cache = decode_step(params, cache, tok[:, None], S + i, cfg)
        else:
            logits, cache, rec = _adaptive_step(params, cache, tok, S + i, cfg,
                                                _dyn_on(adaptive, tok.device),
                                                i % k == 0, adaptive.tile_rows)
            copy = start_host_copy(rec) if rec is not None else None
            if pending is not None:
                adaptive.observe(finish_host_copy(pending))
            pending = copy
        tok = sample(logits)
        out.append(tok)
    if pending is not None:
        adaptive.observe(finish_host_copy(pending))
