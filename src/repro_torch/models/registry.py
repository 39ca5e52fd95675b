"""Model entry points (``repro.models.registry``): init / loss / prefill /
decode for every family, dispatched on ``cfg.family``: the encoder-decoder
(``encdec``) is ``whisper``, every other family ``transformer``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.sharding import current_train

from . import transformer, whisper

__all__ = ["init_params", "init_cache", "train_loss", "prefill", "decode_step"]


def _mod(cfg: ModelConfig):
    return whisper if cfg.family == "encdec" else transformer


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=None):
    return _mod(cfg).init_params(cfg, seed=seed, device=device, dtype=dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda", enc_len: int = 0):
    """An empty decode cache; ``enc_len`` is the encoder's frame count of an
    encoder-decoder (``max_len`` when 0, as in JAX)."""
    if cfg.family == "encdec":
        return whisper.init_cache(cfg, batch, max_len, enc_len or max_len, device=device)
    return transformer.init_cache(cfg, batch, max_len, device=device)


def train_loss(params, batch, cfg: ModelConfig, par: Optional[ParallelConfig] = None):
    """Next-token (or seq2seq) cross-entropy plus ``0.01 *`` the MoE
    load-balancing term; returns (loss, {"ce", "aux"}).  Labels below 0 are
    masked out; the padded tail of the vocabulary is pushed out of the
    softmax.  ``par.remat == "layer"`` recomputes each decoder-only layer in
    the backward pass (the JAX whisper forward takes no remat, nor does the
    port's).

    Under the sharded train step (``train/distributed.py``) ``batch`` is
    the rank's rows and the result is the rank's term of a loss summed over
    ranks: ``-sum(ll * mask)`` over its rows divided by the all-reduced
    count of real labels (JAX's global masked mean), plus ``0.01 *`` its
    term of the global load-balancing loss (``blocks.moe_apply``).  With
    tensor parallelism over ``"model"`` the logits are the rank's vocab
    columns and the cross-entropy is vocab-parallel (:func:`_vocab_parallel_ll`);
    the model ranks of a batch shard then compute the same term, and each
    returns its ``1 / model`` share, so the terms of every rank sum to the
    loss (``train/distributed.py``)."""
    kw = {} if cfg.family == "encdec" else {"remat": par is not None and par.remat == "layer"}
    logits, _, aux = _mod(cfg).forward(params, batch, cfg, mode="train", with_aux=True, **kw)
    labels = batch["labels"].to(torch.int64)
    logits = logits.to(torch.float32)
    tm = current_train()
    tp = tm.tp if tm is not None else None
    if tp is not None and tp.split(logits.shape[-1], cfg.padded_vocab):
        ll = _vocab_parallel_ll(logits, labels, cfg, tp)
    else:
        if cfg.padded_vocab != cfg.vocab:
            pad_mask = (torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab)
            logits = logits - 1e9 * pad_mask.to(torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    count = mask.sum()
    if tm is not None:
        # this rank's term of the global masked mean (``train/distributed.py``)
        count = tm.batch_sum(count)
    loss = -(ll * mask).sum() / torch.clamp(count, min=1.0)
    if tp is not None:
        loss = loss / tp.n
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


def _vocab_parallel_ll(logits, labels, cfg: ModelConfig, tp):
    """The label log-likelihoods (B, S) from this rank's vocab columns of the
    logits: the log-sum-exp from an all-reduce MAX (no gradient) and an
    all-reduce SUM over the model ranks, the label's logit from the rank
    that holds it (an all-reduce SUM of the masked picks), the padded tail
    masked at its global indices."""
    lo, hi = tp.block(cfg.padded_vocab)
    if cfg.padded_vocab != cfg.vocab:
        pad_mask = torch.arange(lo, hi, device=logits.device) >= cfg.vocab
        logits = logits - 1e9 * pad_mask.to(torch.float32)
    mx = tp.all_reduce_(logits.detach().amax(dim=-1, keepdim=True), dist.ReduceOp.MAX)
    sumexp = tp.reduce(torch.exp(logits - mx).sum(dim=-1))
    lab = labels.clamp(min=0)
    inside = (lab >= lo) & (lab < hi)
    pick = torch.gather(logits, -1, (lab - lo).clamp(0, hi - lo - 1)[..., None])[..., 0]
    pick = tp.reduce(pick * inside.to(torch.float32))
    return pick - (mx[..., 0] + torch.log(sumexp))


def prefill(params, batch, cfg: ModelConfig, *, max_cache_len: int, prompt_lens=None):
    """Logits for the prompt (``{"tokens"}``, ``{"embeds", "pos"}`` for the
    vlm family, ``{"frames", "tokens"}`` for the encoder-decoder) and a
    decode cache of ``max_cache_len``.  ``prompt_lens`` — optional (B,) real
    prompt lengths: the pad-mask prefill (right-padded prompts attend only to
    real tokens; decoder-only full-attention stacks only, ``ValueError``
    otherwise, where JAX asserts)."""
    if cfg.family == "encdec":
        if prompt_lens is not None:
            raise ValueError("pad-mask prefill: the encoder-decoder family has none "
                             "(repro.models.registry asserts the same)")
        return whisper.forward(params, batch, cfg, mode="prefill", max_cache_len=max_cache_len)
    return transformer.forward(params, batch, cfg, mode="prefill",
                               max_cache_len=max_cache_len, prompt_lens=prompt_lens)


def decode_step(params, cache, tokens, cache_index, cfg: ModelConfig, write_mask=None):
    """One serving step: tokens (B, 1) at ``cache_index``, a scalar (the
    whole batch) or an int (B,) vector of per-slot positions; ``write_mask``
    (B,) bool gates each slot's attention-cache write (recurrent and SSM
    state advances regardless, as in JAX; the encoder-decoder takes none and
    raises, where JAX asserts).  The cache is updated in place and
    returned."""
    if cfg.family == "encdec":
        if write_mask is not None:
            raise ValueError("per-slot decode: the encoder-decoder family has no write "
                             "mask (repro.models.registry asserts the same)")
        return whisper.forward(params, {"tokens": tokens}, cfg, mode="decode", cache=cache,
                               cache_index=cache_index)
    return transformer.forward(params, {"tokens": tokens}, cfg, mode="decode",
                               cache=cache, cache_index=cache_index,
                               write_mask=write_mask)
