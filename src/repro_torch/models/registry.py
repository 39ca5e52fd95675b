"""Model entry points (``repro.models.registry``): init / loss / prefill /
decode for every family, dispatched on ``cfg.family``: the encoder-decoder
(``encdec``) is ``whisper``, every other family ``transformer``.

**The model-sharded prefill and decode step.**  :func:`prefill` and
:func:`decode_step` take ``par`` as JAX's do, and the model is sharded
when the call runs under ``launch.sharding.set_mesh_ctx`` of a mesh with
several ``"model"`` ranks (JAX's convention: outside a mesh nothing is
sharded).  The port is multi-process SPMD, so every rank makes the same
call: the global batch (prompts, tokens, per-slot positions, prompt
lengths and write mask) on every rank, and each rank's own blocks of the
params (``launch.parallel.serve_params``: heads, ``ff`` and vocab over
``"model"``) and of the cache (``launch.mesh.cache_shardings``: the batch
over the batch axes, a K/V cache's sequence over ``"model"``, or over the
batch axes and ``"model"`` for a batch that does not divide).  A rank
computes its rows of the batch (all of them where the batch does not
divide) and returns their logits whole over the vocabulary and its block
of the new cache.  ``ValueError`` where a cache's sequence, a prompt under
``seq_shard`` or the SSD heads do not split over the ranks (JAX would pad
or reshard).  With ``par.dp_only``, a 1-D ``("data",)`` fleet mesh or no
mesh, nothing here changes.

**Rank-local weights.**  :func:`init_blocks` makes the weights of the
counter-addressed init (``layers.counter_normal``), whole or only this
rank's block of each leaf under a spec tree, so a model wider than a card
(or a host) is served without its whole tree ever being made
(``launch.parallel.init_serve_params``).  :func:`init_params`' seeded
stream is another set of weights and stays as it is.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.launch.sharding import current_groups, current_tp, serving

from . import transformer, whisper
from .layers import counter_tree

__all__ = ["init_params", "deferred_params", "init_blocks", "init_cache", "train_loss",
           "prefill", "decode_step", "input_specs"]


def _mod(cfg: ModelConfig):
    return whisper if cfg.family == "encdec" else transformer


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=None):
    return _mod(cfg).init_params(cfg, seed=seed, device=device, dtype=dtype)


def deferred_params(cfg: ModelConfig, *, device="cuda", dtype=None):
    """The param tree with each random leaf a ``layers.Deferred`` of the
    counter-addressed init and the (small) constant leaves on ``device``."""
    return _mod(cfg).deferred_params(cfg, device=device, dtype=dtype)


def init_blocks(cfg: ModelConfig, specs=None, *, mesh=None, seed: int = 0, device="cuda",
                dtype=None):
    """Random weights of the counter-addressed init (``layers.counter_normal``:
    a separate stream from :func:`init_params`', in which every element is a
    function of the seed, its leaf's path and its index in the whole leaf).
    ``specs`` (a spec tree of the param tree, e.g.
    ``launch.parallel.serve_param_specs``) on ``mesh``: only this rank's
    block of each leaf is made (``launch.mesh.block_index``), the whole leaf
    never; None: the whole tree.  A block equals the same slice of the leaf
    made whole, bit for bit, on the same device."""
    tree = deferred_params(cfg, device=device, dtype=dtype)
    index_of = None
    if specs is not None:
        if mesh is None:
            raise ValueError("init_blocks: specs= needs the mesh= that places the blocks")
        from repro_torch.launch.mesh import block_index, tree_paths

        table = dict(zip(*tree_paths(specs)))

        def index_of(path, leaf):
            spec = table[path]
            return block_index(mesh, spec, leaf.shape) if any(spec) else None

    return counter_tree(tree, seed, device, index_of=index_of)


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
    tm = current_groups()
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


def _serve_shard(B: int, decode: bool):
    """(context, (lo, hi)) of a prefill or decode step over a global batch
    of ``B`` (module note): under a model-sharded mesh the call's
    ``launch.sharding.serving`` state (a decode step's residual whole over
    ``seq``, the rows of a batch split over the batch axes) and this rank's
    rows; else a null context and every row."""
    tm, tp = current_groups(), current_tp()
    if tp is None:
        return contextlib.nullcontext(), (0, B)
    lo, hi = tm.rows(B)
    rows = None if hi - lo == B else (lo, hi, B, tm.batch_group)
    return serving(tp.unseq() if decode else tp, tm.kv_group(B), rows), (lo, hi)


def _rows(t, lo: int, hi: int, B: int):
    """Rows lo..hi of ``t`` when it is per row ((B, ...), a tensor or an
    array), else ``t`` (a scalar position, None)."""
    if (lo, hi) == (0, B) or t is None or isinstance(t, int):
        return t
    t = torch.as_tensor(t)
    return t[lo:hi] if t.dim() >= 1 and t.shape[0] == B else t


def prefill(params, batch, cfg: ModelConfig, par: Optional[ParallelConfig] = None, *,
            max_cache_len: int, prompt_lens=None):
    """Logits for the prompt (``{"tokens"}``, ``{"embeds", "pos"}`` for the
    vlm family, ``{"frames", "tokens"}`` for the encoder-decoder) and a
    decode cache of ``max_cache_len``.  ``prompt_lens`` — optional (B,) real
    prompt lengths: the pad-mask prefill (right-padded prompts attend only to
    real tokens; decoder-only full-attention stacks only, ``ValueError``
    otherwise, where JAX asserts).  ``par``: as JAX's; under a model-sharded
    mesh this rank's rows and cache block (module note)."""
    if cfg.family == "encdec" and prompt_lens is not None:
        raise ValueError("pad-mask prefill: the encoder-decoder family has none "
                         "(repro.models.registry asserts the same)")
    B = next(iter(batch.values())).shape[0]
    ctx, (lo, hi) = _serve_shard(B, decode=False)
    batch = {k: _rows(v, lo, hi, B) for k, v in batch.items()}
    prompt_lens = _rows(prompt_lens, lo, hi, B)
    with ctx:
        if cfg.family == "encdec":
            return whisper.forward(params, batch, cfg, mode="prefill",
                                   max_cache_len=max_cache_len)
        return transformer.forward(params, batch, cfg, mode="prefill",
                                   max_cache_len=max_cache_len, prompt_lens=prompt_lens)


def decode_step(params, cache, tokens, cache_index, cfg: ModelConfig,
                par: Optional[ParallelConfig] = None, write_mask=None):
    """One serving step: tokens (B, 1) at ``cache_index``, a scalar (the
    whole batch) or an int (B,) vector of per-slot positions; ``write_mask``
    (B,) bool gates each slot's attention-cache write (recurrent and SSM
    state advances regardless, as in JAX; the encoder-decoder takes none and
    raises, where JAX asserts).  The cache is updated in place and
    returned.  ``par``: as JAX's; under a model-sharded mesh this rank's
    rows and cache block (module note)."""
    if cfg.family == "encdec" and write_mask is not None:
        raise ValueError("per-slot decode: the encoder-decoder family has no write "
                         "mask (repro.models.registry asserts the same)")
    B = tokens.shape[0]
    ctx, (lo, hi) = _serve_shard(B, decode=True)
    tokens = _rows(tokens, lo, hi, B)
    cache_index = _rows(cache_index, lo, hi, B)
    write_mask = _rows(write_mask, lo, hi, B)
    with ctx:
        if cfg.family == "encdec":
            return whisper.forward(params, {"tokens": tokens}, cfg, mode="decode",
                                   cache=cache, cache_index=cache_index)
        return transformer.forward(params, {"tokens": tokens}, cfg, mode="decode",
                                   cache=cache, cache_index=cache_index,
                                   write_mask=write_mask)


# ---------------------------------------------------------------------------
# dry-run input specs (meta tensors only)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The abstract inputs of an (architecture x shape) cell: JAX's tree
    (``repro.models.registry.input_specs``) as ``meta`` tensors, its token
    and position leaves int32 as there.  Nothing is allocated; the decode
    cache is ``init_cache(..., device="meta")``, the port's per-layer list."""
    B, S = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.compute_dtype)

    def t(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            # audio: precomputed frame embeddings (stub frontend) + text
            out = {"frames": t((B, S, cfg.d_model), act), "tokens": t((B, min(S, 448)))}
        elif cfg.family == "vlm":
            out = {"embeds": t((B, S, cfg.d_model), act), "pos": t((B, S, 3))}
        else:
            out = {"tokens": t((B, S))}
        if shape.kind == "train":
            out["labels"] = t(tuple(out["tokens" if "tokens" in out else "pos"].shape[:2]))
        return out
    # decode: one token against a cache of size S
    return {"tokens": t((B, 1)),
            "cache": init_cache(cfg, B, S, device="meta",
                                enc_len=min(S, 1500) if cfg.family == "encdec" else 0)}
