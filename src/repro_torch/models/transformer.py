"""Decoder-only stack for the dense / moe / hybrid / ssm / vlm families
(``repro.models.transformer``).

Layer kinds come from ``ModelConfig.layer_kinds()``:
    'global'    — full-attention block + FFN
    'local'     — sliding-window attention block (ring cache) + FFN
    'recurrent' — RG-LRU block + FFN
    'ssm'       — Mamba2 SSD block (no separate FFN branch)
    'dense_ffn' — full attention + dense FFN (the leading layers of MoE models)
In the moe family the FFN of every layer but a ``dense_ffn`` one is MoE.

Parameters are a dict ``{"embed", "ln_f", ["lm_head"], "layers": [...]}``
whose ``layers`` is a plain list of per-layer dicts in layer order, the
kind of layer i being ``cfg.layer_kinds()[i]`` (the JAX package splits the
stack into leading, scan-stacked and trailing layers;
``repro_torch.convert`` flattens it).  The decode cache is a list with one
dict per layer: ``{"k", "v"}`` (a ring of ``min(local_window, max_len)``
rows for a local layer) or ``{"h", "conv"}`` for recurrent and SSM state,
every tensor with the batch on dim 0, all written in place by decode steps.

Modes:
    train   — logits for next-token loss, no caches
    prefill — logits + decode-ready cache (padded to max_cache_len);
              ``prompt_lens`` selects the pad-mask prefill (full-attention
              stacks only)
    decode  — single-token step against the cache at ``cache_index``: a
              scalar (the whole batch) or a (B,) vector of per-slot
              positions, ``write_mask`` gating each slot's attention cache
              write (recurrent and SSM state advances regardless, as in JAX)

A prompt batch is ``{"tokens": (B, S)}``, or ``{"embeds": (B, S, D),
"pos": (B, S, 3)}`` for the vlm family (M-RoPE; decode positions are the
cache index on all three streams).

Decode positions never reach the host: a scalar ``cache_index`` becomes a
(B,) device vector here, so one step reads nothing back from the card and
can be captured in a CUDA graph (``serve/graph.py``).

**Tensor and sequence parallelism** (a train forward inside the sharded
step with a ``"model"`` axis of several ranks, ``launch.sharding.current_tp``;
``models/layers.py``): the embedding lookup is vocab-parallel (the tokens
outside the rank's rows masked, the rows all-reduced); under ``seq_shard``
the residual lives on its seq shard between blocks (the lookup's sum
reduce-scattered over ``seq``, vlm ``embeds`` sliced), the norms run on
the shard, and each block takes its input all-gathered over ``seq`` and
reduce-scatters its output; the head gives this rank's vocab columns of
the logits (``models/registry.train_loss`` is vocab-parallel), from the
final norm all-gathered over ``seq``.  The model-sharded prefill and
decode step (``models.registry``) run the same layers, with each layer's
cache the rank's block (``models/layers.py``, ``models/blocks.py``), and
return the logits whole over the vocabulary (the rank's columns
all-gathered), so sampling is unchanged.

In the sharded train step the parameters are the rank's blocks: each
layer takes its own whole through ``launch.sharding.gathered`` at the top
of ``_layer_apply`` (the function ``torch.utils.checkpoint`` recomputes
under ``remat``), the embedding where it is looked up and the head where
it projects (``train/distributed.py``).  Elsewhere ``gathered`` returns
what it is given.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import current_tp, gathered, recompute_context
from repro_torch.quant.ax import weight_cast

from . import blocks
from .layers import DEFER, attn_apply, attn_init, generator, make_rope, mlp_apply, mlp_init, \
    ninit, rmsnorm

__all__ = ["init_params", "deferred_params", "init_cache", "forward", "ax_projections"]


def _check(cfg: ModelConfig):
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: the encoder-decoder family is models/whisper.py "
                         f"(models.registry dispatches on cfg.family)")


def _layer_init(cfg: ModelConfig, kind: str, dtype, generator, device):
    z = lambda: {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32,  # noqa: E731
                                      device=device)}
    p = {"ln1": z()}
    if kind in ("global", "local", "dense_ffn"):
        p["attn"] = attn_init(cfg, dtype, generator, device)
    elif kind == "recurrent":
        p["rec"] = blocks.rglru_init(cfg, dtype, generator, device)
    else:
        p["ssm"] = blocks.ssd_init(cfg, dtype, generator, device)
        return p                                   # mamba block: one residual branch
    p["ln2"] = z()
    if cfg.family == "moe" and kind != "dense_ffn":
        p["moe"] = blocks.moe_init(cfg, dtype, generator, device)
    else:
        p["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, cfg.act, dtype, generator, device,
                            bias=cfg.qkv_bias and cfg.act == "gelu")
    return p


def _empty_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype, device):
    if kind == "ssm":
        din = cfg.ssm_expand * cfg.d_model
        H = din // cfg.ssm_head_dim
        return {"h": torch.zeros((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                                 dtype=torch.float32, device=device),
                "conv": torch.zeros((batch, 3, din + 2 * cfg.ssm_state), dtype=dtype,
                                    device=device)}
    if kind == "recurrent":
        return {"h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32, device=device),
                "conv": torch.zeros((batch, 3, cfg.d_rnn), dtype=dtype, device=device)}
    rows = min(cfg.local_window, max_len) if kind == "local" else max_len
    shp = (batch, rows, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def _identity(t):
    return t


def _layer_apply(p, x, cfg: ModelConfig, kind: str, *, pos, inv_freq, mode, cache=None,
                 cache_index=None, max_cache_len=0, prompt_lens=None, write_mask=None):
    """Returns (x, new_cache, aux): ``aux`` is a MoE layer's load-balancing
    term, else None.  Under tensor parallelism each block's input is
    entered and its output comes in the residual's layout (module note)."""
    p = gathered(p)              # the sharded train step's blocks made whole, here
    tp = current_tp()
    enter = tp.enter if tp is not None else _identity
    h = enter(rmsnorm(x, p["ln1"], cfg.norm_eps))
    if kind in ("global", "local", "dense_ffn"):
        a, new_cache = attn_apply(p["attn"], h, cfg, pos=pos, inv_freq=inv_freq,
                                  window=cfg.local_window if kind == "local" else 0,
                                  mode=mode, cache=cache, cache_index=cache_index,
                                  max_cache_len=max_cache_len, prompt_lens=prompt_lens,
                                  write_mask=write_mask)
    else:
        rc = cache
        if mode == "prefill":
            rc = _empty_cache(cfg, kind, x.shape[0], max_cache_len, x.dtype, x.device)
        elif mode == "train":
            rc = None
        fn = blocks.rglru_apply if kind == "recurrent" else blocks.ssd_apply
        a, new_cache = fn(p["rec" if kind == "recurrent" else "ssm"], h, cfg, rc)
        if kind == "ssm":
            return x + a, new_cache, None
    x = x + a
    h = enter(rmsnorm(x, p["ln2"], cfg.norm_eps))
    aux = None
    if "moe" in p:
        m, aux = blocks.moe_apply(p["moe"], h, cfg)
    else:
        m = mlp_apply(p["mlp"], h, cfg.act, cfg.ax, d_ff=cfg.d_ff)
    return x + m, new_cache, aux


def ax_projections(cfg: ModelConfig):
    """The approximate ``dense`` calls of one forward, in call order, as
    ``(layer, name, K, N)``: each projection whose target ``cfg.ax``
    covers — attention's q/k/v (``attn_qkv``) and output (``attn_out``),
    RG-LRU's and SSD's in/gate/out and the FFN's in/gate/out (in/out for
    gelu), in a MoE layer the shared experts' (``mlp``); the routed experts
    are plain products.  Empty without a policy."""
    targets = cfg.ax.targets if cfg.ax is not None else ()
    D, hd = cfg.d_model, cfg.head_dim_
    H, KVH = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def ffn(prefix, width, act):
        return ([(f"{prefix} in", "mlp", D, width)]
                + ([(f"{prefix} gate", "mlp", D, width)] if act == "silu" else [])
                + [(f"{prefix} out", "mlp", width, D)])

    calls = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "ssm":
            layer = ffn("ssd", cfg.ssm_expand * D, "silu")
        else:
            if kind == "recurrent":
                layer = ffn("rg-lru", cfg.d_rnn, "silu")
            else:
                layer = [("attn q", "attn_qkv", D, H), ("attn k", "attn_qkv", D, KVH),
                         ("attn v", "attn_qkv", D, KVH), ("attn out", "attn_out", H, D)]
            if cfg.family == "moe" and kind != "dense_ffn":
                width = cfg.n_shared_experts * cfg.moe_d_ff
                layer += ffn("shared", width, "silu") if width else []
            else:
                layer += ffn("mlp", cfg.d_ff, cfg.act)
        calls += [(i, name, K, N) for name, target, K, N in layer if target in targets]
    return calls


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Empty decode cache: one dict per layer (module note)."""
    _check(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    return [_empty_cache(cfg, kind, batch, max_len, dtype, device)
            for kind in cfg.layer_kinds()]


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=None):
    """Random weights from a seeded ``torch.Generator`` on ``device``."""
    _check(cfg)
    return _tree(cfg, generator(seed, device), device, dtype or getattr(torch, cfg.param_dtype))


def deferred_params(cfg: ModelConfig, *, device="cuda", dtype=None):
    """:func:`init_params`' tree with each random leaf a ``layers.Deferred``
    of the counter-addressed init (``models.registry.init_blocks`` makes
    them) and the constant leaves on ``device``."""
    _check(cfg)
    return _tree(cfg, DEFER, device, dtype or getattr(torch, cfg.param_dtype))


def _tree(cfg: ModelConfig, gen, device, dtype):
    V = cfg.padded_vocab
    params = {
        "embed": {"w": ninit((V, cfg.d_model), dtype, gen, device, scale=0.02)},
        "ln_f": {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": ninit((V, cfg.d_model), dtype, gen, device, scale=0.02)}
    params["layers"] = [_layer_init(cfg, kind, dtype, gen, device)
                        for kind in cfg.layer_kinds()]
    return params


def _positions(cache_index, B: int, device) -> torch.Tensor:
    """A decode position as an int64 (B,) tensor on ``device``: a Python
    int fills one on the device, a tensor is broadcast (no host read)."""
    if torch.is_tensor(cache_index):
        ci = cache_index.to(device=device, dtype=torch.int64)
        return ci.expand(B) if ci.dim() == 0 else ci.reshape(B)
    return torch.full((B,), int(cache_index), dtype=torch.int64, device=device)


def embed_lookup(w, tok, dtype, vocab: int, tp=None):
    """``w[tok]`` cast to ``dtype``; under tensor parallelism (``tp``) ``w``
    may be this rank's block of the ``vocab`` rows: the tokens outside it
    are masked and the rows all-reduced (reduce-scattered over ``seq``
    under ``seq_shard``), giving the residual's layout."""
    tok = tok.to(torch.int64)
    if tp is None:
        return w[tok].to(dtype)
    if not tp.split(w.shape[0], vocab):
        return tp.exit(w[tok].to(dtype), partial=False)
    lo, hi = tp.block(vocab)
    inside = (tok >= lo) & (tok < hi)
    x = w[(tok - lo).clamp(0, hi - lo - 1)] * inside[..., None].to(w.dtype)
    return tp.exit(x.to(dtype), partial=True)


def _whole_vocab(logits, tp, cfg: ModelConfig):
    """Serving logits whole over the vocabulary: this rank's vocab columns
    all-gathered over the model ranks (a head left whole gives them all)."""
    return tp.gather(logits, -1) if tp.split(logits.shape[-1], cfg.padded_vocab) else logits


def _embed_in(params, batch, cfg: ModelConfig, dtype, tp=None):
    """(x, pos): token embeddings (scaled by sqrt(d_model) when tied, but not
    for ssm) or the vlm's precomputed ``embeds``; ``pos`` from the batch or
    arange, broadcast to three streams under M-RoPE.  Under tensor
    parallelism ``x`` is in the residual's layout (module note)."""
    if "embeds" in batch:
        x = batch["embeds"].to(dtype)
        B, S = x.shape[:2]
        if tp is not None:
            x = tp.exit(x, partial=False)
    else:
        tok = batch["tokens"]
        B, S = tok.shape
        x = embed_lookup(gathered(params["embed"]["w"]), tok, dtype, cfg.padded_vocab, tp)
        if cfg.family != "ssm" and cfg.tie_embeddings:
            x = x * torch.tensor(cfg.d_model, dtype=dtype) ** 0.5
    if "pos" in batch:
        pos = batch["pos"].to(device=x.device, dtype=torch.int64)
    else:
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        if cfg.mrope:
            pos = pos[..., None].expand(B, S, 3)
    return x, pos


def forward(params, batch, cfg: ModelConfig, *, mode: str = "train",
            cache=None, cache_index=None, max_cache_len: int = 0,
            prompt_lens=None, write_mask=None, with_aux: bool = False,
            remat: bool = False):
    """Returns (logits, new_cache); ``new_cache`` is None in train mode.
    ``with_aux`` appends the MoE load-balancing term summed over the
    layers (an f32 scalar, 0 without MoE layers), as the JAX forward's
    third result; ``remat`` recomputes each layer of a train forward in
    the backward pass (``torch.utils.checkpoint``, the JAX package's
    ``remat="layer"``).

    ``cache_index`` — decode position, a scalar or an int (B,) vector of
    per-slot positions; ``write_mask`` — optional (B,) bool gating each
    slot's decode attention-cache write; ``prompt_lens`` — optional (B,)
    real prompt lengths for the pad-mask prefill, on full-attention stacks
    only (``repro.models.transformer.forward``).
    """
    _check(cfg)
    if prompt_lens is not None and not all(k in ("global", "dense_ffn")
                                           for k in cfg.layer_kinds()):
        raise ValueError(f"pad-mask prefill needs a full-attention stack; {cfg.name} has "
                         f"kinds {sorted(set(cfg.layer_kinds()))}")
    dtype = getattr(torch, cfg.compute_dtype)
    tp = current_tp()
    x, pos = _embed_in(params, batch, cfg, dtype, tp)
    B = x.shape[0]
    ci = None
    if mode == "decode":
        ci = _positions(cache_index, B, x.device)
        if "pos" not in batch:
            pos = ci[:, None]
            if cfg.mrope:
                pos = pos[..., None].expand(B, 1, 3)
    pl = None
    if prompt_lens is not None and mode != "decode":
        pl = torch.as_tensor(prompt_lens, device=x.device).reshape(B)
    wm = write_mask if mode == "decode" else None
    inv_freq = make_rope(cfg.head_dim_, cfg.rope_theta, device=x.device) if cfg.n_heads \
        else None

    new_cache = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, lp) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        lc = cache[i] if mode == "decode" else None
        kw = dict(pos=pos, inv_freq=inv_freq, mode=mode, cache=lc, cache_index=ci,
                  max_cache_len=max_cache_len, prompt_lens=pl, write_mask=wm)
        if remat and mode == "train":
            # the recompute sees the forward's mesh context (the sharded train
            # step's collectives), also on autograd's device thread
            x, nc, a = checkpoint(_layer_apply, lp, x, cfg, kind, use_reentrant=False,
                                  context_fn=recompute_context, **kw)
        else:
            x, nc, a = _layer_apply(lp, x, cfg, kind, **kw)
        if a is not None:
            aux = aux + a
        new_cache.append(nc)

    x = rmsnorm(x, gathered(params["ln_f"]), cfg.norm_eps)
    if tp is not None:
        x = tp.enter(x)
    head_w = gathered(params["embed"]["w"] if cfg.tie_embeddings else params["lm_head"]["w"])
    logits = torch.einsum("bsd,vd->bsv", x, weight_cast(head_w, x.dtype))
    if tp is not None and mode != "train":
        logits = _whole_vocab(logits, tp, cfg)
    out = (logits, new_cache if mode != "train" else None)
    return out + (aux,) if with_aux else out
