"""Whisper-style encoder-decoder (``repro.models.whisper``).  The conv/mel
frontend is a stub, as in the JAX package: the encoder takes precomputed
frame embeddings (B, T, d_model).  LayerNorm, biases, gelu MLPs, learned
decoder positions (``MAX_DEC_POS``) and sinusoid encoder positions, the
output head tied to the token embedding.

Parameters are ``{"embed", "pos_embed", "layers_enc", "layers_dec",
"ln_enc", "ln_f"}`` with each stack a plain list of per-layer dicts in
layer order (the JAX package stacks each with ``jax.vmap``;
``repro_torch.convert`` splits the stack).

The decode cache is the port's usual list with one dict per decoder layer,
every tensor with the batch on dim 0: ``{"k", "v"}`` the self-attention
cache of ``max_len`` rows and ``{"xk", "xv"}`` the layer's cross-attention
K/V over the ``enc_len`` encoder frames, (B, enc_len, KV, hd).  JAX keeps
the cross K/V stacked as one ``(L, 2, B, S_enc, KV, hd)`` tensor;
``convert.cache_from_jax`` splits it per layer.  Prefill writes the cross
K/V once; decode reads them in place, so a captured decode step (a CUDA
graph, ``serve/graph.py``) has static shapes.

Modes: ``train`` (logits), ``prefill`` (logits and the cache padded to
``max_cache_len``) and ``decode`` (one token per row at ``cache_index``,
a scalar or a (B,) vector).  A prompt batch is ``{"frames", "tokens"}``;
decode takes ``{"tokens"}``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.quant.ax import weight_cast

from .layers import attn_apply, attn_init, dense, layernorm, mlp_apply, mlp_init, ninit, \
    generator, sinusoid_pos
from .transformer import _positions

__all__ = ["init_params", "init_cache", "forward", "ax_projections", "MAX_DEC_POS"]

MAX_DEC_POS = 1 << 16


def _ln_init(d, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def _enc_layer_init(cfg, dtype, gen, device):
    return {"ln1": _ln_init(cfg.d_model, device),
            "attn": attn_init(cfg, dtype, gen, device),
            "ln2": _ln_init(cfg.d_model, device),
            "mlp": mlp_init(cfg.d_model, cfg.d_ff, "gelu", dtype, gen, device, bias=True)}


def _dec_layer_init(cfg, dtype, gen, device):
    return {"ln1": _ln_init(cfg.d_model, device),
            "attn": attn_init(cfg, dtype, gen, device),
            "ln_x": _ln_init(cfg.d_model, device),
            "xattn": attn_init(cfg, dtype, gen, device),
            "ln2": _ln_init(cfg.d_model, device),
            "mlp": mlp_init(cfg.d_model, cfg.d_ff, "gelu", dtype, gen, device, bias=True)}


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda", dtype=None):
    """Random weights from a seeded ``torch.Generator`` on ``device``."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    gen = generator(seed, device)
    D = cfg.d_model
    return {
        "embed": {"w": ninit((cfg.padded_vocab, D), dtype, gen, device, scale=0.02)},
        "pos_embed": {"w": ninit((MAX_DEC_POS, D), dtype, gen, device, scale=0.01)},
        "layers_enc": [_enc_layer_init(cfg, dtype, gen, device)
                       for _ in range(cfg.n_enc_layers)],
        "layers_dec": [_dec_layer_init(cfg, dtype, gen, device) for _ in range(cfg.n_layers)],
        "ln_enc": _ln_init(D, device),
        "ln_f": _ln_init(D, device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int, device="cuda"):
    """Empty decode cache: one dict per decoder layer (module note)."""
    dtype = getattr(torch, cfg.compute_dtype)
    KV, hd = cfg.n_kv_heads, cfg.head_dim_
    z = lambda n: torch.zeros((batch, n, KV, hd), dtype=dtype, device=device)  # noqa: E731
    return [{"k": z(max_len), "v": z(max_len), "xk": z(enc_len), "xv": z(enc_len)}
            for _ in range(cfg.n_layers)]


def _encode(params, frames, cfg: ModelConfig):
    dtype = getattr(torch, cfg.compute_dtype)
    B, S = frames.shape[:2]
    x = frames.to(dtype) + sinusoid_pos(S, cfg.d_model, dtype, frames.device)[None]
    pos = torch.arange(S, device=frames.device)[None].expand(B, S)
    for p in params["layers_enc"]:
        h = layernorm(x, p["ln1"], cfg.norm_eps)
        a, _ = attn_apply(p["attn"], h, cfg, pos=pos, inv_freq=None, causal=False,
                          mode="train")
        x = x + a
        h = layernorm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, "gelu", cfg.ax)
    return layernorm(x, params["ln_enc"], cfg.norm_eps)


def _cross_kv(p, enc_out, cfg: ModelConfig):
    """A decoder layer's cross-attention K/V from the encoder states (the
    projections are approximate only where ``attn_qkv`` is a target)."""
    B, S, _ = enc_out.shape
    hd = cfg.head_dim_
    k = dense(enc_out, p["xattn"]["k"], cfg.ax, "attn_qkv").reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(enc_out, p["xattn"]["v"], cfg.ax, "attn_qkv").reshape(B, S, cfg.n_kv_heads, hd)
    return k, v


def _dec_layer(p, x, cfg: ModelConfig, *, pos, enc_kv, mode, cache, cache_index,
               max_cache_len):
    h = layernorm(x, p["ln1"], cfg.norm_eps)
    a, new_self = attn_apply(p["attn"], h, cfg, pos=pos, inv_freq=None, causal=True,
                             mode=mode, cache=cache, cache_index=cache_index,
                             max_cache_len=max_cache_len)
    x = x + a
    h = layernorm(x, p["ln_x"], cfg.norm_eps)
    a, _ = attn_apply(p["xattn"], h, cfg, pos=pos, inv_freq=None, causal=False,
                      mode="decode" if mode == "decode" else "train", cross_kv=enc_kv)
    x = x + a
    h = layernorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, "gelu", cfg.ax), new_self


def ax_projections(cfg: ModelConfig, mode: str = "prefill"):
    """The approximate ``dense`` calls of one forward, in call order, as
    ``(stack, layer, name, K, N)``: ``stack`` is ``"enc"`` (rows B x frames),
    ``"cross"`` (the cross K/V over the encoder states, rows B x frames) or
    ``"dec"`` (rows B x tokens, B at decode).  A decode step runs the
    ``"dec"`` calls only.  Each projection counts where ``cfg.ax`` covers its
    target: q/k/v ``attn_qkv``, the attention outputs ``attn_out``, the MLP's
    in/out ``mlp``.  Empty without a policy."""
    targets = cfg.ax.targets if cfg.ax is not None else ()
    D, hd = cfg.d_model, cfg.head_dim_
    H, KVH = cfg.n_heads * hd, cfg.n_kv_heads * hd
    attn = [("q", "attn_qkv", D, H), ("k", "attn_qkv", D, KVH), ("v", "attn_qkv", D, KVH),
            ("out", "attn_out", H, D)]
    mlp = [("mlp in", "mlp", D, cfg.d_ff), ("mlp out", "mlp", cfg.d_ff, D)]
    enc = [(f"attn {n}", t, K, N) for n, t, K, N in attn] + mlp
    cross = [("xattn k", "attn_qkv", D, KVH), ("xattn v", "attn_qkv", D, KVH)]
    dec = ([(f"attn {n}", t, K, N) for n, t, K, N in attn]
           + [("xattn q", "attn_qkv", D, H), ("xattn out", "attn_out", H, D)] + mlp)
    calls = []
    if mode != "decode":
        calls += [("enc", i, n, K, N) for i in range(cfg.n_enc_layers)
                  for n, t, K, N in enc if t in targets]
        calls += [("cross", i, n, K, N) for i in range(cfg.n_layers)
                  for n, t, K, N in cross if t in targets]
    calls += [("dec", i, n, K, N) for i in range(cfg.n_layers)
              for n, t, K, N in dec if t in targets]
    return calls


def forward(params, batch, cfg: ModelConfig, *, mode: str = "train", cache=None,
            cache_index=None, max_cache_len: int = 0, with_aux: bool = False):
    """Returns (logits, new_cache); ``new_cache`` is None in train mode.
    ``batch`` is ``{"frames": (B, T, D), "tokens": (B, S)}`` for train and
    prefill, ``{"tokens": (B, 1)}`` for decode (module note), every row
    at its own position and written (no per-slot write mask, as in JAX).
    ``with_aux`` appends the f32 zero that stands
    for the MoE term (``transformer.forward``).  There is no remat, as the
    JAX whisper forward has none."""
    dtype = getattr(torch, cfg.compute_dtype)
    tok = batch["tokens"].to(torch.int64)
    B, S = tok.shape
    if mode == "decode":
        enc_kv = [(c["xk"], c["xv"]) for c in cache]
        ci = _positions(cache_index, B, tok.device)
        pos = ci[:, None]
    else:
        enc_out = _encode(params, batch["frames"], cfg)
        enc_kv = [_cross_kv(p, enc_out, cfg) for p in params["layers_dec"]]
        ci = None
        pos = torch.arange(S, device=tok.device)[None].expand(B, S)
    x = params["embed"]["w"][tok].to(dtype)
    x = x + params["pos_embed"]["w"][pos].to(dtype)

    new_cache = []
    for i, p in enumerate(params["layers_dec"]):
        x, new_self = _dec_layer(p, x, cfg, pos=pos, enc_kv=enc_kv[i], mode=mode,
                                 cache=cache[i] if mode == "decode" else None,
                                 cache_index=ci, max_cache_len=max_cache_len)
        if mode == "decode":
            new_cache.append(cache[i])
        elif mode == "prefill":
            xk, xv = (t.to(dtype) for t in enc_kv[i])
            new_cache.append(dict(new_self, xk=xk, xv=xv))

    x = layernorm(x, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("bsd,vd->bsv", x, weight_cast(params["embed"]["w"], x.dtype))
    out = (logits, new_cache if mode != "train" else None)
    return out + (torch.zeros((), dtype=torch.float32, device=x.device),) if with_aux else out
