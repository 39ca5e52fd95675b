"""Shared model layers (``repro.models.layers``): projections (exact or
SWAPPER-approximate), RMSNorm and LayerNorm, RoPE and M-RoPE, sinusoid
positions, GQA attention (chunked flash-style for prefill, cached for
decode; sliding-window layers keep a ring cache; cross-attention over
precomputed encoder K/V) and the SwiGLU / gelu MLPs.

Parameters are plain nested dicts of tensors in the JAX package's layout:
a projection weight is ``(in, out)`` and ``y = x @ w``.  Their logical
sharding axes come from their paths (:func:`axes_for_path`, the JAX
package's rule; ``launch/sharding.py`` maps them onto mesh axes), and
``init_params(..., device="meta")`` gives the parameter tree's shapes
without allocating it.  Every op keeps the
JAX package's dtype sequence (where bf16 is rounded, where f32 is used), so
the two packages agree to within bf16 rounding.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import AxPolicy, ModelConfig
from repro_torch.quant.ax import ax_dense, ax_dense_dyn, weight_cast, weight_codes
from repro_torch.runtime.scope import active_scope

__all__ = ["ninit", "generator", "axes_for_path", "dense", "rmsnorm", "layernorm", "make_rope", "apply_rope", "sinusoid_pos",
           "chunked_attention", "decode_attention", "attn_init", "attn_apply",
           "mlp_init", "mlp_apply"]


def generator(seed: int, device) -> Optional[torch.Generator]:
    """The seeded generator of an init on ``device``; None on ``meta``,
    where an init only shapes its tensors."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def ninit(shape, dtype, generator: Optional[torch.Generator], device, scale=None):
    """Seeded normal init scaled by ``1/sqrt(fan_in)`` (or ``scale``); an
    empty tensor of the shape on the ``meta`` device."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return t.mul_(scale).to(dtype)


def axes_for_path(path: str, ndim: int):
    """Logical axes of a parameter from its '/'-joined path
    (``repro.models.layers.axes_for_path``).  A leading ``layers`` segment
    (a JAX scan-stacked leaf) contributes a ``None`` axis; the port's own
    per-layer leaves are named without it (``launch/mesh.py``)."""
    parts = path.split("/")
    stacked = bool(parts) and parts[0] == "layers"
    if stacked:
        parts = parts[1:]
    leaf = "/".join(parts)
    base_ndim = ndim - (1 if stacked else 0)

    def a(*axes):
        if len(axes) != base_ndim:
            raise ValueError(f"{path}: {ndim} dims, logical axes {axes}")
        return (("layers",) if stacked else ()) + tuple(axes)

    if leaf.endswith("embed/w") or leaf == "lm_head/w":
        return a("vocab", "embed") if not leaf.startswith("pos") else a(None, "embed")
    if leaf == "pos_embed/w":
        return a(None, "embed")
    if "/q/w" in leaf or leaf.endswith("q/w"):
        return a("embed", "heads")
    if leaf.endswith(("k/w", "v/w")):
        return a("embed", "heads")
    if leaf.endswith("o/w"):
        return a("heads", "embed")
    if leaf.endswith(("q/b", "k/b", "v/b")):
        return a("heads")
    if leaf.endswith("router/w"):
        return a("embed", "experts")
    if leaf.startswith("experts/") or "/experts/" in leaf:
        if leaf.endswith(("in/w", "gate/w")):
            return a("experts", "embed", "ff")
        if leaf.endswith("out/w"):
            return a("experts", "ff", "embed")
    if leaf.endswith(("in/w", "gate/w")):
        return a("embed", "ff")
    if leaf.endswith("out/w"):
        return a("ff", "embed")
    if leaf.endswith(("in/b", "gate/b")):
        return a("ff")
    if leaf.endswith(("out/b", "o/b")):
        return a("embed")
    if leaf.endswith("scale") or leaf.endswith("bias"):
        return a(*([None] * base_ndim))
    # rg-lru / ssm specific
    if leaf.endswith(("wa/w", "wx/w")):
        return a("ff", "ff")
    if leaf.endswith("conv/w"):
        return a(None, "ff")
    if leaf.endswith(("a_log", "d_skip", "dt_bias", "lam")):
        return a(*(["ff"] if base_ndim == 1 else [None] * base_ndim))
    if leaf.endswith(("wb/w", "wc/w")):
        return a("embed", None)
    if leaf.endswith("wdt/w"):
        return a("embed", None)
    return tuple([None] * ndim)


# ---------------------------------------------------------------------------
# projections — exact or SWAPPER-approximate per policy
# ---------------------------------------------------------------------------

def dense(x, p, ax: Optional[AxPolicy] = None, target: str = ""):
    """y = x @ w (+ b), through the SWAPPER approximate path when the policy
    covers this projection target.  Under an open adaptive-runtime scope
    that holds a triple for the target, the swap decision is that int32
    tensor (``ax_dense_dyn``) instead of the policy's static config.  The
    weight is cast to the activation dtype first, as in the JAX package, so
    it is quantized from bf16.  Without gradients the cast and the int8
    codes come from the weight cache (``quant.ax.weight_codes``): each
    weight is quantized once, with the same bits."""
    if ax is not None and target in ax.targets:
        if torch.is_grad_enabled():
            w, codes = p["w"].to(x.dtype), None
        else:
            w, codes = p["w"], weight_codes(p["w"], x.dtype)
        scope = active_scope()
        dyn = scope.triple_for(target) if scope is not None else None
        if dyn is not None:
            y = ax_dense_dyn(x, w, ax, dyn, scope=scope, target=target, wcodes=codes)
        else:
            y = ax_dense(x, w, ax, wcodes=codes)
    else:
        y = x @ weight_cast(p["w"], x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm(x, p, eps):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)


def layernorm(x, p, eps):
    """LayerNorm in f32 with the mean of squared deviations (``jnp.var``)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    d = xf - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    out = d * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

_ROPE = {}


def make_rope(head_dim: int, theta: float, device="cpu"):
    """Inverse frequencies, computed in float64 numpy and cast to f32; made
    once per device (a copy from host memory cannot be captured in a CUDA
    graph)."""
    key = (head_dim, float(theta), torch.device(device))
    if key not in _ROPE:
        inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
        _ROPE[key] = torch.as_tensor(inv.astype(np.float32), device=device)  # (hd/2,)
    return _ROPE[key]


def apply_rope(x, pos, inv_freq):
    """x (B,S,H,hd); pos (B,S) integer positions, or (B,S,3) for M-RoPE:
    the temporal, height and width streams each rotate their own section
    of the frequencies (a quarter, three eighths and the rest)."""
    half = x.shape[-1] // 2
    if pos.dim() == 3:
        sec = [half // 4, (half * 3) // 8, half - half // 4 - (half * 3) // 8]
        freqs, start = [], 0
        for i, n in enumerate(sec):
            freqs.append(pos[..., i:i + 1].to(torch.float32) * inv_freq[start:start + n])
            start += n
        ang = torch.cat(freqs, dim=-1)                           # (B,S,half)
    else:
        ang = pos[..., None].to(torch.float32) * inv_freq        # (B,S,half)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


_SINUSOID = {}


def sinusoid_pos(seq: int, d_model: int, dtype, device="cpu"):
    """(seq, d_model) sinusoid positions (sin on even, cos on odd columns),
    computed in float64 numpy, rounded to f32 and cast to ``dtype``; made
    once per shape, dtype and device."""
    key = (seq, d_model, dtype, torch.device(device))
    if key not in _SINUSOID:
        pos = np.arange(seq)[:, None]
        dim = np.arange(0, d_model, 2)[None, :]
        ang = pos / (10000 ** (dim / d_model))
        emb = np.zeros((seq, d_model), np.float32)
        emb[:, 0::2] = np.sin(ang)
        emb[:, 1::2] = np.cos(ang)
        _SINUSOID[key] = torch.from_numpy(emb).to(device=device, dtype=dtype)
    return _SINUSOID[key]


# ---------------------------------------------------------------------------
# attention — chunked (flash-style online softmax) + decode path
# ---------------------------------------------------------------------------

def _mask_bias(qi, kj, *, causal, window):
    """(..., q, k) additive f32 mask bias from global positions qi, kj."""
    d = qi[..., :, None] - kj[..., None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m = m & (d >= 0)
    if window:
        m = m & (d < window)
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(m, zero, torch.full_like(zero, -1e30))


def _pad_seq(x, n, fill=0):
    pad = n - x.shape[1]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[1] = pad
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], 1)


def chunked_attention(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                      q_chunk=512, kv_chunk=1024):
    """Flash-style attention with O(chunk^2) memory.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) with H = KV * G; positions are
    global indices.  Padded queries and keys sit outside every causal window.
    Without ``causal`` the keys padded up to a multiple of ``kv_chunk`` are
    masked too (the JAX package attends to them there: ROADMAP queue 3), so
    a non-causal call is softmax attention over the ``Sk`` real keys and
    agrees with ``decode_attention`` over the same keys.
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // kv_chunk)
    qg = _pad_seq(q.reshape(B, Sq, KV, G, hd), nq * q_chunk)
    qp = _pad_seq(q_pos.to(torch.int64), nq * q_chunk, fill=-(2 ** 30))
    kk = _pad_seq(k, nk * kv_chunk)
    vv = _pad_seq(v, nk * kv_chunk)
    kp = _pad_seq(k_pos.to(torch.int64), nk * kv_chunk, fill=2 ** 30)

    outs = []
    for i in range(nq):
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        qb, qpb = qg[:, qs], qp[:, qs]
        m = torch.full((B, KV, G, q_chunk), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, q_chunk, hd), dtype=torch.float32, device=q.device)
        for j in range(nk):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            kb, vb, kpb = kk[:, ks], vv[:, ks], kp[:, ks]
            s = torch.einsum("bqkgh,bckh->bkgqc", qb, kb).to(torch.float32) * scale
            s = s + _mask_bias(qpb[:, None, None, :], kpb[:, None, None, :],
                               causal=causal, window=window)
            if not causal and (j + 1) * kv_chunk > Sk:    # the chunk holds padded keys
                s = s.masked_fill(kpb[:, None, None, None, :] >= 2 ** 30, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(vb.dtype), vb).to(torch.float32)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))              # (B, qc, KV, G, hd)
    out = torch.cat(outs, dim=1)[:, :Sq]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, q_pos, kv_len, *, window=0):
    """Single-token attention over a (possibly ring-buffered) cache.

    q: (B, 1, H, hd); caches: (B, S, KV, hd); kv_len: valid prefix length.
    """
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bckh->bkgc", qg, k_cache).to(torch.float32) * scale
    idx = torch.arange(S, device=q.device)[None, :]
    valid = idx < kv_len[:, None]
    if window:
        valid = valid & (idx > (q_pos[:, None] - window))
    valid = valid & (idx <= q_pos[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgc,bckh->bkgh", p, v_cache)
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def attn_init(cfg: ModelConfig, dtype, generator, device):
    hd = cfg.head_dim_
    H = cfg.n_heads * hd
    KVH = cfg.n_kv_heads * hd
    p = {
        "q": {"w": ninit((cfg.d_model, H), dtype, generator, device)},
        "k": {"w": ninit((cfg.d_model, KVH), dtype, generator, device)},
        "v": {"w": ninit((cfg.d_model, KVH), dtype, generator, device)},
        "o": {"w": ninit((H, cfg.d_model), dtype, generator, device)},
    }
    if cfg.qkv_bias:
        for nm, width in (("q", H), ("k", KVH), ("v", KVH)):
            p[nm]["b"] = torch.zeros((width,), dtype=dtype, device=device)
    return p


def _write_rows(buf, rows, slot, new, ok):
    """``buf[b, slot[b]] = new[b]`` for the rows where ``ok``; the other rows
    write back their old bytes, so a dropped row leaves ``buf``
    byte-identical (JAX's ``.at[].set(mode="drop")``) with no host read."""
    idx = slot.clamp(0, buf.shape[1] - 1)
    old = buf[rows, idx]
    buf[rows, idx] = torch.where(ok.view(-1, *([1] * (new.dim() - 1))), new.to(buf.dtype), old)


def attn_apply(p, x, cfg: ModelConfig, *, pos, inv_freq, causal=True, window=0,
               mode="train", cache=None, cache_index=None, max_cache_len=0,
               q_chunk=512, kv_chunk=1024, cross_kv=None, prompt_lens=None,
               write_mask=None):
    """GQA attention block, causal or not, full or sliding-window (``window``).

    mode='train'   — chunked attention, no cache, returns (y, None)
    mode='prefill' — the same, plus a decode cache padded to ``max_cache_len``
                     (a ring of ``min(window, max_cache_len)`` rows for a
                     windowed layer, position p at row ``p % ring``)
    mode='decode'  — S == 1 against ``cache``: this step's K/V are written
                     in place (at ``cache_index % ring`` when windowed: the
                     overwritten rows are the window's mask) and the cache
                     dict is returned.

    ``pos`` is (B, S), or (B, S, 3) under M-RoPE (the rotation takes all
    three streams, attention masks take the temporal one); ``inv_freq=None``
    rotates nothing.

    ``cross_kv`` — ``(k, v)``, each (B, S_enc, KV, hd), precomputed from an
    encoder (whisper's cross-attention): only q is projected, the keys have
    their own positions ``0 .. S_enc - 1``, attention is over all of them,
    and no cache is written or returned in any mode.

    ``cache_index`` is an int64 (B,) tensor of per-slot positions on the
    activations' device (``transformer.forward`` makes one from a scalar):
    each slot writes its own cache row and attends its own prefix.
    ``write_mask`` — optional (B,) bool gating the per-slot cache write (a
    False row's cache stays byte-identical, as a retired slot's must).
    ``prompt_lens`` — optional (B,) real prompt lengths for prefill: key
    positions past a slot's length are pushed to 2^30, outside every
    causal window, so right-padded prompts attend only to real tokens.
    """
    B, S, _ = x.shape
    hd = cfg.head_dim_
    ax = cfg.ax
    q = dense(x, p["q"], ax, "attn_qkv").reshape(B, S, cfg.n_heads, hd)
    if cross_kv is None:
        k = dense(x, p["k"], ax, "attn_qkv").reshape(B, S, cfg.n_kv_heads, hd)
        v = dense(x, p["v"], ax, "attn_qkv").reshape(B, S, cfg.n_kv_heads, hd)
        if inv_freq is not None:
            q = apply_rope(q, pos, inv_freq)
            k = apply_rope(k, pos, inv_freq)
    else:
        k, v = cross_kv

    cdtype = getattr(torch, cfg.compute_dtype)
    new_cache = None
    if mode == "decode" and cross_kv is not None:
        Se = k.shape[1]
        out = decode_attention(q, k, v, q_pos=torch.full((B,), Se - 1, device=x.device),
                               kv_len=torch.full((B,), Se, device=x.device))
    elif mode == "decode":
        ring = cache["k"].shape[1]
        ci = cache_index
        if window:
            slot = ci % ring                      # always in the ring
            ok = torch.ones_like(ci, dtype=torch.bool)
        else:
            slot = ci
            ok = (ci >= 0) & (ci < ring)          # out of range drops, as in JAX
        if write_mask is not None:
            ok = ok & write_mask
        rows = torch.arange(B, device=x.device)
        _write_rows(cache["k"], rows, slot, k[:, 0], ok)
        _write_rows(cache["v"], rows, slot, v[:, 0], ok)
        # a windowed layer attends every filled ring row (JAX's quirk: the
        # query sits at ring - 1, so the first min(ci + 1, ring) rows count)
        qp = pos[:, 0] if pos.dim() == 2 else pos[:, 0, 0]
        out = decode_attention(q, cache["k"], cache["v"],
                               q_pos=torch.full_like(ci, ring - 1) if window else qp,
                               kv_len=torch.clamp(ci + 1, max=ring))
        new_cache = cache
    else:
        qpos = pos if pos.dim() == 2 else pos[..., 0]
        kpos = qpos
        if cross_kv is not None:
            kpos = torch.arange(k.shape[1], device=x.device)[None].expand(B, k.shape[1])
        elif prompt_lens is not None:
            idx = torch.arange(S, device=x.device)[None, :]
            kpos = torch.where(idx < prompt_lens[:, None].to(idx.dtype), qpos,
                               torch.full_like(qpos, 2 ** 30))
        out = chunked_attention(q, k, v, qpos, kpos, causal=causal, window=window,
                                q_chunk=q_chunk, kv_chunk=kv_chunk)
        prefill = mode == "prefill" and cross_kv is None
        if prefill and window:
            if prompt_lens is not None:
                raise ValueError("pad-mask prefill: ring (sliding-window) caches hold "
                                 "the last `window` positions including pads; per-slot "
                                 "serving takes full-attention cache layouts only")
            ring = min(window, max_cache_len)
            take = min(ring, S)
            slots = torch.arange(S - take, S, device=x.device) % ring
            new_cache = {}
            for nm, t in (("k", k), ("v", v)):
                buf = torch.zeros((B, ring, cfg.n_kv_heads, hd), dtype=cdtype,
                                  device=x.device)
                buf[:, slots] = t[:, S - take:].to(cdtype)
                new_cache[nm] = buf
        elif prefill:
            pad = max_cache_len - S
            shp = (B, pad, cfg.n_kv_heads, hd)
            new_cache = {
                nm: torch.cat([t.to(cdtype), torch.zeros(shp, dtype=cdtype,
                                                           device=x.device)], 1)
                for nm, t in (("k", k), ("v", v))
            }
    out = out.reshape(B, S, cfg.n_heads * hd)
    return dense(out, p["o"], ax, "attn_out"), new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(d_model, d_ff, act, dtype, generator, device, bias=False):
    p = {"in": {"w": ninit((d_model, d_ff), dtype, generator, device)},
         "out": {"w": ninit((d_ff, d_model), dtype, generator, device)}}
    if act == "silu":  # swiglu
        p["gate"] = {"w": ninit((d_model, d_ff), dtype, generator, device)}
    if bias:
        p["in"]["b"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["out"]["b"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def mlp_apply(p, x, act, ax: Optional[AxPolicy] = None):
    h = dense(x, p["in"], ax, "mlp")
    if act == "silu":
        h = torch.nn.functional.silu(dense(x, p["gate"], ax, "mlp")) * h
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")
    return dense(h, p["out"], ax, "mlp")
