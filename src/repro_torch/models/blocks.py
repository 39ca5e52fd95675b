"""Non-dense temporal / FFN blocks (``repro.models.blocks``): MoE (token
choice top-k with a capacity-bounded scatter dispatch), RG-LRU
(RecurrentGemma) and Mamba2 SSD (chunked state-space duality), each with an
O(1)-state decode path.

**MoE under a mesh.**  Inside a mesh context (``launch.sharding.set_mesh_ctx``)
whose ``batch`` rule (with ``seq`` when sequence-sharded) spans more than one
rank, each token shard gets its own capacity, ``C_loc = min(max(ceil(T_loc k
/ E * moe_capacity), 8), T_loc)`` over the rank's ``T_loc`` tokens, and the
dispatch and combine run on the rank's tokens alone: the JAX package's
``shard_map``'d dispatch, where under the port's multi-process SPMD a
rank's ``x`` already is its token shard.  One rank, or no mesh context, keeps
the global capacity over all T tokens.  The load-balancing term is the
rank's own (JAX's mean runs over the global batch; serving does not read
it).  The expert all-to-all over a ``"model"`` axis (``ParallelConfig.ep``)
is ROADMAP queue 1, item 8b.

The SWAPPER projection reaches these blocks through ``layers.dense``: the
RG-LRU and SSD ``in``/``gate``/``out`` projections carry the target
``mlp``, as do MoE's shared experts.  The routed experts are three plain
batched products, as in the JAX package (not approximated there either);
their weights are cast once through the weight cache.

In decode (a cache given and one token) the RG-LRU and SSD blocks write
their new ``h``/``conv`` state into the cache tensors they were given, so
a decode step keeps its cache's addresses and stays capturable as a CUDA
graph (``serve/graph.py``).  The state advances for every row: a
``write_mask`` gates only attention writes, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.quant.ax import weight_cast

from .layers import dense, mlp_apply, mlp_init, ninit

__all__ = ["moe_init", "moe_apply", "rglru_init", "rglru_apply", "ssd_init", "ssd_apply"]


def _softplus(x):
    """``log(1 + e^x)`` as JAX's ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ===========================================================================
# Mixture of Experts
# ===========================================================================

def moe_init(cfg: ModelConfig, dtype, generator, device):
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": {"w": ninit((D, E), torch.float32, generator, device)},
        "experts": {
            "in": {"w": ninit((E, D, Fd), dtype, generator, device, scale=1.0 / math.sqrt(D))},
            "gate": {"w": ninit((E, D, Fd), dtype, generator, device,
                                scale=1.0 / math.sqrt(D))},
            "out": {"w": ninit((E, Fd, D), dtype, generator, device,
                               scale=1.0 / math.sqrt(Fd))},
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(D, cfg.n_shared_experts * cfg.moe_d_ff, "silu", dtype,
                               generator, device)
    return p


def _route(flat, router_w, k: int):
    """The f32 router: softmax probabilities (T, E), the top-k weights
    renormalised to sum to one and their expert indices (T, k)."""
    logits = flat.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi


def capacity(T: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``ceil(T k / E * moe_capacity)``, at least 8 and at
    most T."""
    c = int(math.ceil(T * cfg.top_k / cfg.n_experts * cfg.moe_capacity))
    return min(max(c, 8), T)


def _dispatch(flat, topi, k: int, E: int, C: int):
    """Capacity-bounded scatter dispatch with running per-expert slot
    counters (choice j = 0 first, tokens in order within a choice).
    Returns (buf (E, C, D), slots (T, k), keeps (T, k)); a dropped choice
    adds zeros at slot C - 1, so every kept row is written exactly once."""
    T, D = flat.shape
    experts = torch.arange(E, device=flat.device)
    buf = torch.zeros((E * C, D), dtype=flat.dtype, device=flat.device)
    counts = torch.zeros((E,), dtype=torch.int64, device=flat.device)
    slots, keeps = [], []
    for j in range(k):
        oh = (topi[:, j, None] == experts).to(torch.int64)          # (T, E)
        pos = torch.cumsum(oh, dim=0) - oh + counts[None, :]
        counts = counts + oh.sum(0)
        slot = (pos * oh).sum(-1)
        keep = slot < C
        slot = torch.where(keep, slot, torch.full_like(slot, C - 1))
        slots.append(slot)
        keeps.append(keep)
        buf.index_add_(0, topi[:, j] * C + slot, flat * keep[:, None].to(flat.dtype))
    return buf.view(E, C, D), torch.stack(slots, 1), torch.stack(keeps, 1)


def _expert_ffn(buf, experts):
    """SwiGLU per expert, batched over E (plain products, exact)."""
    win, wg, wout = (weight_cast(experts[n]["w"], buf.dtype) for n in ("in", "gate", "out"))
    h = torch.einsum("ecd,edf->ecf", buf, win)
    g = torch.einsum("ecd,edf->ecf", buf, wg)
    return torch.einsum("ecf,efd->ecd", F.silu(g) * h, wout)


def moe_apply(p, x, cfg: ModelConfig):
    """Returns (y (B, S, D), aux): the routed experts' combine plus the
    shared experts, and the load-balancing term
    ``E * mean(mean(probs) * mean(one_hot(top-1)))``.  Under a mesh whose
    ``batch`` rule spans several ranks, ``x`` is this rank's token shard and
    the capacity is its own (module note)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    flat = x.reshape(T, D)
    probs, topv, topi = _route(flat, p["router"]["w"], k)
    # per token shard under a mesh: T is this rank's T_loc (module note)
    C = capacity(T, cfg)
    buf, slots, keeps = _dispatch(flat, topi, k, E, C)
    yflat = _expert_ffn(buf, p["experts"]).reshape(E * C, D)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        gathered = yflat.index_select(0, topi[:, j] * C + slots[:, j])
        w = (topv[:, j] * keeps[:, j].to(torch.float32)).to(x.dtype)
        out = out + gathered * w[:, None]
    if "shared" in p:
        out = out + mlp_apply(p["shared"], flat, "silu", cfg.ax).reshape(T, D)
    top1 = (topi[:, 0, None] == torch.arange(E, device=x.device)).to(torch.float32)
    aux = E * torch.mean(probs.mean(0) * top1.mean(0))
    return out.reshape(B, S, D), aux


# ===========================================================================
# RG-LRU (RecurrentGemma / Griffin)
# ===========================================================================

_LRU_C = 8.0


def rglru_init(cfg: ModelConfig, dtype, generator, device):
    D, R = cfg.d_model, cfg.d_rnn
    # the per-channel decay parameter: the JAX package's numpy draw, bit for bit
    lam = np.random.default_rng(0).uniform(0.3, 0.8, R).astype(np.float32)
    return {
        "in": {"w": ninit((D, R), dtype, generator, device)},
        "gate": {"w": ninit((D, R), dtype, generator, device)},
        "conv": {"w": ninit((4, R), dtype, generator, device, scale=0.5)},
        "wa": {"w": ninit((R, R), dtype, generator, device)},
        "wx": {"w": ninit((R, R), dtype, generator, device)},
        "lam": torch.as_tensor(lam, device=device),
        "out": {"w": ninit((R, D), dtype, generator, device)},
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv of width W: x (B, S, Ch), w (W, Ch); ``state``
    (B, W-1, Ch) holds the previous inputs in decode.  Returns (y, the last
    W-1 inputs)."""
    W = w.shape[0]
    if state is None:
        xp = torch.cat([torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                                    device=x.device), x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(W))
    return y, (xp[:, -(W - 1):] if W > 1 else None)


def _interleave(even, odd):
    """Along dim 1: even[0], odd[0], even[1], ... (len(even) - len(odd) is 0 or 1)."""
    out = torch.empty((even.shape[0], even.shape[1] + odd.shape[1]) + even.shape[2:],
                      dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along dim 1 by the
    odd/even recursion of ``jax.lax.associative_scan``: returns
    (prod a_0..a_t, h_t with h_{-1} = 0)."""
    n = a.shape[1]
    if n < 2:
        return a, b

    def comb(a1, b1, a2, b2):
        return a1 * a2, a2 * b1 + b2

    ra, rb = comb(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _scan(ra, rb)
    if n % 2 == 0:
        ea, eb = comb(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = comb(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _write_state(cache, new):
    """Decode: the new state into the given cache tensors (same addresses)."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def rglru_apply(p, x, cfg: ModelConfig, cache: Optional[dict] = None):
    """Returns (y, new_cache).  cache = {'h': (B, R) f32, 'conv': (B, 3, R)}."""
    B, S, D = x.shape
    xr = dense(x, p["in"], cfg.ax, "mlp")
    gate = dense(x, p["gate"], cfg.ax, "mlp")
    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = _causal_conv(xr, weight_cast(p["conv"]["w"], xr.dtype), conv_state)

    xf = xc.to(torch.float32)
    r = torch.sigmoid(xf @ p["wa"]["w"].to(torch.float32))
    i = torch.sigmoid(xf @ p["wx"]["w"].to(torch.float32))
    log_a = -_LRU_C * _softplus(p["lam"]) * r                    # (B,S,R)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * xf)

    if cache is None or S > 1:
        aa, bb = _scan(a, b)
        h = bb if cache is None else bb + aa * cache["h"][:, None, :]
        h_last = h[:, -1, :]
    else:
        h = (a[:, 0] * cache["h"] + b[:, 0])[:, None, :]
        h_last = h[:, 0]

    y = h.to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = dense(y, p["out"], cfg.ax, "mlp")
    if cache is None:
        return out, None
    new = {"h": h_last, "conv": new_conv}
    return out, (_write_state(cache, new) if S == 1 else new)


# ===========================================================================
# Mamba2 SSD (state-space duality, chunked)
# ===========================================================================

def ssd_init(cfg: ModelConfig, dtype, generator, device):
    D = cfg.d_model
    din = cfg.ssm_expand * D
    H = din // cfg.ssm_head_dim
    N = cfg.ssm_state
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    return {
        "in": {"w": ninit((D, din), dtype, generator, device)},
        "gate": {"w": ninit((D, din), dtype, generator, device)},
        "wb": {"w": ninit((D, N), dtype, generator, device)},
        "wc": {"w": ninit((D, N), dtype, generator, device)},
        "wdt": {"w": ninit((D, H), dtype, generator, device)},
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "a_log": torch.as_tensor(a_log, device=device),
        "d_skip": torch.ones((H,), dtype=torch.float32, device=device),
        "conv": {"w": ninit((4, din + 2 * N), dtype, generator, device, scale=0.5)},
        "out": {"w": ninit((din, D), dtype, generator, device)},
    }


def ssd_apply(p, x, cfg: ModelConfig, cache: Optional[dict] = None):
    """Chunked SSD.  cache = {'h': (B, H, hd, N) f32, 'conv': (B, 3, Ch)}.
    A prompt longer than ``ssm_chunk`` must be a multiple of it."""
    B, S, D = x.shape
    hd = cfg.ssm_head_dim
    din = cfg.ssm_expand * D
    H = din // hd
    N = cfg.ssm_state
    ax = cfg.ax
    f32 = torch.float32

    xin = dense(x, p["in"], ax, "mlp")
    z = dense(x, p["gate"], ax, "mlp")
    Bc = dense(x, p["wb"], None, "")
    Cc = dense(x, p["wc"], None, "")
    dt = _softplus((x @ weight_cast(p["wdt"]["w"], x.dtype)).to(f32) + p["dt_bias"])  # (B,S,H)

    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_conv(conv_in, weight_cast(p["conv"]["w"], x.dtype),
                                      conv_state)
    conv_out = F.silu(conv_out)
    xin = conv_out[..., :din]
    Bc = conv_out[..., din:din + N].to(f32)
    Cc = conv_out[..., din + N:].to(f32)

    a = torch.exp(-torch.exp(p["a_log"]) * dt)                  # (B,S,H) in (0,1)
    xh = xin.reshape(B, S, H, hd).to(f32)
    dx = dt[..., None] * xh                                      # (B,S,H,hd)

    if cache is not None and S == 1:
        h = a[:, 0, :, None, None] * cache["h"] + dx[:, 0, :, :, None] * Bc[:, 0, None, None, :]
        y = torch.einsum("bhdn,bn->bhd", h, Cc[:, 0])
        y = y + p["d_skip"][None, :, None] * xh[:, 0]
        y = y.reshape(B, 1, din)
        out = dense(y.to(x.dtype) * F.silu(z), p["out"], ax, "mlp")
        return out, _write_state(cache, {"h": h, "conv": new_conv})

    # ---- chunked scan over the sequence ----------------------------------
    L = min(cfg.ssm_chunk, S)
    if S % L:
        raise ValueError(f"SSD prefill: a prompt of {S} tokens is not a multiple of the "
                         f"chunk {L}")
    nc = S // L

    def r(t, *shape):
        return t.reshape(B, nc, L, *shape)

    la = torch.cumsum(torch.log(torch.clamp(r(a, H), min=1e-30)), dim=2)   # (B,nc,L,H)
    dx_c = r(dx, H, hd)
    B_c = r(Bc, N)
    C_c = r(Cc, N)

    # intra-chunk: Y1[j] = sum_{i<=j} (C_j . B_i) decay(i->j) dx_i
    sbc = torch.einsum("bnjs,bnis->bnij", C_c, B_c)
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]          # [..., j, i, H]
    idx = torch.arange(L, device=x.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    # the mask goes in before the exp: exp(+large) on the upper triangle is inf
    w_ji = torch.exp(torch.where(mask, diff, torch.full_like(diff, -1e30)))
    y_intra = torch.einsum("bnij,bnjih,bnihd->bnjhd", sbc, w_ji, dx_c)

    # chunk summaries: T_n = sum_i decay(i->end) dx_i B_i^T
    dec_end = torch.exp(la[:, :, -1:, :] - la)
    Tn = torch.einsum("bnlh,bnlhd,bnls->bnhds", dec_end, dx_c, B_c)
    A_n = torch.exp(la[:, :, -1, :])                             # (B,nc,H)

    # cross-chunk scan: the state before each chunk
    h = cache["h"] if cache is not None else torch.zeros((B, H, hd, N), dtype=f32,
                                                          device=x.device)
    h_prev = []
    for n in range(nc):
        h_prev.append(h)
        h = A_n[:, n, :, None, None] * h + Tn[:, n]
    h_prev = torch.stack(h_prev, dim=1)                          # (B,nc,H,hd,N)

    # inter-chunk: Y2[j] = C_j . (decay(start->j) * h_prev)
    y_inter = torch.einsum("bnls,bnlh,bnhds->bnlhd", C_c, torch.exp(la), h_prev)

    y = (y_intra + y_inter).reshape(B, S, H, hd)
    y = y + p["d_skip"][None, None, :, None] * xh
    y = y.reshape(B, S, din).to(x.dtype) * F.silu(z)
    out = dense(y, p["out"], ax, "mlp")
    return out, ({"h": h, "conv": new_conv} if cache is not None else None)
