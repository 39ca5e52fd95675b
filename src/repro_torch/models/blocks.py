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
the global capacity over all T tokens.  In serving the load-balancing term
is the rank's own (serving does not read it, and a decode graph holds no
collective).  Under the sharded train step (``train/distributed.py``) it
is the rank's term of JAX's global term, ``E sum_e (sum_local probs[:, e]
/ T) F_e`` with the all-reduced top-1 frequency ``F_e`` (no gradient) and
the global token count T, so the ranks' terms sum to JAX's; and with
``ep`` over a ``"model"`` axis of n ranks a rank holds ``E / n`` experts:
its ``(E, C_loc, D)`` dispatch buffer goes through the expert all-to-all,
its experts run on every rank's slots for them, and the result comes back
for the local combine (JAX's ``expert_ffn`` resharding around its
``shard_map``'d dispatch and combine).  Experts that do not divide over
``"model"`` stay whole on every rank (``param_spec`` drops the
constraint) and run locally.

**Tensor parallelism** (the sharded train step with a ``"model"`` axis of
several ranks, ``launch.sharding.current_tp``): each block takes its input
whole over ``seq`` and returns its output in the residual's layout
(``models/layers.py``).  MoE follows JAX's dispatch: its token shards are
the batch shards, and under ``seq_shard`` also the model ranks (rank m
takes block m of its batch shard's flattened tokens, as JAX's
``(batch, seq)`` sharding of the flattened T dim lays them out, and its
routed output is summed back into the seq shards); without ``seq_shard``
the model ranks hold the same tokens and the same dispatch.  With ``ep``
a rank's experts run on every token shard's slots for them: the expert
all-to-all when the token shards span ``"model"``, else a slice of the
replicated dispatch buffer, the outputs all-gathered over ``"model"``.
Without ``ep`` the experts' ``ff`` is split over ``"model"``: column- then
row-parallel, the partial sums all-reduced (all-gathered over the token
shards' slots first and reduce-scattered back under ``seq_shard``).  The
shared experts are the MLP's case.  RG-LRU is channel-parallel over
``d_rnn``: ``in``/``gate`` column-parallel, ``conv/w`` and ``lam`` the
rank's channels, the row-split ``wa``/``wx`` products reduce-scattered
over their output channels, the scan per channel, ``out`` row-parallel.
SSD is parallel over its heads: ``in``/``gate`` column-parallel over
``din``, ``a_log``/``d_skip``/``dt_bias`` the rank's heads, ``wb``/``wc``/
``wdt`` replicated (``dt`` computed whole and sliced), the gathered
``conv/w``'s columns of the rank's ``din`` block and of B and C, ``out``
row-parallel.

The SWAPPER projection reaches these blocks through ``layers.dense``: the
RG-LRU and SSD ``in``/``gate``/``out`` projections carry the target
``mlp``, as do MoE's shared experts.  The routed experts are three plain
batched products, as in the JAX package (not approximated there either);
their weights are cast once through the weight cache.

The model-sharded prefill and decode step (``models.registry``) run the
same tensor-parallel blocks.  The RG-LRU and SSD states follow
``launch.mesh.cache_shardings``: whole over ``"model"`` on every rank.  A
rank reads its channels (heads) of them, and each new state is gathered
whole again.  A decode step's MoE splits its tokens over ``"model"`` under
``seq_shard`` where they divide (JAX's dispatch over the flattened batch
and seq shards), else each model rank routes the batch shard's tokens; the
residual is whole over ``seq`` either way.  Where the tokens do not
divide, JAX falls back to one capacity over the global batch, and the port
keeps each batch shard's own (the two differ only where choices drop).

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
from repro_torch.launch.sharding import current_groups, current_tp
from repro_torch.quant.ax import weight_cast

from .layers import _col, _tp_out, dense, mlp_apply, mlp_init, ninit

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
    tm, tp = current_groups(), current_tp()
    if tm is not None and tp is not None:
        return _moe_tp(p, x, cfg, tm, tp)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    flat = x.reshape(T, D)
    probs, topv, topi = _route(flat, p["router"]["w"], k)
    # per token shard under a mesh: T is this rank's T_loc (module note)
    C = capacity(T, cfg)
    buf, slots, keeps = _dispatch(flat, topi, k, E, C)
    if tm is not None and tm.experts is not None and p["experts"]["in"]["w"].shape[0] != E:
        y = tm.experts_apply(buf, lambda b: _expert_ffn(b, p["experts"]))
    else:
        y = _expert_ffn(buf, p["experts"])
    out = _combine(y, topi, topv, slots, keeps, x.dtype)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], flat, "silu", cfg.ax).reshape(T, D)
    top1 = (topi[:, 0, None] == torch.arange(E, device=x.device)).to(torch.float32)
    if tm is None:
        aux = E * torch.mean(probs.mean(0) * top1.mean(0))
    else:
        # this rank's term of the global mean (module note)
        stats = tm.batch_sum(torch.cat([top1.sum(0), top1.new_full((1,), T)]))
        t_all = stats[E]
        aux = E * torch.mean((probs.sum(0) / t_all) * (stats[:E] / t_all))
    return out.reshape(B, S, D), aux


def _combine(y, topi, topv, slots, keeps, dtype):
    """(T, D): each token's kept choices' expert outputs, weighted."""
    E, C, D = y.shape
    yflat = y.reshape(E * C, D)
    out = torch.zeros((topi.shape[0], D), dtype=dtype, device=y.device)
    for j in range(topi.shape[1]):
        gathered = yflat.index_select(0, topi[:, j] * C + slots[:, j])
        w = (topv[:, j] * keeps[:, j].to(torch.float32)).to(dtype)
        out = out + gathered * w[:, None]
    return out


def _moe_tp(p, x, cfg: ModelConfig, tm, tp):
    """``moe_apply`` under tensor parallelism (module note): ``x`` is the
    batch shard's (B, S, D), whole over ``seq``; the output comes in the
    residual's layout, the load-balancing term is this rank's share of the
    global one (``1 / model`` of it where the model ranks hold the same
    tokens)."""
    B, S, D = x.shape
    E, k, Fd = cfg.n_experts, cfg.top_k, cfg.moe_d_ff
    T_all = B * S
    flat = x.reshape(T_all, D)
    # the token shards span "model" under seq_shard; a decode step's
    # residual is whole over seq, its tokens split where they divide
    split = tm.tp.seq and (tp.seq or T_all % tp.n == 0)
    lo, hi = tp.block(T_all) if split else (0, T_all)
    flat = flat[lo:hi]
    T = hi - lo
    probs, topv, topi = _route(flat, p["router"]["w"], k)
    C = capacity(T, cfg)
    buf, slots, keeps = _dispatch(flat, topi, k, E, C)
    ex = p["experts"]
    ffn = lambda b: _expert_ffn(b, ex)                    # noqa: E731
    if tp.split(ex["in"]["w"].shape[0], E):               # ep: the rank's experts
        if split:
            y = tm.experts_apply(buf, ffn)
        else:
            e0, e1 = tp.block(E)
            y = tp.gather(ffn(buf[e0:e1]), 0)
    elif tp.split(ex["in"]["w"].shape[-1], Fd):           # the experts' ff split
        if split:
            y = tp.reduce_scatter(ffn(tp.gather(buf, 1)), 1)
        else:
            y = tp.reduce(ffn(buf))
    else:
        y = ffn(buf)
    out = _combine(y, topi, topv, slots, keeps, x.dtype)
    if split:
        # the token block back into the seq shards: zeros elsewhere, summed
        routed = torch.zeros((T_all, D), dtype=x.dtype, device=x.device)
        routed = routed.index_copy(0, torch.arange(lo, hi, device=x.device), out)
        y_out = tp.exit(routed.reshape(B, S, D), partial=True)
    else:
        y_out = out.reshape(B, S, D)
    if "shared" in p:
        y_out = y_out + mlp_apply(p["shared"], x, "silu", cfg.ax,
                                  d_ff=cfg.n_shared_experts * Fd)
    top1 = (topi[:, 0, None] == torch.arange(E, device=x.device)).to(torch.float32)
    total = tm.token_sum if split else tm.batch_sum
    stats = total(torch.cat([top1.sum(0), top1.new_full((1,), T)]))
    t_all = stats[E]
    aux = E * torch.mean((probs.sum(0) / t_all) * (stats[:E] / t_all))
    return y_out, aux if split else aux / tp.n


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
    """Returns (y, new_cache).  cache = {'h': (B, R) f32, 'conv': (B, 3, R)}.
    Under tensor parallelism channel-parallel over ``d_rnn``, a cache's
    states whole (module note)."""
    B, S, D = x.shape
    tp = current_tp()
    role = _col(tp, p["in"]["w"], cfg.d_rnn)
    split = role is not None
    xr = dense(x, p["in"], cfg.ax, "mlp", tp, role)
    gate = dense(x, p["gate"], cfg.ax, "mlp", tp, role)
    h0 = conv_state = None
    if cache is not None:
        h0, conv_state = cache["h"], cache["conv"]
        if split:                                 # the rank's channels of the states
            c0, c1 = tp.block(cfg.d_rnn)
            h0, conv_state = h0[:, c0:c1], conv_state[..., c0:c1]
    xc, new_conv = _causal_conv(xr, weight_cast(p["conv"]["w"], xr.dtype), conv_state)

    xf = xc.to(torch.float32)
    if split:
        # wa/wx hold the rank's rows (input channels): partial sums over
        # every output channel, reduce-scattered to the rank's channels
        r = torch.sigmoid(tp.reduce_scatter(xf @ p["wa"]["w"].to(torch.float32), -1))
        i = torch.sigmoid(tp.reduce_scatter(xf @ p["wx"]["w"].to(torch.float32), -1))
    else:
        r = torch.sigmoid(xf @ p["wa"]["w"].to(torch.float32))
        i = torch.sigmoid(xf @ p["wx"]["w"].to(torch.float32))
    log_a = -_LRU_C * _softplus(p["lam"]) * r                    # (B,S,R)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * xf)

    if cache is None or S > 1:
        aa, bb = _scan(a, b)
        h = bb if cache is None else bb + aa * h0[:, None, :]
        h_last = h[:, -1, :]
    else:
        h = (a[:, 0] * h0 + b[:, 0])[:, None, :]
        h_last = h[:, 0]

    y = h.to(x.dtype) * F.gelu(gate, approximate="tanh")
    if tp is not None:
        out = _tp_out(y, p["out"], cfg.ax, "mlp", tp, split)
    else:
        out = dense(y, p["out"], cfg.ax, "mlp")
    if cache is None:
        return out, None
    if split:                                     # the states whole again
        h_last, new_conv = tp.all_gather_(h_last, -1), tp.all_gather_(new_conv, -1)
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
    A prompt longer than ``ssm_chunk`` must be a multiple of it.  Under
    tensor parallelism parallel over the heads, a cache's states whole
    (module note)."""
    B, S, D = x.shape
    hd = cfg.ssm_head_dim
    din = cfg.ssm_expand * D
    H = din // hd
    N = cfg.ssm_state
    ax = cfg.ax
    f32 = torch.float32
    tp = current_tp()
    role = _col(tp, p["in"]["w"], din)
    split = role is not None
    h_prev0 = conv_state = None
    if cache is not None:
        h_prev0, conv_state = cache["h"], cache["conv"]

    xin = dense(x, p["in"], ax, "mlp", tp, role)
    z = dense(x, p["gate"], ax, "mlp", tp, role)
    Bc = dense(x, p["wb"], None, "")
    Cc = dense(x, p["wc"], None, "")
    dt = (x @ weight_cast(p["wdt"]["w"], x.dtype)).to(f32)
    conv_w = weight_cast(p["conv"]["w"], x.dtype)
    heads = {n: p[n] for n in ("dt_bias", "a_log", "d_skip")}
    if split:
        # the rank's heads of dt and of the per-head leaves the rules leave
        # whole (``dt_bias`` is a "bias": replicated); the gathered conv/w's
        # columns of its din block and of B and C
        h0, h1 = tp.block(H)
        dt = dt[..., h0:h1]
        heads = {n: t if tp.split(t.shape[0], H) else t[h0:h1] for n, t in heads.items()}
        c0, c1 = tp.block(din)
        conv_w = torch.cat([conv_w[:, c0:c1], conv_w[:, din:]], dim=1)
        if cache is not None:                     # the rank's heads of the states
            h_prev0 = h_prev0[:, h0:h1]
            conv_state = torch.cat([conv_state[..., c0:c1], conv_state[..., din:]], dim=-1)
        din, H = c1 - c0, h1 - h0
    dt = _softplus(dt + heads["dt_bias"])                       # (B,S,H)

    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, conv_w, conv_state)
    conv_out = F.silu(conv_out)
    xin = conv_out[..., :din]
    Bc = conv_out[..., din:din + N].to(f32)
    Cc = conv_out[..., din + N:].to(f32)

    a = torch.exp(-torch.exp(heads["a_log"]) * dt)              # (B,S,H) in (0,1)
    xh = xin.reshape(B, S, H, hd).to(f32)
    dx = dt[..., None] * xh                                      # (B,S,H,hd)

    if cache is not None and S == 1:
        h = a[:, 0, :, None, None] * h_prev0 + dx[:, 0, :, :, None] * Bc[:, 0, None, None, :]
        y = torch.einsum("bhdn,bn->bhd", h, Cc[:, 0])
        y = y + heads["d_skip"][None, :, None] * xh[:, 0]
        y = y.reshape(B, 1, din).to(x.dtype) * F.silu(z)
        out = (_tp_out(y, p["out"], ax, "mlp", tp, split) if tp is not None
               else dense(y, p["out"], ax, "mlp"))
        return out, _write_state(cache, _ssd_whole(h, new_conv, din, tp, split))

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
    h = h_prev0 if cache is not None else torch.zeros((B, H, hd, N), dtype=f32,
                                                       device=x.device)
    h_prev = []
    for n in range(nc):
        h_prev.append(h)
        h = A_n[:, n, :, None, None] * h + Tn[:, n]
    h_prev = torch.stack(h_prev, dim=1)                          # (B,nc,H,hd,N)

    # inter-chunk: Y2[j] = C_j . (decay(start->j) * h_prev)
    y_inter = torch.einsum("bnls,bnlh,bnhds->bnlhd", C_c, torch.exp(la), h_prev)

    y = (y_intra + y_inter).reshape(B, S, H, hd)
    y = y + heads["d_skip"][None, None, :, None] * xh
    y = y.reshape(B, S, din).to(x.dtype) * F.silu(z)
    if tp is not None:
        out = _tp_out(y, p["out"], ax, "mlp", tp, split)
    else:
        out = dense(y, p["out"], ax, "mlp")
    return out, (_ssd_whole(h, new_conv, din, tp, split) if cache is not None else None)


def _ssd_whole(h, conv, din: int, tp, split: bool) -> dict:
    """A new SSD state whole on every rank (module note): under a head split
    the rank's heads of ``h`` and its ``din`` channels of ``conv``
    all-gathered, B and C's channels (the same on every rank) kept."""
    if not split:
        return {"h": h, "conv": conv}
    return {"h": tp.all_gather_(h, 1),
            "conv": torch.cat([tp.all_gather_(conv[..., :din], -1), conv[..., din:]], dim=-1)}
