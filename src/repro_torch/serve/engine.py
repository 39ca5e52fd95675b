"""Batched serving loop (``repro.serve.engine``): prefill once, then one
decode step per token against the KV cache, with per-slot positions.

**Per-slot decode.**  Every path carries an int64 (B,) position vector and
per-slot done-flags on the device: ``(i < budget) & (tok != eos)``, the
budget from ``slot_new_tokens`` and the EOS guard from
``ServeConfig.eos_id``.  A retired slot's token freezes (the output repeats
it), its cache write is dropped (the cache row stays byte-identical) and its
position stops.  ``prompt_lens`` switches prefill to the pad-mask path:
right-padded prompts attend only to real tokens, the first token is sampled
at each slot's last real position and decode starts at ``prompt_lens``, so a
padded prompt generates exactly what it generates unpadded.  Without these
arguments every slot is live for the whole generation, which gives the
tokens of the JAX package's scalar path.

**Families.**  Every family serves here: a prompt batch is ``{"tokens":
(B, S)}``, ``{"embeds": (B, S, D), "pos": (B, S, 3)}`` for the vlm family,
or ``{"frames": (B, T, D), "tokens": (B, S)}`` for the encoder-decoder
(whisper).  As in JAX the encoder-decoder serves the whole batch at one
position: it refuses ``prompt_lens``, ``slot_new_tokens``, ``slot_seeds``
and ``eos_id``, and it refuses ``adaptive`` too, which the JAX package
cannot serve on it (``ValueError``; ROADMAP queue 3).  Its cross-attention
K/V live in the decode cache, so its decode step is captured like any
other.  The pad-mask prefill (``prompt_lens``, and so
:func:`prefill_one`) needs a full-attention stack and raises
``ValueError`` on one with ring, recurrent or SSM state, as JAX asserts;
budgets and EOS work on every stack, a retired slot's recurrent and SSM
state advancing as in JAX.  The decode cache is any per-layer dict of
tensors with the batch on dim 0, which the graph programs copy and
:func:`splice_slot` writes row by row.

**Sampling** (:func:`slot_sample`).  Greedy (``temperature == 0``) is
``argmax`` with the first maximum winning, as in JAX.  ``temperature > 0`` is
a counter-based Gumbel-max: the noise of vocabulary entry v for token t of
a request seeded s is an integer hash of (s, t, v), made with tensor ops.
A draw depends on the request alone (splice-invariant, as JAX's
``fold_in(PRNGKey(s), t)`` streams are), the hash gives the same bits on the
CPU and the card, and a CUDA graph needs no generator state.  It is not
JAX's threefry stream.  Without ``slot_seeds`` slot b draws from the seed
``ServeConfig.seed * 1000003 + b``.

**The decode step as a CUDA graph** (``serve/graph.py``).  On the card the
fused paths (``fused=True`` without a ``param_hook``: the static serve and
the adaptive serve with its policy frozen per generation) and
:func:`token_step` replay one captured graph per decode program and per
observe gate, the counterpart of JAX's one ``lax.scan`` per generation;
``ServeConfig.cuda_graphs=False`` runs them eagerly.  Stepwise serves (a
``param_hook``, or ``fused=False``) stay eager, as JAX's stepwise loop is
one dispatch per step.  On the CPU every path is eager.

With an :class:`~repro_torch.runtime.AdaptiveController` attached, every
decode step runs inside an adaptive-runtime scope: the SWAPPER configs of
``cfg.ax.targets`` are the controller's int32 device tensors, observed
steps (``ServeConfig.observe_every``, and only while some slot's budget
lasts: ``i < max(budget)``, EOS-agnostic as in JAX) emit telemetry records,
and the controller folds them in and re-tunes.  Prefill runs the static
policy, as in JAX.  The fused schedule reads the policy once per
generation and folds the observed steps' records in after the loop; the
stepwise schedule reads it before every step and observes step i-1's
records after step i was issued, so the controller's work overlaps step i
on the card.

**Observability** (``obs``, the JAX package's series).  ``prefill`` and
``decode`` spans, ``repro_prefill_dispatch_seconds``,
``repro_decode_dispatch_seconds{path=}`` (``fused``, ``fused_adaptive`` or
``stepwise``), ``repro_decode_tokens_total`` and
``repro_slots_retired_total``; each graph capture counts into
``repro_retraces_total`` (``serve/graph.py``).  All of it is host clock and
dict writes outside the captured step: no host synchronise is added.

The continuous batcher (``fleet/scheduler.py``) drives :func:`token_step`,
:func:`prefill_one` and :func:`splice_slot` in its token mode and
:func:`generate` in its wave mode.  :func:`prefill_one` reads nothing back
from the card (a host prompt goes up through pinned memory), so a batcher
can launch an admission's prefill and read its first token later.

**The fleet mesh** (``mesh=``, a ``launch.mesh.make_fleet_mesh`` mesh).
The port is multi-process SPMD: every rank calls :func:`generate` or
:func:`token_step` with the same global arguments, and each serves its
block of the slot batch (``fleet.collect.shard_decode_specs`` /
``token_step_specs`` and ``shard_args``) with the one-card kernels and
CUDA graphs, unchanged.  After each observed step's replay the rank's
records are aggregated over the mesh (``fleet.collect.aggregate_records``:
all-reduce SUM and MAX, all-gather), outside the captured step, so every
rank's controller observes the fleet record and takes the same decisions.
The tokens come back all-gathered in the global batch order.  The observe
gate reads the global budget maximum, so it is the same on every rank.
``mesh=`` needs the adaptive fused path: an adaptive controller, no
``param_hook`` and ``fused=True`` (``ValueError``, where JAX asserts).
:func:`token_step` under a mesh takes the global per-slot vectors and the
rank's own cache rows.

**The model-sharded serve** (``par=``, under ``launch.sharding.set_mesh_ctx``
of a mesh with several ``"model"`` ranks; ``models.registry``'s note).
Every rank calls :func:`generate`, :func:`token_step`, :func:`prefill_one`
and :func:`splice_slot` with the same global arguments (prompts, per-slot
vectors, slot indices) and its own blocks of the weights
(``launch.parallel.serve_params``) and of the cache; the prefill and each
decode step run on the rank's rows with the model split over ``"model"``
and the cache split on its sequence, and the sampled tokens are
all-gathered over the batch axes, so every rank holds the global tokens and
returns them.  With an adaptive controller every rank's records are the
whole batch's (``quant.ax.ax_dense_dyn``: the sampled rows gathered from
the ranks that hold them, a tile grid over the whole batch's row tiles), so
every rank's controller observes the same records and takes the same
decisions, those of JAX's GSPMD serve's one controller.

Over ``nccl`` (one rank per card) the decode step is captured as a CUDA
graph and replayed, as on one card: the fused static and adaptive serves
and :func:`token_step`, so the continuous batcher's token mode too.  The
step's ``nccl`` collectives are captured with its kernels (the program's
eager first step creates every group's communicator before its capture;
``launch.mesh`` binds each rank's card and initialises ``nccl`` eagerly),
its index tensors are made on the device or once before the capture
(``runtime.telemetry.tp_operands``), and its float sums over ranks add in
rank order (``launch.parallel``'s note), so a replay gives the eager
step's bits and every rank those of one card adding the blocks in rank
order.  Every rank replays the same graphs in the same order: the gates
come from host values every rank shares, the records are the whole
batch's on every rank, and nothing is aggregated inside a replay.  A
program's key names the context (:func:`_mesh_sig`: the mesh, ``par``,
the rank's rows and model block, the groups), so a program captured
under one context is never replayed under another.  A capture or a
collective that fails raises: nothing falls back to eager.  Over
``gloo`` (two ranks sharing a card, or the CPU) the step runs eagerly: a
step asked for as a CUDA graph (whose ``gloo`` collectives go through the
host, which a graph cannot capture) raises ``ValueError``
(:func:`model_sharded_graphs` says which; pass
``ServeConfig(cuda_graphs=False)`` or ``token_step(cuda_graphs=False)``).
``mesh=`` (the fleet mesh) under a model-sharded context raises
``ValueError`` whatever the backend.  :func:`prefill_one` then
prefills its ``rows`` copies of the request over the ranks' rows, its first
token gathered from the rank that holds row 0, and its cache is the rank's
block of a slot cache of ``rows`` slots, which :func:`splice_slot` writes
on the rank that holds the slot's row.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.sharding import current_groups, current_tp
from repro_torch.models import decode_step, prefill
from repro_torch.runtime.scope import ax_scope
from repro_torch.runtime.telemetry import finish_host_copy, start_host_copy

from . import graph as G

__all__ = ["ServeConfig", "generate", "slot_sample", "token_step", "prefill_one",
           "splice_slot", "model_sharded_graphs"]

_PREFILL_WALL = obs.default_registry().histogram(
    "repro_prefill_dispatch_seconds",
    "host wall of generate()'s prefill + first-token sample "
    "(async dispatch: excludes on-device completion)",
    buckets=obs.DISPATCH_BUCKETS)
_DECODE_WALL = obs.default_registry().histogram(
    "repro_decode_dispatch_seconds",
    "host wall of generate()'s decode-loop dispatch by path "
    "(async dispatch: excludes on-device completion)",
    buckets=obs.DISPATCH_BUCKETS)
_DECODE_TOKENS = obs.default_registry().counter(
    "repro_decode_tokens_total",
    "tokens produced by generate() decode loops (slots x steps)")
_SLOTS_RETIRED = obs.default_registry().counter(
    "repro_slots_retired_total",
    "slots whose done-flag fires before the scan/budget end "
    "(per-slot token budgets below the generation length)")


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0   # 0 => greedy
    seed: int = 0
    fused: bool = True         # one frozen policy per generation (a graph on the card)
    observe_every: int = 1     # adaptive telemetry decimation period (k >= 1)
    eos_id: Optional[int] = None   # a slot that samples it retires the next step
    cuda_graphs: bool = True   # card: replay the fused decode step as a CUDA graph


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2^32`` for uint32 values held in int64 (the product is
    split so that no intermediate leaves int64)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """MurmurHash3's 32-bit finaliser on int64-held uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _gumbel(seeds, nt, vocab: int, device):
    """(B, vocab) float32 Gumbel noise of token ``nt[b]`` of the request
    seeded ``seeds[b]``: a hash of (seed, token index, vocabulary index)
    mapped to a uniform in (0, 1) with 24 bits, then -log(-log(u))."""
    s = _fmix32((seeds.to(torch.int64) & _M32) ^ 0x9E3779B9)
    s = _fmix32(s ^ (nt.to(torch.int64) & _M32))
    v = torch.arange(vocab, dtype=torch.int64, device=device)
    h = _fmix32(s[:, None] ^ _mul32(v, 0x27D4EB2F)[None, :])
    u = ((h >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)
    return -torch.log(-torch.log(u))


def slot_sample(last_logits, seeds, nt, temperature: float):
    """Per-request sampling (``repro.serve.engine.slot_sample``): row b of
    ``last_logits`` (B, V) draws token index ``nt[b]`` of the request seeded
    ``seeds[b]`` (module note).  ``temperature <= 0`` is argmax, the first
    maximum winning, and needs no seeds."""
    lg = last_logits.to(torch.float32)
    if temperature <= 0:
        return torch.argmax(lg, dim=-1)
    inv_t = float(np.float32(1.0) / np.float32(temperature))
    return torch.argmax(lg * inv_t + _gumbel(seeds, nt, lg.shape[-1], lg.device), dim=-1)


def _default_seeds(seed: int, B: int, device):
    return torch.arange(B, dtype=torch.int64, device=device) + int(seed) * 1000003


# ---------------------------------------------------------------------------
# one decode step on a state of device tensors
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _State:
    """The decode state, all on the device: the last tokens, per-slot
    positions, token counters and budgets, the step index ``i`` (1,), the
    seeds, the cache and the output rows (B, 1 + steps)."""
    tok: torch.Tensor
    pos: torch.Tensor
    nt: torch.Tensor
    budget: torch.Tensor
    i: torch.Tensor
    seeds: torch.Tensor
    cache: list
    out: torch.Tensor


def _decode(params, st: _State, cfg, *, temperature, eos_id, dyn=None, gate=False,
            tile_rows=0, par=None, rows=None):
    """One decode step: done-flags, the model step with gated cache writes,
    sampling and freeze; the state advances in place (no host read).
    Returns the step's stacked telemetry records when an adaptive scope
    observes it, else None.  ``rows`` (the model-sharded serve): this
    rank's (lo, hi) of the batch and the gather of its sampled tokens."""
    active = st.i < st.budget
    if eos_id is not None:
        active = active & (st.tok != eos_id)
    scope = (ax_scope(dyn, collect=True, gate=gate, tile_rows=tile_rows)
             if dyn is not None else contextlib.nullcontext())
    with scope as sc:
        logits, _ = decode_step(params, st.cache, st.tok[:, None], st.pos, cfg, par,
                                write_mask=None if cfg.family == "encdec" else active)
    nxt = _sample_rows(logits[:, -1], st.seeds, st.nt, temperature, rows)
    tok = torch.where(active, nxt, st.tok)
    inc = active.to(torch.int64)
    st.tok.copy_(tok)
    st.pos.add_(inc)
    st.nt.add_(inc)
    st.i.add_(1)
    st.out.index_copy_(1, st.i, tok[:, None])
    return sc.collected() if (dyn is not None and gate) else None


def _sample_rows(last_logits, seeds, nt, temperature, rows):
    """:func:`slot_sample` of the whole batch; ``rows`` (lo, hi, gather):
    the logits are the rank's rows, and their samples come back gathered."""
    if rows is None:
        return slot_sample(last_logits, seeds, nt, temperature)
    lo, hi, gather = rows
    return gather(slot_sample(last_logits, seeds[lo:hi], nt[lo:hi], temperature))


def _shard_rows(B: int):
    """``(lo, hi, gather)`` of a global batch of ``B`` under a model-sharded
    mesh: this rank's rows and the all-gather of a per-row result to the
    whole batch (module note); None otherwise."""
    if current_tp() is None:
        return None
    tm = current_groups()
    lo, hi = tm.rows(B)
    return lo, hi, lambda t: tm.gather_rows(t, B)


def _state_like(st: _State) -> _State:
    """Static buffers shaped like ``st`` (a graph program's own state)."""
    fields = {f.name: torch.empty_like(getattr(st, f.name))
              for f in dataclasses.fields(_State) if f.name != "cache"}
    cache = [{k: torch.empty_like(v) for k, v in c.items()} for c in st.cache]
    return _State(cache=cache, **fields)


def _copy_state(dst: _State, src: _State) -> None:
    for f in dataclasses.fields(_State):
        a, b = getattr(dst, f.name), getattr(src, f.name)
        if f.name == "cache":
            for ca, cb in zip(a, b):
                for k in ca:
                    ca[k].copy_(cb[k])
        else:
            a.copy_(b)


def _use_graphs(device: torch.device, enabled: bool) -> bool:
    """CUDA graphs run on the card only (module note)."""
    return enabled and device.type == "cuda"


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _upload(x, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``device``.  A host array goes to the card
    through pinned memory, asynchronously: a copy from pageable memory
    would synchronise the host."""
    t = torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _dyn_on(adaptive, device):
    return {k: v.to(device) for k, v in adaptive.dyn_tree().items()}


def _cache_sig(cache):
    """A cache's part of a program key: its longest K/V length (0 for a
    stack of recurrent or SSM state only), and an encoder-decoder's frame
    count beside it.  With the config and the batch, which the key also
    holds, it fixes every layer's shape."""
    kv = max((c["k"].shape[1] for c in cache if "k" in c), default=0)
    enc = max((c["xk"].shape[1] for c in cache if "xk" in c), default=0)
    return (kv, enc) if enc else kv


def _check_encdec(cfg, adaptive, prompt_lens, slot_new_tokens, slot_seeds, eos_id):
    """The encoder-decoder's refusals (module note)."""
    if cfg.family != "encdec":
        return
    asked = [n for n, v in (("prompt_lens", prompt_lens), ("slot_new_tokens", slot_new_tokens),
                            ("slot_seeds", slot_seeds), ("eos_id", eos_id)) if v is not None]
    if asked:
        raise ValueError(f"{cfg.name}: per-slot decode ({', '.join(asked)}) is not supported "
                         f"for encoder-decoder models (nor in the JAX package)")
    if adaptive is not None:
        raise ValueError(f"{cfg.name}: adaptive serving of the encoder-decoder is refused: the "
                         f"JAX package fails there (an int8 telemetry record leaks out of its "
                         f"scan over layers; ROADMAP queue 3)")


def _dyn_sig(dyn):
    return tuple((k, tuple(v.shape)) for k, v in sorted(dyn.items())) if dyn else None


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

def generate(params, prompt_batch, cfg: ModelConfig, scfg: ServeConfig, *,
             par: Optional[ParallelConfig] = None, adaptive=None,
             param_hook: Optional[Callable] = None,
             prompt_lens=None, slot_new_tokens=None, slot_seeds=None,
             max_cache_len: Optional[int] = None, stats: Optional[dict] = None,
             mesh=None):
    """prompt_batch: {'tokens': (B, S)}, {'embeds': (B, S, D), 'pos':
    (B, S, 3)} for the vlm family, or {'frames': (B, T, D), 'tokens':
    (B, S)} for the encoder-decoder (module note).  Returns
    (B, max_new_tokens) int32 on the params' device.

    ``adaptive`` — optional AdaptiveController driving the dynamic SWAPPER
    policy of ``cfg.ax.targets`` during decode (see the module note).
    ``param_hook(step, params) -> params`` — optional per-step parameter
    transform (synthetic drift); forces the stepwise schedule.
    ``prompt_lens`` — optional (B,) real prompt lengths (pad-mask prefill).
    ``slot_new_tokens`` — optional (B,) per-slot token budgets, each at most
    ``max_new_tokens``: a slot past its budget retires in place.
    ``slot_seeds`` — optional (B,) per-request sampling seeds.
    ``max_cache_len`` — optional decode-cache length (at least S +
    max_new_tokens + 1).
    ``stats`` — optional dict that receives ``prefill_s`` (prefill and the
    first token) and ``decode_s`` (the remaining steps, the adaptive
    controller's work included), host-clock walls taken after a device
    synchronise, and ``path`` (``"graph"`` or ``"eager"``).
    ``mesh`` — a fleet mesh: this rank serves its block of the batch and
    every rank returns the global tokens (module note).
    ``par`` — as JAX's, passed to ``prefill`` and ``decode_step``; under
    ``set_mesh_ctx`` of a model-sharded mesh the weights are this rank's
    blocks and every rank returns the global tokens (module note).
    """
    _check_encdec(cfg, adaptive, prompt_lens, slot_new_tokens, slot_seeds, scfg.eos_id)
    if mesh is not None and (adaptive is None or param_hook is not None or not scfg.fused):
        raise ValueError("mesh= requires the adaptive fused path (an adaptive controller, "
                         "fused=True and no param_hook)")
    device = params["embed"]["w"].device
    if current_tp() is not None:
        _check_model_sharded(device, scfg.cuda_graphs and scfg.fused and param_hook is None,
                             mesh)
    batch = {k: torch.as_tensor(v, device=device) for k, v in prompt_batch.items()}
    B, S = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[:2]
    max_len = max_cache_len or (S + scfg.max_new_tokens + 1)
    if max_len < S + scfg.max_new_tokens + 1:
        raise ValueError(f"max_cache_len {max_len} < prompt {S} + "
                         f"{scfg.max_new_tokens} new tokens + 1")
    if scfg.observe_every < 1:
        raise ValueError(f"observe_every must be >= 1: {scfg.observe_every}")
    n_steps = scfg.max_new_tokens - 1
    budget_host = np.full(B, n_steps, np.int64)
    if slot_new_tokens is not None:
        budget_host = np.asarray(slot_new_tokens, np.int64).reshape(B) - 1
        if budget_host.max() > n_steps or budget_host.min() < 0:
            raise ValueError(f"slot_new_tokens must lie in 1..{scfg.max_new_tokens}: "
                             f"{budget_host + 1}")
    pl = None
    if prompt_lens is not None:
        pl = torch.as_tensor(np.asarray(prompt_lens), dtype=torch.int64,
                             device=device).reshape(B)
    seeds = (_default_seeds(scfg.seed, B, device) if slot_seeds is None else
             torch.as_tensor(np.asarray(slot_seeds), dtype=torch.int64, device=device)
             .reshape(B))
    # the observe gate reads the global budget maximum (shard-invariant)
    bmax = int(budget_host.max()) if B else 0
    shard_rows = _shard_rows(B)
    group = None
    if mesh is not None:
        from repro_torch.fleet import collect

        in_specs, out_specs, _ = collect.shard_decode_specs(None, B, mesh,
                                                            seeded=slot_seeds is not None)
        rows, group = in_specs[2], collect.batch_group(mesh)[0]
        batch = {k: collect.local_slice(v, rows, mesh) for k, v in batch.items()}
        pl = collect.local_slice(pl, in_specs[4], mesh)
        budget_host = collect.local_slice(budget_host, in_specs[5], mesh)
        seeds = collect.local_slice(seeds, rows, mesh)
        B = B // collect.world_size(group)

    with torch.inference_mode():
        t0 = time.perf_counter()
        with obs.span("prefill", cat="engine", batch=B, seq=S):
            logits, cache = prefill(params, batch, cfg, par, max_cache_len=max_len,
                                    prompt_lens=pl)
            if pl is None:
                last = logits[:, -1]
            else:
                lo = shard_rows[0] if shard_rows is not None else 0
                pl_rows = pl[lo:lo + logits.shape[0]]
                last = logits[torch.arange(logits.shape[0], device=device), pl_rows - 1]
            zeros = torch.zeros(B, dtype=torch.int64, device=device)
            tok = _sample_rows(last, seeds, zeros, scfg.temperature, shard_rows)
            if stats is not None:
                _sync(device)
                stats["prefill_s"] = time.perf_counter() - t0
        _PREFILL_WALL.observe(time.perf_counter() - t0)
        if prompt_lens is not None or slot_new_tokens is not None or slot_seeds is not None \
                or scfg.eos_id is not None:
            # slots whose budget ends before the generation does (JAX counts
            # them on its per-slot path only)
            _SLOTS_RETIRED.inc(int(np.sum(budget_host < n_steps)))
        t0 = time.perf_counter()
        out = torch.zeros((B, scfg.max_new_tokens), dtype=torch.int64, device=device)
        out[:, 0] = tok
        st = _State(tok=tok, pos=(torch.full((B,), S, dtype=torch.int64, device=device)
                                  if pl is None else pl.clone()),
                    nt=torch.ones(B, dtype=torch.int64, device=device),
                    budget=torch.as_tensor(budget_host, device=device),
                    i=torch.zeros(1, dtype=torch.int64, device=device),
                    seeds=seeds, cache=cache, out=out)
        k = scfg.observe_every
        gates = [adaptive is not None and i % k == 0 and i < bmax for i in range(n_steps)]
        graphs = _use_graphs(device, scfg.cuda_graphs)
        fused = param_hook is None and scfg.fused
        path = "eager"
        kind = ("stepwise" if not fused else
                "fused" if adaptive is None else "fused_adaptive")
        with obs.span("decode", cat="engine", path=kind, batch=B,
                      steps=scfg.max_new_tokens):
            if fused and n_steps > 0:
                dyn = _dyn_on(adaptive, device) if adaptive is not None else None
                tile_rows = adaptive.tile_rows if adaptive is not None else 0
                kw = dict(temperature=scfg.temperature, eos_id=scfg.eos_id,
                          tile_rows=tile_rows, par=par, rows=shard_rows)
                if graphs:
                    path = "graph"
                    st = _fused_graph(params, st, cfg, dyn, gates, kw, max_len, adaptive,
                                      group)
                else:
                    copies = []
                    for gate in gates:
                        rec = _decode(params, st, cfg, dyn=dyn, gate=gate, **kw)
                        if rec is not None:
                            copies.append(start_host_copy(_fleet(rec, group)))
                    for copy in copies:
                        adaptive.observe(finish_host_copy(copy))
            elif n_steps > 0:
                _decode_stepwise(params, st, cfg, scfg, adaptive, param_hook, gates,
                                 par=par, rows=shard_rows)
            result = st.out.to(torch.int32)
            if mesh is not None:      # (steps, B) tokens, as JAX's spec reads them
                result = collect.gather_outputs((result.T,), out_specs[:1], mesh)[0].T
            if stats is not None:
                _sync(device)
                stats["decode_s"] = time.perf_counter() - t0
                stats["path"] = path
        _DECODE_WALL.observe(time.perf_counter() - t0, path=kind)
        _DECODE_TOKENS.inc(B * scfg.max_new_tokens)
    return result


def model_sharded_graphs() -> bool:
    """Whether the installed model-sharded context's decode step may be
    captured as a CUDA graph: its groups are ``nccl`` (each group of a mesh
    takes the world's backend; module note)."""
    return dist.get_backend() == "nccl"


def _check_model_sharded(device, graphs: bool, mesh) -> None:
    """The refusals of the model-sharded serve (module note): the fleet mesh,
    and a decode step captured as a CUDA graph over a group that is not
    ``nccl``."""
    if mesh is not None:
        raise ValueError("mesh= (the fleet mesh) and a model-sharded mesh context do not "
                         "combine")
    if _use_graphs(device, graphs) and not model_sharded_graphs():
        raise ValueError(f"a model-sharded decode step over "
                         f"{dist.get_backend()} runs collectives "
                         f"through the host, which a CUDA graph cannot capture (nccl's it "
                         f"can): pass ServeConfig(cuda_graphs=False) to generate, "
                         f"cuda_graphs=False to token_step")


def _mesh_sig(B: int):
    """A program key's part for the installed model-sharded context: its
    mesh, groups and this rank's block layout for a global batch of ``B``
    (``MeshGroups.signature``), so a program captured under one context is
    never replayed under another; None outside one."""
    return current_groups().signature(B) if current_tp() is not None else None


def _fleet(rec, group):
    """A step's records aggregated over the mesh's batch group (a copy, so
    a graph's output buffers may be overwritten by the next replay)."""
    if group is None:
        return rec
    from repro_torch.fleet import collect

    return collect.aggregate_records(rec, group)


def _fused_graph(params, st: _State, cfg, dyn, gates, kw, max_len, adaptive, group=None):
    """The fused paths on the card: the program's static state takes this
    generation's values, then each step replays the captured graph of its
    gate (module note of ``serve/graph.py``); under a mesh each observed
    step's records are aggregated after its replay.  Returns the program's
    state, whose ``out`` holds the tokens."""
    B = st.tok.shape[0]
    key = ("fused" if dyn is None else "fused_adaptive", cfg, B, max_len, st.out.shape[1],
           kw["temperature"], kw["eos_id"], kw["tile_rows"], _dyn_sig(dyn),
           _cache_sig(st.cache), _mesh_sig(B))

    def build():
        buf = dict(state=_state_like(st), dyn=({k: torch.empty_like(v) for k, v in dyn.items()}
                                               if dyn is not None else None))

        def step(gate):
            return _decode(params, buf["state"], cfg, dyn=buf["dyn"], gate=gate, **kw)

        return G.StepProgram(key, [params, buf], step, buf)

    prog = G.program(key, (params,), build)
    _copy_state(prog.buf["state"], st)
    if dyn is not None:
        for name, v in dyn.items():
            prog.buf["dyn"][name].copy_(v)
    copies = []
    for gate in gates:
        rec = prog.run(gate)
        if gate:
            copies.append(start_host_copy(_fleet(rec, group)))
    for copy in copies:
        adaptive.observe(finish_host_copy(copy))
    return prog.buf["state"]


def _decode_stepwise(params, st: _State, cfg, scfg, adaptive, param_hook, gates, par=None,
                     rows=None):
    """One eager step at a time (``engine.py:558``): the params hook and
    the per-step policy read come before each step; step i-1's records are
    observed after step i was issued, while it runs."""
    kw = dict(temperature=scfg.temperature, eos_id=scfg.eos_id,
              tile_rows=adaptive.tile_rows if adaptive is not None else 0, par=par, rows=rows)
    pending = None
    for i, gate in enumerate(gates):
        if param_hook is not None:
            params = param_hook(i, params)
        dyn = _dyn_on(adaptive, st.tok.device) if adaptive is not None else None
        rec = _decode(params, st, cfg, dyn=dyn, gate=gate, **kw)
        copy = start_host_copy(rec) if rec is not None else None
        if pending is not None:
            adaptive.observe(finish_host_copy(pending))
        pending = copy
    if pending is not None:
        adaptive.observe(finish_host_copy(pending))


# ---------------------------------------------------------------------------
# token-granular serving: one decode step, a single-request prefill, a splice
# ---------------------------------------------------------------------------

def _token_decode(params, buf, cfg, *, temperature, eos_id, tile_rows, gate, par=None,
                  rows=None):
    """The token step on its buffers: ``active & (tok != eos)`` gates the
    cache write and the sample; pos and nt stay the caller's.  ``rows``:
    as :func:`_decode`'s."""
    active = buf["active"]
    if eos_id is not None:
        active = active & (buf["tok"] != eos_id)
    dyn = buf["dyn"]
    scope = (ax_scope(dyn, collect=True, gate=gate, tile_rows=tile_rows)
             if dyn is not None else contextlib.nullcontext())
    with scope as sc:
        logits, _ = decode_step(params, buf["cache"], buf["tok"][:, None], buf["pos"], cfg,
                                par, write_mask=active)
    nxt = _sample_rows(logits[:, -1], buf["seeds"], buf["nt"], temperature, rows)
    buf["tok_out"].copy_(torch.where(active, nxt, buf["tok"]))
    return sc.collected() if (dyn is not None and gate) else None


def token_step(params, cache, tok, pos, active, cfg: ModelConfig,
               par: Optional[ParallelConfig] = None, *,
               temperature: float = 0.0, adaptive=None, gate: bool = True,
               eos_id: Optional[int] = None, seeds=None, nt=None,
               cuda_graphs: bool = True, mesh=None):
    """One token-granular decode step for the whole slot batch
    (``repro.serve.engine.token_step``): ``tok`` (B,) the last tokens,
    ``pos`` (B,) per-slot positions, ``active`` (B,) done-flags (False
    slots keep their token and skip their cache write).  ``eos_id`` also
    freezes a slot whose token is EOS.  ``seeds``/``nt`` (together; needed
    for ``temperature > 0``) select per-request sampling.

    Returns ``(tok', cache)``, the cache updated in place, plus the step's
    telemetry records when ``adaptive`` is attached (None when ``gate`` is
    False).  The caller advances ``pos`` and ``nt`` by ``active``.  On the
    card the step is a CUDA graph per program (module note): the inputs are
    copied into its buffers, the records are its output buffers (valid
    until the next step of the same program), and a splice or a policy
    update changes values only.

    ``mesh`` (with ``adaptive``): the per-slot vectors are the global
    batch's, ``cache`` holds this rank's rows; the step runs on the rank's
    block, its records come back aggregated over the mesh and ``tok'``
    all-gathered (module note).

    ``par``: as JAX's, passed to ``decode_step``.  Under a model-sharded
    mesh the per-slot vectors are the global batch's and ``cache`` is this
    rank's block of the slot cache (``launch.mesh.cache_shardings``); its
    records are the whole batch's and ``tok'`` the global tokens on every
    rank.  Over ``nccl`` the step is a CUDA graph per program as on one
    card, its key naming the context; over ``gloo`` it runs eagerly
    (``cuda_graphs=True`` on the card raises ``ValueError``; module
    note)."""
    device = params["embed"]["w"].device
    shard_rows = None
    if current_tp() is not None:
        _check_model_sharded(device, cuda_graphs, mesh)
        shard_rows = _shard_rows(int(tok.shape[0]))
    if (seeds is None) != (nt is None):
        raise ValueError("seeds and nt come together")
    if mesh is not None:
        if adaptive is None:
            raise ValueError("mesh= requires the adaptive token step")
        from repro_torch.fleet import collect

        in_specs, out_specs, _ = collect.token_step_specs(None, int(tok.shape[0]), mesh,
                                                          seeded=seeds is not None)
        extra = () if seeds is None else (seeds, nt)
        local = collect.shard_args((params, None, tok, None, pos, active, None, None) + extra,
                                   in_specs, mesh)
        tok, pos, active = local[2], local[4], local[5]
        if seeds is not None:
            seeds, nt = local[8], local[9]
        rows = {int(v.shape[0]) for c in cache for v in c.values()}
        if rows != {int(tok.shape[0])}:
            raise ValueError(f"token_step(mesh=): the cache holds {sorted(rows)} rows, this "
                             f"rank's block of the batch is {int(tok.shape[0])}")
        tok_new, cache, rec = token_step(params, cache, tok, pos, active, cfg, par,
                                         temperature=temperature, adaptive=adaptive,
                                         gate=gate, eos_id=eos_id, seeds=seeds, nt=nt,
                                         cuda_graphs=cuda_graphs)
        if rec is not None:
            rec = _fleet(rec, collect.batch_group(mesh)[0])
        return collect.gather_outputs((tok_new, cache, rec), out_specs, mesh)
    if temperature > 0 and seeds is None:
        raise ValueError("token_step samples at temperature > 0 from per-request "
                         "streams: pass seeds and nt")
    B = int(tok.shape[0])
    dyn = _dyn_on(adaptive, device) if adaptive is not None else None
    tile_rows = adaptive.tile_rows if adaptive is not None else 0
    zeros = torch.zeros(B, dtype=torch.int64, device=device)
    inputs = dict(tok=tok, pos=pos, active=active,
                  seeds=zeros if seeds is None else seeds, nt=zeros if nt is None else nt)
    dtypes = dict(tok=torch.int64, pos=torch.int64, active=torch.bool, seeds=torch.int64,
                  nt=torch.int64)
    kw = dict(temperature=temperature, eos_id=eos_id, tile_rows=tile_rows)
    if par is not None or shard_rows is not None:
        kw.update(par=par, rows=shard_rows)
    with torch.inference_mode():
        if _use_graphs(device, cuda_graphs):
            key = ("token_step", cfg, B, _cache_sig(cache), temperature, eos_id,
                   tile_rows, _dyn_sig(dyn), _mesh_sig(B))

            def build():
                buf = {n: torch.empty(B, dtype=dtypes[n], device=device) for n in inputs}
                buf.update(cache=cache, tok_out=torch.empty(B, dtype=torch.int64,
                                                            device=device),
                           dyn=({k: torch.empty_like(v) for k, v in dyn.items()}
                                if dyn is not None else None))

                def step(g):
                    return _token_decode(params, buf, cfg, gate=g, **kw)

                return G.StepProgram(key, [params, buf], step, buf)

            prog = G.program(key, (params, cache), build)
            buf = prog.buf
            for n, v in inputs.items():
                buf[n].copy_(torch.as_tensor(v, device=device))
            if dyn is not None:
                for name, v in dyn.items():
                    buf["dyn"][name].copy_(v)
            rec = prog.run(bool(gate) and adaptive is not None)
            tok_new = buf["tok_out"]
        else:
            buf = {n: torch.as_tensor(v, device=device).to(dtypes[n]) for n, v in inputs.items()}
            buf.update(cache=cache, tok_out=torch.empty(B, dtype=torch.int64, device=device),
                       dyn=dyn)
            rec = _token_decode(params, buf, cfg, gate=bool(gate) and adaptive is not None,
                                **kw)
            tok_new = buf["tok_out"]
    tok_new = tok_new.clone()          # a normal tensor the caller may update
    if adaptive is None:
        return tok_new, cache
    return tok_new, cache, rec


def prefill_one(params, tokens, length: int, cfg: ModelConfig,
                par: Optional[ParallelConfig] = None, *, max_cache_len: int,
                temperature: float = 0.0, seed: Optional[int] = None, rows: int = 1):
    """Prefill ONE right-padded request ``tokens`` (1, bucket) of real
    length ``length`` (``repro.serve.engine.prefill_one``): the pad-mask
    forward, the first token sampled at the last real position (index 0 of
    the request's stream ``seed``; needed for ``temperature > 0``), and a
    cache padded to ``max_cache_len`` that :func:`splice_slot` writes into
    any slot.  Returns ``(first_token (1,), cache)``.

    ``rows`` runs the forward over that many copies of the request and
    keeps the first.  On the card a GEMM's rounding depends on its row
    count, so a continuous batcher passes its slot count: the request then
    gets the bits of a wave's batched prefill at the same bucket.

    ``par``: as JAX's, passed to ``prefill``.  Under a model-sharded mesh
    the ``rows`` copies are split over the ranks as a batch of ``rows``
    slots is, the first token is gathered from the rank that holds row 0
    (the same on every rank), and the cache is the rank's block of its
    first row: the layout of a slot cache of ``rows`` slots, which
    :func:`splice_slot` writes into (module note)."""
    device = params["embed"]["w"].device
    if temperature > 0 and seed is None:
        raise ValueError("prefill_one samples at temperature > 0 from the request's "
                         "stream: pass seed")
    toks = _upload(tokens, device).reshape(1, -1).expand(rows, -1)
    lens = torch.full((rows,), int(length), dtype=torch.int64, device=device)
    shard_rows = _shard_rows(rows)
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": toks}, cfg, par,
                                max_cache_len=max_cache_len, prompt_lens=lens)
        n = logits.shape[0]                      # this rank's rows of the copies
        zeros = torch.zeros(n, dtype=torch.int64, device=device)
        s = zeros if seed is None else torch.full((n,), int(seed), dtype=torch.int64,
                                                  device=device)
        if shard_rows is None:
            first = slot_sample(logits[:1, int(length) - 1], s[:1], zeros[:1], temperature)
        else:
            gather = shard_rows[2]
            first = gather(slot_sample(logits[:, int(length) - 1], s, zeros,
                                       temperature))[:1]
    return first, [{k: v[:1] for k, v in c.items()} for c in cache]


def splice_slot(cache, fresh, slot):
    """Write the single-request cache ``fresh`` (batch 1) into row ``slot``
    of the slot-batched ``cache``, in place (the mid-flight admission
    splice); ``slot`` is an int or a device tensor, so nothing is read
    back.  Returns ``cache``: its tensors keep their addresses, so a
    captured token step stays valid.

    Under a model-sharded mesh ``cache`` and ``fresh`` are this rank's
    blocks (``fresh`` from :func:`prefill_one` with ``rows`` the slot
    count, whose sequence block is the slot cache's, ``ValueError``
    otherwise) and ``slot`` the row in the rank's block: where the batch
    axes split the slots, the rank that holds the slot's row calls it, as
    on the fleet mesh (module note)."""
    if current_tp() is not None:
        _check_fresh(cache, fresh)
    with torch.inference_mode():
        for big, small in zip(cache, fresh):
            for name, t in big.items():
                src = small[name].to(t.dtype)
                if torch.is_tensor(slot):
                    t.index_copy_(0, slot.reshape(1).to(device=t.device, dtype=torch.int64), src)
                else:
                    t[int(slot)].copy_(src[0])
    return cache


def _check_fresh(cache, fresh) -> None:
    """Under a model-sharded mesh: ``fresh``'s blocks are rows of the slot
    cache's (:func:`splice_slot`)."""
    for big, small in zip(cache, fresh):
        for name, t in big.items():
            if tuple(small[name].shape[1:]) != tuple(t.shape[1:]):
                raise ValueError(
                    f"splice_slot: the fresh cache's {name} block {tuple(small[name].shape)} "
                    f"is not a row of the slot cache's {tuple(t.shape)}: prefill_one(rows=) "
                    f"must be the slot count under a model-sharded mesh")
