"""Continuous batching (``repro.fleet.scheduler``): requests of any prompt
length and token budget go into a fixed number of decode slots, served in
fused waves or spliced into a running batch one token step at a time.

* Requests queue per **prompt bucket**; prompts right-pad to the bucket
  length and prefill runs pad-masked (``prompt_lens``), so a padded prompt
  generates exactly what it generates unpadded.  Pad-masking needs a
  full-attention stack; other families keep the repeat-pad wave.
* **Wave mode** (the default, and the oracle): a wave admits up to
  ``n_slots`` requests FIFO from the bucket of the oldest request,
  backfills the free slots with the oldest requests of other buckets whose
  prompts fit, fills the rest with 1-token copies, and runs one fused
  ``generate`` of ``new_token_bucket`` steps with per-slot positions,
  budgets, seeds and EOS (on the card the decode step is a CUDA graph).
* **Token mode** (``BatcherConfig.token_granular``): one
  ``serve.engine.token_step`` per step over the slot batch with per-slot
  positions; a slot that finishes takes the next FIFO request at the step
  boundary (``prefill_one`` + ``splice_slot``).  The same prompts and seeds
  give each request the tokens of the wave oracle, greedy or sampled.
* **EOS retirement** (``BatcherConfig.eos_id``): a slot frees the moment it
  samples EOS (kept as the last token, ``Completion.finish == "eos"``).
* **Per-request sampling streams**: a request draws from the stream of its
  own seed (``Request.seed`` or one derived from the rid), so sampling does
  not depend on the slot or the mode.
* **Arrivals** (:meth:`ContinuousBatcher.run_arrivals`, ``ArrivalSource``,
  :func:`poisson_arrivals`): requests are submitted when their timestamps
  come due, queueing delay is measured, and the loop sleeps rather than
  run a step with no active slot.
* **Async admission** (``BatcherConfig.async_admission``, token mode): a
  freed slot's prefill is launched on the current stream and spliced at
  the next step boundary, where its first token is read.
* Deadlines (``Request.deadline_s``) retire a request as ``timeout``, queued
  or decoding; ``max_queue`` sheds submits past a bounded queue; the
  straggler watchdog (``train/fault.py``) flags slow steps and waves; the
  chaos site ``sched.step`` stalls or kills a step.
* QoR attribution: token mode with an adaptive controller charges each
  observed step's records to the requests live in it
  (``obs.ErrorAttributor``) and attaches the summary to each completion.

**Differences from the JAX package.**  There is no PRNG key: greedy is
``argmax``, and sampling needs the per-request seeds, which ``token_step``
and ``prefill_one`` receive exactly when ``temperature > 0``.  On the card
``token_step`` replays one CUDA graph per program and per observe gate, so
warm-up is "each gate value has run once in this drain": a capture after
that counts into ``decode_retraces_post_warmup``, which must stay 0.  The
slot cache is allocated once per batcher on the params' device and kept
across drains: a cache is part of a graph program's identity, and
``splice_slot`` rewrites a slot's rows up to ``max_cache_len`` while the
write mask keeps inactive slots inert, so a second drain captures nothing.
A step's telemetry records are the graph's output buffers, valid until the
next replay: their copy to the host is enqueued right after the step and
finished at the step's token read.  On the card a GEMM's rounding depends
on its row count, so an admission prefills its request over ``n_slots``
rows (``prefill_one(rows=)``), the shape of a wave's prefill: a request
gets the wave's bits wherever the wave prefilled it at its own bucket (a
request backfilled into a wave of a longer bucket is prefilled at that
bucket there, where the card may round otherwise).  The engine calls
(``generate``, ``prefill_one``, ``splice_slot``, ``token_step``,
``init_cache``) are module-level names a test may replace.

**The fleet mesh** (``mesh=``, with ``adaptive``; multi-process SPMD).
Every rank runs a batcher over the same submits: each holds the whole host
state (queues, buckets, deadlines, slot states) and only its block of the
slots' cache rows (``n_slots`` must divide over the ranks).  A wave is one
``generate(mesh=)``; a token step one ``token_step(mesh=)``, whose tokens
come back all-gathered, so EOS, retirements and backfill are decided from
the same values on every rank, and the controller on every rank observes
the same fleet records.  An admission is prefilled by the rank that owns
its slot and its first token broadcast.  Decisions read an agreed clock
(:meth:`ContinuousBatcher.clock`: the ranks' largest reading, one
all-reduce) for deadlines and arrivals; latency metrics keep each rank's
own clock.  A ``PolicyReader`` polls the store on every rank, and the
ranks then serve the newest version any of them saw
(``PolicyReader.pin``).  ``par`` gives the mesh context's rules (MoE
capacity per token shard, ``models/blocks.py``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import torch.distributed as dist

from repro_torch import obs
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.sharding import set_mesh_ctx
from repro_torch.models import init_cache
from repro_torch.runtime.telemetry import finish_host_copy, start_host_copy
from repro_torch.serve.engine import (ServeConfig, generate, prefill_one, splice_slot,
                                      token_step)
from repro_torch.train.fault import StragglerWatchdog

from . import chaos, collect

__all__ = ["Request", "Completion", "BatcherConfig", "ContinuousBatcher",
           "ArrivalSource", "poisson_arrivals"]

# host-side observability, the JAX package's series.  Wave-mode TTFT equals
# e2e at wave-landing granularity: the whole wave is one fused dispatch and
# its tokens reach the host together.  Token mode measures the first token
# when it reaches the host.
_REG = obs.default_registry()
_OCCUPANCY = _REG.gauge(
    "repro_batcher_occupancy",
    "useful-token fraction of all decode-slot token positions (by mode)")
_QUEUE_DEPTH = _REG.gauge(
    "repro_queue_depth", "waiting requests per prompt bucket")
_ADMISSIONS = _REG.counter(
    "repro_admissions_total", "requests admitted into decode slots (by mode)")
_BACKFILLS = _REG.counter(
    "repro_backfills_total",
    "wave-mode idle slots backfilled from other buckets' FIFO heads")
_SPLICES = _REG.counter(
    "repro_splices_total",
    "token-mode mid-flight admissions spliced into a live batch")
_TTFT = _REG.histogram(
    "repro_request_ttft_seconds",
    "submit -> first token (wave mode: == e2e at wave-LANDING granularity "
    "— EOS may free the slot's compute earlier but tokens only materialize "
    "when the fused wave returns)",
    buckets=obs.TTFT_BUCKETS)
_QUEUE_DELAY = _REG.histogram(
    "repro_request_queue_delay_seconds",
    "submit -> admission (wave: popped into a wave; token: prefill "
    "dispatched) — the arrival-pressure signal",
    buckets=obs.TTFT_BUCKETS)
_EOS_RETIRED = _REG.counter(
    "repro_eos_retired_total",
    "requests retired early by an EOS sample, before their token budget "
    "(by mode)")
_E2E = _REG.histogram(
    "repro_request_e2e_seconds", "submit -> request retirement (by mode)",
    buckets=obs.E2E_BUCKETS)
_STEP_WALL = _REG.histogram(
    "repro_token_step_seconds",
    "host wall per token-granular decode step (dispatch + host bookkeeping)",
    buckets=obs.DISPATCH_BUCKETS)
_TOKENS_PER_S = _REG.gauge(
    "repro_decode_tokens_per_second",
    "real (non-pad, non-filler) tokens per wall second over the last drain")
_POST_WARMUP_RETRACES = _REG.gauge(
    "repro_decode_retraces_post_warmup",
    "token_step program installs after the first decode step of a drain — "
    "the live zero-recompile invariant (asserted 0; splices and policy "
    "updates must never retrace)")
_SHED = _REG.counter(
    "repro_requests_shed_total",
    "admissions refused because the bounded queue was full (load-shedding)")
_TIMEOUTS = _REG.counter(
    "repro_request_timeouts_total",
    "requests retired past their deadline_s (by where: queued / decoding)")
_STRAGGLERS = _REG.counter(
    "repro_step_stragglers_total",
    "decode steps/waves flagged slow by the straggler watchdog")


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray          # (L,) int32 prompt
    max_new: int
    # seconds from submit after which the request retires as ``timeout``,
    # queued or mid-decode (None: no deadline)
    deadline_s: Optional[float] = None
    # sampling seed; None derives one from (BatcherConfig.seed, rid)
    seed: Optional[int] = None


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray          # (<= max_new,) int32 generated
    wave: int                   # wave index (wave mode) / retire step (token)
    prompt_len: int
    bucket: int
    status: str = "ok"          # "ok" | "timeout" (partial/empty tokens)
    # why decoding stopped: "length", "eos" (EOS kept as the last token) or
    # "timeout"
    finish: str = "length"
    # correlation id assigned at submit, unique across splices and drains
    corr: Optional[str] = None
    # per-request QoR summary (obs.ErrorAttributor.finish): token mode with
    # an adaptive controller only; None in wave mode
    qor: Optional[dict] = None


@dataclasses.dataclass
class BatcherConfig:
    n_slots: int = 8                       # fixed decode batch
    prompt_buckets: Sequence[int] = (16, 32, 64)
    new_token_bucket: int = 16             # fused decode length per wave
    observe_every: int = 1                 # telemetry decimation
    temperature: float = 0.0
    seed: int = 0
    token_granular: bool = False           # mid-flight slot splicing
    max_queue: Optional[int] = None        # shed submits past this many waiting
    straggler_factor: float = 3.0          # per-step watchdog (train/fault)
    eos_id: Optional[int] = None           # retire a slot when it samples this
    # token mode: launch a freed slot's prefill at once and splice it at the
    # next step boundary (False: splice and read its first token at once)
    async_admission: bool = False


class ContinuousBatcher:
    """Admission and execution over the fused decode (wave mode) or the
    per-step token decode (``BatcherConfig.token_granular``).

    ``adaptive`` is the re-tuning :class:`~repro_torch.runtime.AdaptiveController`
    or a replica's :class:`~repro_torch.fleet.store.PolicyReader` (polled
    before each wave and each admission); ``None`` serves the static policy.
    ``mesh`` shards the decode slots over a fleet mesh's ranks (module
    note; the sharded decode is the adaptive one, so it needs
    ``adaptive``); ``par`` gives its mesh context's rules.  The slot cache
    of token mode lives on the params' device and is kept across drains.
    """

    def __init__(self, params, cfg: ModelConfig, bcfg: Optional[BatcherConfig] = None,
                 adaptive=None, mesh=None, par: Optional[ParallelConfig] = None):
        if mesh is not None and adaptive is None:
            raise ValueError("ContinuousBatcher: mesh= requires an adaptive controller or "
                             "reader (the sharded decode is the adaptive one)")
        self.params = params
        self.cfg = cfg
        self.bcfg = bcfg or BatcherConfig()
        # the slot cache's device (params is None only under test fakes)
        self.device = params["embed"]["w"].device if params is not None else None
        # pad-mask prefill (and with it per-slot positions, budgets and
        # backfill) needs a full-attention stack
        self.padmask = (cfg.family != "encdec" and all(
            k in ("global", "dense_ffn") for k in cfg.layer_kinds()))
        if self.bcfg.token_granular:
            assert self.padmask, (
                f"token-granular mode needs pad-mask prefill (full-attention "
                f"stack); {cfg.name} has kinds "
                f"{sorted(set(cfg.layer_kinds()))}")
        if self.bcfg.eos_id is not None:
            assert self.padmask, (
                f"eos_id retirement needs the per-slot (pad-mask) decode "
                f"path; {cfg.name} has kinds {sorted(set(cfg.layer_kinds()))}")
        self.adaptive = adaptive
        self.mesh = mesh
        self.par = par
        self.group, self.shard, self.n_shards = None, 0, 1
        if mesh is not None:
            collect.shard_decode_specs(None, self.bcfg.n_slots, mesh)  # divisibility, bound
            self.group, self.shard, self.n_shards = collect.batch_group(mesh)
        self.rows = self.bcfg.n_slots // self.n_shards   # this rank's slots
        self._epoch = time.perf_counter()
        self.queues: Dict[int, collections.deque] = {
            b: collections.deque() for b in sorted(self.bcfg.prompt_buckets)
        }
        self.wave = 0
        self._arrival = 0
        self._order: Dict[int, int] = {}     # rid -> arrival index (FIFO across buckets)
        self.stats = dict(waves=0, requests=0, real_tokens=0, padded_tokens=0,
                          filler_tokens=0, backfilled=0, splices=0,
                          decode_steps=0, decode_retraces_post_warmup=0,
                          shed=0, timeouts=0, stragglers=0, eos_retired=0)
        self.mode = "token" if self.bcfg.token_granular else "wave"
        self.watchdog = StragglerWatchdog(factor=self.bcfg.straggler_factor)
        self._submit_t: Dict[int, float] = {}    # rid -> submit perf_counter
        self._submit_clock: Dict[int, float] = {}  # rid -> submit on clock()
        # per-request latency log (rid, bucket, prompt_len, max_new, ttft,
        # e2e, queue_delay, seed, finish)
        self.request_log: List[dict] = []
        # correlation ids "<rid>#<arrival>" and exposure accounting over the
        # token loop's step telemetry (wave completions carry the id only)
        self._corr: Dict[int, str] = {}          # pending rid -> corr id
        self.qor = obs.ErrorAttributor()
        self.slo = None
        self._cache = None                       # token mode's slot cache

    def attach_slo(self, engine) -> None:
        """Attach an :class:`repro_torch.obs.slo.SLOEngine` to the latency
        stream (sources ``"ttft"`` and ``"e2e"``)."""
        self.slo = engine

    # -- the mesh's agreement ------------------------------------------
    def _agree(self, x: float, op) -> float:
        """``x`` reduced over the mesh's ranks (one all-reduce on the
        slot cache's device)."""
        t = torch.tensor([x], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=op, group=self.group)
        return float(t.item())

    def clock(self) -> float:
        """Seconds since this batcher was made, on a clock every rank of a
        mesh agrees on (the ranks' largest reading); the local clock
        without a mesh.  Deadlines and arrivals read it (module note)."""
        t = time.perf_counter() - self._epoch
        return t if self.mesh is None else self._agree(t, dist.ReduceOp.MAX)

    def _mesh_ctx(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return set_mesh_ctx(self.mesh, self.par or ParallelConfig())

    def _owns(self, slot: int) -> bool:
        return slot // self.rows == self.shard

    def _update_queue_gauges(self) -> None:
        for b, q in self.queues.items():
            _QUEUE_DEPTH.set(len(q), bucket=str(b))

    def _record_latency(self, req: "Request", ttft: Optional[float],
                        e2e: float, observe_ttft: bool = True,
                        queue_delay: Optional[float] = None,
                        finish: str = "length") -> None:
        if ttft is not None and observe_ttft:
            _TTFT.observe(ttft, mode=self.mode)
        _E2E.observe(e2e, mode=self.mode)
        if queue_delay is not None:
            _QUEUE_DELAY.observe(queue_delay, mode=self.mode)
        if self.slo is not None:
            if ttft is not None:
                self.slo.observe_latency("ttft", ttft)
            self.slo.observe_latency("e2e", e2e)
        self.request_log.append(dict(
            rid=req.rid, bucket=self.bucket_of(len(req.tokens)),
            prompt_len=len(req.tokens), max_new=req.max_new,
            ttft=ttft, e2e=e2e, queue_delay=queue_delay,
            seed=self._request_seed(req), finish=finish))

    def _request_seed(self, req: "Request") -> int:
        """The request's sampling seed: ``Request.seed``, or one derived
        from (BatcherConfig.seed, rid) alone, so the stream does not depend
        on arrival order, slot or mode."""
        if req.seed is not None:
            return int(req.seed) & 0x7FFFFFFF
        return (self.bcfg.seed * 1_000_003 + req.rid * 2_654_435_761) \
            & 0x7FFFFFFF

    # -- admission -----------------------------------------------------
    def bucket_of(self, prompt_len: int) -> int:
        for b in sorted(self.queues):
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds largest bucket "
            f"{max(self.queues)}")

    def submit(self, req: Request) -> bool:
        """Queue a request.  Returns False (and counts a shed) when the
        bounded queue (``BatcherConfig.max_queue``) is full."""
        if (self.bcfg.max_queue is not None
                and self.pending() >= self.bcfg.max_queue):
            self.stats["shed"] += 1
            _SHED.inc(1)
            obs.instant("shed", cat="scheduler", rid=req.rid,
                        pending=self.pending())
            return False
        assert req.max_new >= 1, req
        assert req.max_new <= self.bcfg.new_token_bucket, (
            f"request {req.rid}: max_new {req.max_new} > token bucket "
            f"{self.bcfg.new_token_bucket}")
        assert req.rid not in self._order, f"duplicate pending rid {req.rid}"
        req.tokens = np.asarray(req.tokens, np.int32).reshape(-1)
        self.queues[self.bucket_of(len(req.tokens))].append(req)
        self._order[req.rid] = self._arrival
        corr = f"{req.rid}#{self._arrival}"
        self._corr[req.rid] = corr
        self._arrival += 1
        self._submit_t[req.rid] = time.perf_counter()
        self._submit_clock[req.rid] = self.clock()
        obs.async_begin("request", req.rid, prompt_len=len(req.tokens),
                        max_new=req.max_new, corr=corr)
        if self.bcfg.token_granular:
            # exposure opens at submit, so a request that times out queued
            # still closes with a (fleet-basis) summary
            self.qor.begin(corr, req.rid)
        self._update_queue_gauges()
        return True

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    # -- deadlines -----------------------------------------------------
    def _deadline_passed(self, req: Request) -> bool:
        if req.deadline_s is None:
            return False
        t0 = self._submit_clock.get(req.rid)
        return t0 is not None and self.clock() - t0 > req.deadline_s

    def _timeout(self, req: Request, tokens, where: str) -> Completion:
        """Retire ``req`` past its deadline: a ``timeout`` completion with
        the tokens generated so far (none when still queued)."""
        self.stats["timeouts"] += 1
        _TIMEOUTS.inc(1, where=where)
        e2e = time.perf_counter() - self._submit_t.pop(
            req.rid, time.perf_counter())
        self._submit_clock.pop(req.rid, None)
        self._record_latency(req, None, e2e, observe_ttft=False,
                             finish="timeout")
        corr = self._corr.pop(req.rid, None)
        qor = self.qor.finish(corr) if corr is not None else None
        obs.instant("timeout", cat="scheduler", rid=req.rid, where=where)
        obs.async_end("request", req.rid, status="timeout")
        return Completion(req.rid, np.asarray(tokens, np.int32),
                          self.wave if self.mode == "wave"
                          else self.stats["decode_steps"],
                          len(req.tokens), self.bucket_of(len(req.tokens)),
                          status="timeout", corr=corr, qor=qor,
                          finish="timeout")

    def _expire_queued(self) -> List[Completion]:
        """Retire the queued requests whose deadline passed while waiting."""
        out = []
        for q in self.queues.values():
            expired = [r for r in q if self._deadline_passed(r)]
            if expired:
                dead = {r.rid for r in expired}
                keep = [r for r in q if r.rid not in dead]
                for r in expired:
                    del self._order[r.rid]
                    out.append(self._timeout(r, np.zeros(0, np.int32),
                                             where="queued"))
                q.clear()
                q.extend(keep)
        if out:
            self._update_queue_gauges()
        return out

    def max_cache_len(self) -> int:
        """One decode-cache length for every bucket: one decode program."""
        return max(self.queues) + self.bcfg.new_token_bucket + 1

    # -- FIFO helpers --------------------------------------------------
    def _pick_bucket(self, max_prompt_len: Optional[int] = None) -> Optional[int]:
        """The bucket whose head is the oldest waiting request, skipping
        heads longer than ``max_prompt_len``."""
        best, best_order = None, None
        for b, q in self.queues.items():
            if not q:
                continue
            if max_prompt_len is not None and len(q[0].tokens) > max_prompt_len:
                continue
            if best_order is None or self._order[q[0].rid] < best_order:
                best, best_order = b, self._order[q[0].rid]
        return best

    def _pop_oldest(self, max_prompt_len: Optional[int] = None) -> Optional[Request]:
        b = self._pick_bucket(max_prompt_len)
        if b is None:
            return None
        req = self.queues[b].popleft()
        del self._order[req.rid]
        return req

    def _pad(self, tokens: np.ndarray, bucket: int) -> np.ndarray:
        pad = bucket - len(tokens)
        if pad <= 0:
            return tokens[:bucket]
        return np.concatenate([tokens, np.full(pad, tokens[-1], np.int32)])

    def _poll_policy(self) -> None:
        if self.adaptive is not None and hasattr(self.adaptive, "poll"):
            self.adaptive.poll()             # replica: adopt a newer policy
            if self.mesh is not None:        # every rank serves one version
                v = int(self._agree(self.adaptive.version, dist.ReduceOp.MAX))
                if v != self.adaptive.version:
                    self.adaptive.pin(v)

    # -- wave execution (the oracle) -----------------------------------
    def step(self) -> List[Completion]:
        """Run one wave; returns the completions it retired (empty when the
        queues are drained).  Requests whose deadline lapsed while queued
        retire first as ``timeout`` completions."""
        faults = chaos.fire("sched.step", wave=self.wave, mode=self.mode)
        if any(f.kind == "crash_replica" for f in faults):
            raise chaos.InjectedFault("sched.step: replica killed")
        chaos.maybe_stall(faults, default=0.05)
        timed_out = self._expire_queued()
        bucket = self._pick_bucket()
        if bucket is None:
            return timed_out
        t_wave = time.perf_counter()
        bc = self.bcfg
        q = self.queues[bucket]
        admitted = []
        while q and len(admitted) < bc.n_slots:
            req = q.popleft()
            del self._order[req.rid]
            admitted.append(req)
        # backfill free slots with the oldest requests of other buckets
        # whose prompts fit (pad-mask prefill only)
        n_backfilled = 0
        while self.padmask and len(admitted) < bc.n_slots:
            req = self._pop_oldest(max_prompt_len=bucket)
            if req is None:
                break
            admitted.append(req)
            n_backfilled += 1
        # the remaining slots copy admitted prompts with a 1-token budget
        slots = [admitted[i % len(admitted)] for i in range(bc.n_slots)]
        filler = bc.n_slots - len(admitted)

        self._poll_policy()
        qdelay = {r.rid: t_wave - self._submit_t.get(r.rid, t_wave)
                  for r in admitted}
        batch = np.stack([self._pad(r.tokens, bucket) for r in slots])
        lens = np.asarray([len(r.tokens) for r in slots], np.int32)
        budgets = np.asarray(
            [r.max_new if i < len(admitted) else 1
             for i, r in enumerate(slots)], np.int32)
        scfg = ServeConfig(max_new_tokens=bc.new_token_bucket,
                           temperature=bc.temperature, seed=bc.seed,
                           fused=True, observe_every=bc.observe_every,
                           eos_id=bc.eos_id if self.padmask else None)
        padmask_kw = (dict(prompt_lens=lens, slot_new_tokens=budgets,
                           max_cache_len=self.max_cache_len())
                      if self.padmask else {})
        if self.padmask and bc.temperature > 0:
            padmask_kw["slot_seeds"] = np.asarray(
                [self._request_seed(r) for r in slots], np.int32)
        self._update_queue_gauges()
        if self.mesh is not None:
            padmask_kw["mesh"] = self.mesh
        with obs.span("wave", cat="scheduler", wave=self.wave, bucket=bucket,
                      admitted=len(admitted), backfilled=n_backfilled), self._mesh_ctx():
            out = generate(self.params, {"tokens": torch.from_numpy(batch)}, self.cfg,
                           scfg, adaptive=self.adaptive, **padmask_kw).cpu().numpy()
        t_done = time.perf_counter()

        done = []
        for i, req in enumerate(admitted):
            toks = out[i, :req.max_new].astype(np.int32)
            finish = "length"
            if bc.eos_id is not None and self.padmask:
                hits = np.nonzero(toks == bc.eos_id)[0]
                if hits.size:                     # truncate at the first EOS
                    toks = toks[:int(hits[0]) + 1]
                    finish = "eos"
                    self.stats["eos_retired"] += 1
                    _EOS_RETIRED.inc(1, mode=self.mode)
            done.append(Completion(req.rid, toks, self.wave,
                                   len(req.tokens), bucket,
                                   corr=self._corr.pop(req.rid, None),
                                   finish=finish))
            self.stats["real_tokens"] += int(len(toks))
            self.stats["padded_tokens"] += int(
                bucket - len(req.tokens) + bc.new_token_bucket - len(toks))
            e2e = t_done - self._submit_t.pop(req.rid, t_done)
            self._submit_clock.pop(req.rid, None)
            self._record_latency(req, e2e, e2e,
                                 queue_delay=qdelay.get(req.rid),
                                 finish=finish)
            obs.async_end("request", req.rid, wave=self.wave)
        self.stats["backfilled"] += n_backfilled
        self.stats["filler_tokens"] += filler * (bucket + bc.new_token_bucket)
        self.stats["requests"] += len(admitted)
        self.stats["waves"] += 1
        self.stats["decode_steps"] += bc.new_token_bucket - 1
        _ADMISSIONS.inc(len(admitted), mode=self.mode)
        _BACKFILLS.inc(n_backfilled)
        _OCCUPANCY.set(self.occupancy(), mode=self.mode)
        if self.watchdog.observe(t_done - t_wave):
            self.stats["stragglers"] += 1
            _STRAGGLERS.inc(1, mode=self.mode)
            obs.instant("straggler", cat="scheduler", wave=self.wave,
                        wall=t_done - t_wave)
        self.wave += 1
        return timed_out + done

    # -- token-granular execution --------------------------------------
    def _admit_pop(self):
        """Pop the next FIFO request; those whose deadline lapsed while
        queued retire as empty ``timeout`` completions instead."""
        expired: List[Completion] = []
        req = self._pop_oldest()
        while req is not None and self._deadline_passed(req):
            expired.append(self._timeout(req, np.zeros(0, np.int32),
                                         where="queued"))
            req = self._pop_oldest()
        return req, expired

    def _admit_dispatch(self, slot: int):
        """Pop the next FIFO request and launch its prefill (asynchronous on
        the card: nothing here reads from the device; under a mesh only the
        rank owning ``slot`` prefills).  Returns ``(pending admission |
        None, expired timeouts)``; the splice and the first-token read
        happen in :meth:`_admit_complete`."""
        req, expired = self._admit_pop()
        if req is None:
            return None, expired
        self._poll_policy()
        L = len(req.tokens)
        bucket = self.bucket_of(L)
        padded = self._pad(req.tokens, bucket)
        t_dispatch = time.perf_counter()
        # sampling draws index 0 of the request's stream, as the wave does
        seed_kw = (dict(seed=self._request_seed(req)) if self.bcfg.temperature > 0
                   else {})
        first = fresh = None
        if self._owns(slot):
            with obs.span("admit_dispatch", cat="scheduler", rid=req.rid,
                          slot=slot, bucket=bucket), self._mesh_ctx():
                first, fresh = prefill_one(
                    self.params, padded[None], L, self.cfg,
                    max_cache_len=self.max_cache_len(),
                    temperature=self.bcfg.temperature, rows=self.bcfg.n_slots, **seed_kw)
        queue_delay = t_dispatch - self._submit_t.get(req.rid, t_dispatch)
        return dict(req=req, slot=slot, first=first, fresh=fresh,
                    queue_delay=queue_delay), expired

    def _admit_complete(self, pend: dict, state: list, pos: np.ndarray,
                        tok: np.ndarray, nt: np.ndarray, seeds: np.ndarray,
                        splice: bool) -> List[Completion]:
        """Splice a launched prefill into its slot and read its first token
        (the host synchronise); fills the slot state.  A request that
        retires within its admission (``max_new == 1``, or an EOS first
        token) frees the slot again."""
        req, slot = pend["req"], pend["slot"]
        done: List[Completion] = []
        with obs.span("admit", cat="scheduler", rid=req.rid, slot=slot):
            if self._owns(slot):
                self._cache = splice_slot(self._cache, pend["fresh"],
                                          slot - self.shard * self.rows)
            first = self._first_token(pend["first"], slot)   # sync: token on host
        obs.instant("splice", cat="scheduler", rid=req.rid, slot=slot)
        ttft = time.perf_counter() - self._submit_t.get(
            req.rid, time.perf_counter())
        _TTFT.observe(ttft, mode=self.mode)
        state[slot] = dict(req=req, remaining=req.max_new - 1, toks=[first],
                           ttft=ttft, queue_delay=pend["queue_delay"])
        pos[slot] = len(req.tokens)
        tok[slot] = first
        nt[slot] = 1                          # token 0 sampled at prefill
        seeds[slot] = self._request_seed(req)
        self.stats["requests"] += 1
        self.stats["real_tokens"] += 1
        self.stats["padded_tokens"] += self.bucket_of(len(req.tokens)) - len(
            req.tokens)
        _ADMISSIONS.inc(1, mode=self.mode)
        self._update_queue_gauges()
        eos_hit = (self.bcfg.eos_id is not None
                   and first == self.bcfg.eos_id)
        if state[slot]["remaining"] == 0 or eos_hit:
            if eos_hit:
                self.stats["eos_retired"] += 1
                _EOS_RETIRED.inc(1, mode=self.mode)
            done.extend(self._retire(
                slot, state, finish="eos" if eos_hit else "length"))
        elif splice:
            self.stats["splices"] += 1
            _SPLICES.inc(1)
        return done

    def _first_token(self, first, slot: int) -> int:
        """An admission's first token on the host; under a mesh broadcast
        from the rank that owns ``slot``."""
        if self.mesh is None:
            return int(first[0])
        # a clone: the prefill's token is an inference tensor, which a
        # collective may not write in place outside inference mode
        t = (first.reshape(1).to(torch.int64).clone() if first is not None else
             torch.zeros(1, dtype=torch.int64, device=self.device))
        dist.broadcast(t, src=dist.get_global_rank(self.group, slot // self.rows),
                       group=self.group)
        return int(t[0])

    def _retire(self, slot: int, state: list, status: str = "ok",
                finish: Optional[str] = None) -> List[Completion]:
        st = state[slot]
        state[slot] = None
        req = st["req"]
        if finish is None:
            finish = "timeout" if status == "timeout" else "length"
        if status == "timeout":              # mid-decode deadline: keep the
            self.stats["timeouts"] += 1      # partial tokens, mark the cut
            _TIMEOUTS.inc(1, where="decoding")
            obs.instant("timeout", cat="scheduler", rid=req.rid,
                        where="decoding")
        e2e = time.perf_counter() - self._submit_t.pop(
            req.rid, time.perf_counter())
        self._submit_clock.pop(req.rid, None)
        # TTFT was already observed at the admission splice
        self._record_latency(req, st.get("ttft"), e2e, observe_ttft=False,
                             queue_delay=st.get("queue_delay"), finish=finish)
        corr = self._corr.pop(req.rid, None)
        qor = self.qor.finish(corr) if corr is not None else None
        obs.instant("retire", cat="scheduler", rid=req.rid, slot=slot)
        end_kw = dict(step=self.stats["decode_steps"], status=status)
        if qor is not None and qor["top"]:
            # the top contributor rides on the request's async trace span
            end_kw.update(qor_top=qor["top"][0]["where"],
                          qor_share=round(qor["top"][0]["share"], 4),
                          qor_basis=qor["basis"])
        obs.async_end("request", req.rid, **end_kw)
        return [Completion(req.rid, np.asarray(st["toks"], np.int32),
                           self.stats["decode_steps"], len(req.tokens),
                           self.bucket_of(len(req.tokens)), status=status,
                           corr=corr, qor=qor, finish=finish)]

    def _run_token_granular(self, source: Optional["ArrivalSource"] = None
                            ) -> List[Completion]:
        """Drain the queues with mid-flight admission: one step program,
        slots retire and refill at step boundaries.  With ``source``,
        requests are submitted as their timestamps come due and the loop
        sleeps instead of running a step with no active slot."""
        bc = self.bcfg
        B = bc.n_slots
        if self._cache is None:        # this rank's rows of the slot cache
            self._cache = init_cache(self.cfg, self.rows, self.max_cache_len(),
                                     device=self.device)
        state: list = [None] * B
        pending_admits: list = [None] * B    # async: launched, not spliced
        pos = np.zeros(B, np.int64)
        tok = np.zeros(B, np.int64)
        nt = np.zeros(B, np.int64)           # per-slot emitted-token counts
        seeds = np.zeros(B, np.int64)        # per-slot request seeds
        done: List[Completion] = []
        k_obs = max(1, int(bc.observe_every))
        pending = None
        eos = bc.eos_id
        seeded = bc.temperature > 0          # per-request sampling streams

        t_drain = time.perf_counter()
        c_drain = self.clock() if source is not None else 0.0
        tokens_at_start = self.stats["real_tokens"]
        steps_this_drain = 0

        def poll_arrivals():
            if source is None:
                return
            for r in source.poll(self.clock() - c_drain):
                self.submit(r)               # may shed (bounded queue)

        def fill_slots():
            # launch admissions into every empty slot; sync mode splices and
            # reads the first token at once, async leaves the prefill in
            # flight until the next boundary.  A sync admission that retires
            # in place frees the slot again, hence the inner loop.
            for s in range(B):
                while state[s] is None and pending_admits[s] is None:
                    pend, expired = self._admit_dispatch(s)
                    done.extend(expired)
                    if pend is None:
                        break
                    if bc.async_admission:
                        pending_admits[s] = pend
                    else:
                        done.extend(self._admit_complete(
                            pend, state, pos, tok, nt, seeds,
                            splice=steps_this_drain > 0))

        def complete_admits():
            for s in range(B):
                if pending_admits[s] is not None:
                    pend, pending_admits[s] = pending_admits[s], None
                    done.extend(self._admit_complete(
                        pend, state, pos, tok, nt, seeds,
                        splice=steps_this_drain > 0))

        poll_arrivals()
        fill_slots()
        # zero-recompile invariant: each observe-gate value captures its
        # graph on its first step of a cold process; a capture at a step
        # whose gate value already ran in this drain is a fault
        gates_run: set = set()
        post = 0
        while True:
            if any(p is not None for p in pending_admits):
                complete_admits()
                fill_slots()                 # in-place retires free slots
            active_np = np.asarray([st is not None for st in state])
            if not active_np.any():
                if any(p is not None for p in pending_admits):
                    continue
                if source is not None and not source.exhausted():
                    nd = source.next_due()
                    now = self.clock() - c_drain
                    if nd is not None and nd > now:
                        time.sleep(min(nd - now, 0.05))
                    poll_arrivals()
                    fill_slots()
                    continue
                if self.pending():
                    fill_slots()
                    continue
                break
            faults = chaos.fire("sched.step",
                                step=self.stats["decode_steps"],
                                mode=self.mode)
            if any(f.kind == "crash_replica" for f in faults):
                raise chaos.InjectedFault("sched.step: replica killed")
            chaos.maybe_stall(faults, default=0.05)
            # the corr ids live in THIS step, taken before the retire and
            # splice sweep below
            live_corrs = [self._corr[st["req"].rid]
                          for st in state if st is not None]
            gate = (self.stats["decode_steps"] % k_obs == 0)
            graph_gate = gate and self.adaptive is not None
            captures = obs.retrace_total("token_step")
            t_step = time.perf_counter()
            with obs.span("token_step", cat="scheduler",
                          step=self.stats["decode_steps"],
                          active=int(active_np.sum())), self._mesh_ctx():
                out = token_step(
                    self.params, self._cache, torch.from_numpy(tok),
                    torch.from_numpy(pos), torch.from_numpy(active_np), self.cfg,
                    temperature=bc.temperature, adaptive=self.adaptive, gate=gate,
                    eos_id=eos,
                    seeds=torch.from_numpy(seeds) if seeded else None,
                    nt=torch.from_numpy(nt) if seeded else None,
                    **({} if self.mesh is None else {"mesh": self.mesh}))
            step_wall = time.perf_counter() - t_step
            if graph_gate in gates_run:
                post += int(obs.retrace_total("token_step") - captures)
            gates_run.add(graph_gate)
            _STEP_WALL.observe(step_wall)
            if self.watchdog.observe(step_wall):
                self.stats["stragglers"] += 1
                _STRAGGLERS.inc(1, mode=self.mode)
                obs.instant("straggler", cat="scheduler",
                            step=self.stats["decode_steps"], wall=step_wall)
            copy = None
            if self.adaptive is not None:
                tok_d, self._cache, telem = out
                if gate:
                    # the records are the step graph's output buffers: enqueue
                    # their copy before anything replays it again
                    copy = start_host_copy(telem)
                if pending is not None:      # one-step-stale observe while
                    self.adaptive.observe(pending)   # this step runs
                    pending = None
            else:
                tok_d, self._cache = out
            tok = np.array(tok_d.cpu().numpy(), np.int64)   # the step's sync
            if copy is not None:
                # attribution charges this step's live corr set before any
                # of them retires below; the controller observes it next step
                host_telem = finish_host_copy(copy)
                self.qor.observe_step(host_telem, live_corrs)
                pending = host_telem
            pos = pos + active_np
            nt = nt + active_np
            n_active = int(active_np.sum())
            self.stats["real_tokens"] += n_active
            self.stats["filler_tokens"] += B - n_active
            self.stats["decode_steps"] += 1
            steps_this_drain += 1
            for s in range(B):               # retire at the step boundary
                st = state[s]
                if st is None:
                    continue
                st["toks"].append(int(tok[s]))
                st["remaining"] -= 1
                eos_hit = eos is not None and int(tok[s]) == eos
                timed_out = (st["remaining"] > 0 and not eos_hit
                             and self._deadline_passed(st["req"]))
                if st["remaining"] == 0 or eos_hit or timed_out:
                    if eos_hit:
                        self.stats["eos_retired"] += 1
                        _EOS_RETIRED.inc(1, mode=self.mode)
                    finish = ("eos" if eos_hit else
                              ("timeout" if timed_out else "length"))
                    done.extend(self._retire(
                        s, state, status="timeout" if timed_out else "ok",
                        finish=finish))
            poll_arrivals()
            fill_slots()                     # splice/dispatch replacements
        if pending is not None and self.adaptive is not None:
            self.adaptive.observe(pending)
        self.stats["decode_retraces_post_warmup"] = post
        _POST_WARMUP_RETRACES.set(post)
        assert post == 0, (
            f"token-granular drain captured the step program {post}x after "
            f"each observe gate had run — splices and policy updates must "
            f"only change buffer values")
        _OCCUPANCY.set(self.occupancy(), mode=self.mode)
        wall = time.perf_counter() - t_drain
        if wall > 0:
            _TOKENS_PER_S.set(
                (self.stats["real_tokens"] - tokens_at_start) / wall,
                mode=self.mode)
        return done

    def run(self) -> List[Completion]:
        """Drain the queues; returns all completions in retirement order."""
        if self.bcfg.token_granular:
            return self._run_token_granular()
        out: List[Completion] = []
        while self.pending():
            out.extend(self.step())
        return out

    def run_arrivals(self, source: "ArrivalSource") -> List[Completion]:
        """Serve an arrival trace: requests are submitted as their
        timestamps (relative to the call) come due, and the loop sleeps
        when none is due.  Token mode admits mid-flight as arrivals land;
        wave mode launches a wave over what has arrived and re-polls
        between waves (late arrivals wait for the next wave)."""
        if self.bcfg.token_granular:
            return self._run_token_granular(source=source)
        out: List[Completion] = []
        t0 = self.clock()
        while True:
            for r in source.poll(self.clock() - t0):
                self.submit(r)
            if not self.pending():
                if source.exhausted():
                    break
                nd = source.next_due()
                now = self.clock() - t0
                if nd is not None and nd > now:
                    time.sleep(min(nd - now, 0.05))
                continue
            out.extend(self.step())
        return out

    def occupancy(self) -> float:
        s = self.stats
        useful = s["real_tokens"]
        total = useful + s["padded_tokens"] + s["filler_tokens"]
        return useful / total if total else 1.0

    def latency_summary(self) -> dict:
        """TTFT / e2e percentiles (seconds) over ``request_log``: exact
        order statistics as ``*_p50``/``*_p99``, each with its
        registry-histogram twin ``*_bucketed`` (linear interpolation over
        ``TTFT_BUCKETS``/``E2E_BUCKETS``) and the covering bucket's width
        ``*_resolution``.  Wave-mode TTFT equals e2e (wave-landing
        granularity).  ``queue_delay_*`` covers records that carry a queue
        delay.  Empty log -> empty dict."""
        if not self.request_log:
            return {}
        e2e = np.asarray([r["e2e"] for r in self.request_log])
        ttft = np.asarray([r["ttft"] for r in self.request_log
                           if r["ttft"] is not None])
        out = dict(requests=len(self.request_log),
                   e2e_p50=float(np.percentile(e2e, 50)),
                   e2e_p99=float(np.percentile(e2e, 99)))
        for q, name in ((0.50, "e2e_p50"), (0.99, "e2e_p99")):
            v, res = obs.bucket_percentile(e2e, obs.E2E_BUCKETS, q)
            out[name + "_bucketed"] = v
            out[name + "_resolution"] = res
        if ttft.size:
            out.update(ttft_p50=float(np.percentile(ttft, 50)),
                       ttft_p99=float(np.percentile(ttft, 99)))
            for q, name in ((0.50, "ttft_p50"), (0.99, "ttft_p99")):
                v, res = obs.bucket_percentile(ttft, obs.TTFT_BUCKETS, q)
                out[name + "_bucketed"] = v
                out[name + "_resolution"] = res
        qd = np.asarray([r["queue_delay"] for r in self.request_log
                         if r.get("queue_delay") is not None])
        if qd.size:
            out.update(queue_delay_p50=float(np.percentile(qd, 50)),
                       queue_delay_p99=float(np.percentile(qd, 99)))
        return out

    def describe(self) -> str:
        s = self.stats
        return (f"batcher[{self.mode}] waves={s['waves']} "
                f"steps={s['decode_steps']} "
                f"requests={s['requests']} splices={s['splices']} "
                f"backfilled={s['backfilled']} "
                f"retraces={s['decode_retraces_post_warmup']} "
                f"shed={s['shed']} timeouts={s['timeouts']} "
                f"stragglers={s['stragglers']} "
                f"slot_util={self.occupancy():.2f} "
                f"(real={s['real_tokens']} padded={s['padded_tokens']} "
                f"filler={s['filler_tokens']})")


# ---------------------------------------------------------------------------
# arrival traces
# ---------------------------------------------------------------------------

class ArrivalSource:
    """A timestamped request trace: sorted ``(t_offset_seconds, Request)``
    pairs for ``ContinuousBatcher.run_arrivals``.  ``poll(now)`` yields (and
    consumes) every request that has come due; ``next_due`` is the next
    timestamp (None when drained).  Offsets count from the start of the
    serve, so a trace replays the same across runs and modes."""

    def __init__(self, items: Sequence[Tuple[float, Request]]):
        self._items = sorted(items, key=lambda it: it[0])
        self._i = 0

    def __len__(self) -> int:
        return len(self._items)

    def exhausted(self) -> bool:
        return self._i >= len(self._items)

    def next_due(self) -> Optional[float]:
        if self.exhausted():
            return None
        return float(self._items[self._i][0])

    def poll(self, now: float) -> List[Request]:
        due: List[Request] = []
        while not self.exhausted() and self._items[self._i][0] <= now:
            due.append(self._items[self._i][1])
            self._i += 1
        return due


def poisson_arrivals(requests: Sequence[Request], rate_rps: float,
                     seed: int = 0) -> ArrivalSource:
    """Stamp ``requests`` with a Poisson process at ``rate_rps`` requests/s:
    iid Exponential(1/rate) gaps, timestamps their cumsum, deterministic in
    ``seed`` (a numpy Generator, so the JAX package's traces are the
    same)."""
    assert rate_rps > 0, "poisson_arrivals: rate must be positive"
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=len(requests))
    return ArrivalSource(list(zip(np.cumsum(gaps).tolist(), requests)))
