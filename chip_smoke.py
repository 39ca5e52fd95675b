#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SWAPPER on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile]

Phases, each of which fails the run (non-zero exit, no result line):

1. card   — the device name and ``nvidia-smi``'s name and power limit;
            exits non-zero when there is no CUDA device;
2. build  — every CUDA kernel of ``src/repro_torch`` built from the
            checkout with ``nvcc`` (time and ``-Xptxas -v`` report);
3. kernel — each kernel (``ax_matmul``, ``ax_matmul_grid``) against its
            plain PyTorch version on the card, bit for bit, at small shapes
            (every REGISTRY multiplier whose product table fits, on the
            route it takes, and each route-T multiplier again through
            route C; three swap configs, or a seeded grid mixing NoSwap,
            A-side and B-side triples; ``tile_hist`` on and off; ragged
            M/N; padded K; a split K; a full 128-row block; both
            grid orders) and at the main path's shapes (route T,
            ``mul8s_trunc0_4``; and route C, ``mul8s_drum3_4``, at the
            decode shapes), with CUDA-event times beside the bound (route
            T: bytes or the int8 tensor-core rate over the 2K-deep
            product; route C: bytes or the gathers over the int32 lanes)
            and ``torch._int_mm`` on the K-stacked limbs as the library
            yardstick of route T (its result must equal the kernel's: a
            second exactness witness; its speed is reported, not gated);
            the tile-mode grid kernel against the
            static one at decode; both kernels timed in turns at equal
            blocks; one grid launch runs under
            ``torch.cuda.set_sync_debug_mode("error")``.  ``tuning_sweep``
            against its plain version on the card: all 90 REGISTRY
            multipliers at N = 256 (8-bit exhaustive, 12- and 16-bit
            sampled at 8 bits), a LUT multiplier and a ragged N; integer
            stats ``torch.equal``, float32 sums within 1e-6 relative; then
            exhaustive 16-bit sweeps (N = 65536, 2^32 pairs) of Table I's
            16-bit rows and one 12-bit row (N = 4096), held to the plain
            version on 1024 seeded rows (every row at N = 4096), launched
            twice with identical results, with the compiled instantiation
            each takes and CUDA-event times beside the bound (operations
            counted from each family's definition in its least form: per
            pair what depends on both operands, per value what depends on
            one; integer ops over the int32 lanes, float ops over the
            float32 lanes), the earlier design's time and the plain
            version's time; every check goes through the ``tuning_sweep``
            wrapper;
4. ref    — every reduced config of ``configs.ARCHS`` served on the card
            agrees with the same model served on the CPU through the
            plain versions (f32 prefill logits within its bounds: qwen2
            5e-2, the families 0.4 and mean 0.05, the bounds of an int8
            code flip; greedy tokens equal unless the CPU's top-2 margin
            is below the max bound; MoE routing flips counted and allowed
            only on a near-tie); reduced qwen2 adaptive too (tokens and
            re-tunes);
   whisper — (this phase and the next run before serve, whose model
            stays on the card to the end) whisper-base, the
            encoder-decoder, at its full published config (6 + 6 layers,
            d_model 512, vocab 51865), random f32
            weights, bf16 compute, the serve phase's policy: prefill + 3
            decode steps against the full forward over 1500 frames (f32,
            exact projections, as the families); B = 4 with 1500 seeded
            frames, 8 decoder tokens, 16 greedy tokens eagerly and as a
            CUDA graph twice (equal tokens, 1 capture then 0, launches
            18 + 24 in the prefill and 24 a decode step, reckoned from
            ``models.whisper.ax_projections``), adaptive serving refused,
            the launched shapes (the encoder's 6000-row GEMMs among them)
            equal the reckoned ones and each is held to the plain version;
   train  — reduced qwen2 and deepseek-moe (2 layers, f32) train 5 AdamW
            steps on the CPU, exact and SWAPPER, each step also on the card
            from the CPU's state: loss, grad norm and every leaf's update
            within ``TOL_TRAIN_*``, a MoE routing flip only on a near-tie;
            at published widths with ``--ax`` (``mxu``):
            whisper-base (4 x 1500 frames, 64 target tokens) and
            deepseek-moe-16b at 2 layers (1.09 G parameters) take 10 steps
            each (finite losses, ``ax_matmul`` launches = projections x
            steps, none in the backward), deepseek 4 adaptive steps with a
            policy change after step 2 (telemetry from every target,
            ``ax_matmul_grid`` launches = projections x steps, nothing
            rebuilt), ``run_supervised`` on whisper-base survives a
            ``SimulatedFailure`` at step 6 of 12 within 1e-5 relative of
            the uninterrupted run (bit-equality printed); ms/step and
            tokens/s; every launched shape held to the plain version.
   mesh   — the fleet mesh on the serve's model (qwen2-72b x2, ``mxu``,
            adaptive with a detector that never fires; B = 8 x 32, 8
            tokens; 12 requests over 8 slots): (a) a one-rank ``nccl``
            world in this process: ``generate(mesh=)`` and a mesh token
            drain equal the same serves without a mesh bit for bit
            (tokens, the 7 fleet records, executed launches 8 + 56, no
            capture); (b) two ``gloo`` ranks spawned on the card while this
            process holds no model: which ``gloo`` collectives take card
            tensors (printed), the mesh tokens == each rank's solo serve of
            its rows and the single-process unrolled adaptive loop over
            them, bit for bit; against that loop over all 8 rows in one
            process (an 8-row prefill) equal or diverging below a top-2
            margin of ``TOL_BATCH``; every fleet record ==
            ``combine_records`` of the solo records, the telemetry sums and
            max == the solo runs', executed launches per rank == the solo
            half batch's, a policy update captures nothing and builds
            nothing, the 2-rank drain == the one-rank drain per request or
            below the margin bound; the walls and the aggregation's share
            of the decode wall are printed;
   train mesh — the sharded train step (``make_train_step(mesh=)``) on
            two ``gloo`` ranks spawned on the card while this process holds
            no model (after its one-card reference steps): the step's
            collectives on card tensors, values checked (all-gather,
            reduce-scatter, all-to-all, and for tensor parallelism
            all-reduce MAX f32, SUM int32 and an int32 reduce-scatter); the
            SWAPPER projection split over K on the two ranks == the
            one-card call bit for bit at qwen2-72b's ``mlp out`` (K 29568
            -> 14784 a rank, N 8192; ``ax_dense`` and ``ax_dense_dyn``, 4
            and 512 rows, the int32 sums all-reduced or reduce-scattered
            over ``seq``); deepseek-moe-16b at its published widths, depth
            2, ``mxu``, B = 4 x 256, on (a) ``("data",)`` = 2 with FSDP
            (4 static steps, then 2 adaptive ones with the policy changed
            between them), (b) ``("data", "model")`` = (1, 2) with
            ``dp_only`` + ``ep``, 32 of the 64 experts a rank and the
            expert all-to-all (4 static steps, and a ``remat="layer"``
            step from step 1's state, whose recomputed all-to-all runs on
            autograd's device thread), (c) the same mesh with tensor
            parallelism + ``ep`` (heads, ``ff`` and vocab split; 4 static
            and 2 adaptive steps) and (d) (c) with ``seq_shard`` (4 static
            steps and a ``remat="layer"`` step): finite losses, step 1
            within 1e-2 relative of the one-card step (a MoE routing flip,
            or another token shard's capacity), the remat step's loss, ce,
            aux and grad norm within ``TOL_TRAIN_STEP`` of step 1's ((d):
            loss, ce and aux equal), ``ax_matmul`` launches a rank =
            projections x steps and ``ax_matmul_grid`` likewise in the
            adaptive steps, no nvcc, every launched shape (recorded at the
            wrappers, reckoned from the config and, on (c) and (d), its
            split) held to the plain version; the reduced deepseek (f32,
            exact, no drops) sharded on every layout, and on (b) and (d)
            with ``remat="layer"``, and the reduced qwen2 (its one kv head
            split inside a head) on (c) and (d), against the one-card step
            within ``TOL_TRAIN_STEP`` / ``TOL_TRAIN_UPDATE``;
            ``run_supervised`` on (a) with a crash within 1e-5 relative of
            the uninterrupted run; ms/step (steps 2-3, uninstrumented), peak
            memory and the collectives' share of step 4 (each collective
            between two synchronises) per rank printed;
   tp serve — the model-sharded prefill and decode step
            (``generate(par=)`` under ``set_mesh_ctx``) on two ``gloo`` ranks
            sharing the card, ``("data", "model")`` = (1, 2), JAX's default
            ``ParallelConfig`` (``seq_shard``, ``ep``): qwen2-72b, then
            deepseek-moe-16b (capacity 16: no choice drops), each at its
            published widths, depth 2, ``mxu``, bf16, B = 4 x 32, 8 greedy
            tokens, a cache of ``TPS_LEN`` rows split on its sequence; the
            same weights served on one card in this process first, plainly
            and with its plain q/k/v GEMMs over the ranks' column blocks
            (``tps_witness``).  Hard: the first prefill's and each
            teacher-forced decode step's logits in f32 on exact projections
            (the families' card check) within ``TOL_TPS_F32`` of the
            largest one-card logit and the cache gathered from both ranks
            within it of the one-card cache; the bf16 serve's logits, its
            gathered cache and its tokens equal to the witness's
            (``TOL_TPS_WITNESS``), its tokens the same twice, the
            ranks agreeing, executed ``ax_matmul`` launches a rank =
            projections a forward x 8 (the loop and the serve), the
            launched shapes == those reckoned from the config and its
            split (N halved for the column-parallel projections, K for the
            row-parallel ones), each held to the plain version, no nvcc;
            the bf16 gaps against the plain one card (a GEMM over half the
            columns rounds apart from the whole one), the decode ms/step,
            the collectives' share of a serve (each between two
            synchronises) and the peak a rank printed;
   tp adapt — adaptive serving of the model-sharded model on the same two
            ranks and configs (``TPA_*``): ``generate(par=, adaptive=,
            param_hook=drift_hook(3, 0.05))`` of B = 4 x 32 and 12 tokens in
            scalar mode and in tile mode (2 row tiles), then two token-mode
            ``ContinuousBatcher(adaptive=, par=)`` drains of 8 requests on 4
            slots with one controller, the second of the drifted weights,
            every decode step eager (``cuda_graphs=False``); the same on one
            card in this process with the ranks' q/k/v GEMMs
            (``tps_witness``) and plainly.  Hard: the tokens, every observed
            record (field by field), the re-tunes, the tile re-tunes' grids
            and the policy JSON equal to the witness's and on both ranks,
            the drift serve re-tuning; executed launches a rank =
            projections x (2 prefills + 16 admissions) ``ax_matmul`` and x
            (2 x 11 + the drains' steps) ``ax_matmul_grid``; the launched
            shapes == those reckoned from the config and its split (the
            grid kernel's in tile mode unpadded along N), the new ones held
            to the plain version; no graph capture, no nvcc.  Printed: the
            plain one card's agreement, prefill and decode ms/step, the
            collectives' share of a tile serve and the records' gathers
            (``runtime.telemetry.tp_operands``; a synchronise around each);
5. serve  — qwen2-72b at its published widths, depth cut to 2 layers,
            random weights from a seed: the per-forward weight work that
            the weight cache removes, timed against its bytes; B=4 prompts
            of 32 tokens, 8 greedy tokens, SWAPPER ``backend="kernel"``
            eagerly twice (deterministic tokens, exactly 2 layers x 4
            projections x 8 forwards = 64 ``ax_matmul`` launches), the
            default ``mxu`` backend (the same tokens and launches), then
            both with the decode step as a CUDA graph: the eager tokens,
            64 executed launches, one capture and then none;
   autotune — ``kernels.autotune.tune_table`` (quick) on the same card
            over the serve's three projection shapes (8192 x 8192,
            8192 x 29568, 29568 x 8192) at 4 decode and 128 prefill rows,
            for ``matmul``/``matmul_grid`` and ``int_static``/``int_dyn``,
            each candidate a CUDA graph of back-to-back dispatches timed
            with events (winner and default walls printed); every
            candidate's output and ``tile_hist`` == the plain version
            (max |diff| 0); no nvcc run in the sweep or the install; the
            table published to a temporary ``ScheduleStore`` and adopted
            by a ``ScheduleReader``; the serve phase's graph serve after the
            adoption: the same tokens, 0 captures (every program's count
            unchanged), table hits > 0 from the eager prefill; the table is
            cleared at the end;
6. adapt  — the same model served with an ``AdaptiveController``: with a
            threshold that never fires the tokens equal the static serve's
            (8 ``ax_matmul`` launches in prefill, 56 ``ax_matmul_grid`` in
            decode), eagerly and as graphs, in scalar and in tile mode; a
            policy update re-captures nothing and gives the eager tokens of
            that policy; with weight drift injected at step 3 in tile mode,
            12 tokens, twice with fresh controllers: at least one re-tune,
            the same tokens, 8 + 88 launches each;
   slot   — per-slot serving: prompts of lengths 32/19/7/26 right-padded
            to 32, budgets 8/3/8/5, an EOS taken from the run's own tokens:
            eager == graph, budgets freeze, EOS retires, rotated slots give
            the same tokens, each prompt alone padded == unpadded, and
            against each prompt alone equal tokens up to a divergence
            below a top-2 margin of ``TOL_BATCH``;
   token  — ``prefill_one`` + ``splice_slot`` + ``token_step`` (a CUDA
            graph) over 4 slots: the per-request tokens of the wave oracle,
            mid-flight splices with no re-capture, no host synchronise in a
            step, inactive slots' cache rows unchanged;
   fleet  — the continuous batcher (``fleet.ContinuousBatcher``) over the
            same model with ``mxu`` (route T): 12 seeded requests (prompts
            of 5-32 tokens in buckets 16 and 32, budgets 1-8) over 4 slots
            and an EOS taken from the run's own tokens.  Wave == token per
            request, greedy and at temperature 0.8 with per-request seeds,
            with sync and async admission; EOS truncation; an adaptive token
            drain and an adaptive wave (a threshold that never fires) give
            the static wave's tokens, every token completion carries a QoR
            summary and every wave completion a corr id and none; no
            capture after warm-up, none in a second drain on one batcher;
            executed launches 8 x (admissions + steps) static token, 8 x
            admissions + 8 x steps adaptive token, 8 x forwards static wave,
            8 x waves + 8 x 7 x waves adaptive wave; a ``prefill_one`` under
            ``no_sync``; ``max_queue`` sheds the excess, a lapsed deadline
            times out with 0 tokens, a ``stall_step`` fires once, a
            ``crash_replica`` is survived with every request retired once;
            a Poisson trace at 200 req/s gives the direct drain's tokens;
            a cross-bucket backfill drain (a 20-token request opens a
            bucket-32 wave, three 16-bucket requests fill it:
            ``repro_backfills_total`` above 0) equal bit for bit to a
            token-mode drain whose one bucket is the wave's (admissions
            prefilled at 32 over the slot count), and against the
            token-mode drain with both buckets equal or diverging below a
            top-2 margin of ``TOL_BATCH``; the serve CLI in process (``--smoke --ax --fleet 1
            --token-granular`` with ``--obs-dir``: ``token_step`` spans in
            ``trace.json``; ``--smoke --ax --adaptive``).  Decode ms/step,
            TTFT, e2e and queue-delay percentiles, occupancy, tokens/s and
            stragglers per mode are printed;
   rollout — observability and the guarded rollout over a ``PolicyStore`` in
            a temporary directory, a ``TraceRecorder`` installed: the drift
            serve (stepwise, scalar mode, 12 tokens) as the writer, with
            ``canary=True`` and the default serving SLOs: at least one
            canaried re-tune, CURRENT the last promotion, the same audit
            kinds twice, and every audit event equal when its host records
            are replayed through a CPU controller and store; with
            ``canary_margin=1.0`` nothing is promoted and the tokens are a
            never-changing policy's; a ``PolicyReader`` on the card polls
            after each publish and serves the fused graph path: tokens of
            each version equal an eager controller serve of
            ``store.load(N)``, no capture, staleness the versions it lags
            and 0 after a poll, ``repro_retraces_total`` == the captures by
            kind; the low-then-high regimes roll back exactly once to
            last-good and the replica follows with no capture; a fault plan
            armed but idle changes nothing, a seeded ``poison_nan`` lands in
            quarantine; Prometheus text holds nonzero series of the serve,
            controller, store and chaos families, ``trace.json`` the
            prefill/decode/retune/canary/rollback spans; the step MAE of
            the card's records per target, decode ms/step with a recorder
            installed and the re-tune/canary/publish/poll walls are
            printed, and after phase 8 a ``device_trace`` of one replica
            serve (a ``torch.profiler`` session slows the host-bound phases
            that follow it);
   families — the eight other decoder-only configurations of
            ``configs.ARCHS`` (gemma3-27b, starcoder2-15b, qwen1.5-110b,
            qwen2-vl-72b, deepseek-moe-16b, granite-moe-1b-a400m,
            recurrentgemma-2b, mamba2-370m) at their published widths,
            depth cut to the leading layers plus one period (gemma3 6,
            recurrentgemma 3, the others 2), random f32 weights from a
            seed, the serve phase's policy: prefill + 3 decode steps
            against the full forward (f32, exact projections, the
            tolerances of ``tests/test_arch_smoke.py`` and 1e-4 of the
            largest logit); B = 4 prompts of
            32 tokens (embeds and 3-stream M-RoPE positions for qwen2-vl),
            8 greedy tokens eagerly and as a CUDA graph twice: equal
            tokens, 1 capture then 0, ``ax_matmul`` launches equal to the
            approximate projections a forward reckoned from the config
            times the forwards; gemma3 with a 1023-token prefill whose
            decode overwrites ring row 0 (against the full forward) and a
            1020-token serve; a no-drift adaptive serve of recurrentgemma
            and of deepseek gives the static tokens through
            ``ax_matmul_grid``; the kernel shapes of those launches,
            recorded at the wrappers, equal those reckoned from the
            config (``transformer.ax_projections``, padded as the dense
            path pads), and each kernel is held to its plain version and
            timed beside its bound at every one of them.  No nvcc runs
            after phase 2.  With ``--profile`` static, no-drift and drift serves
            run under ``torch.profiler`` (eager and graph) and the device
            time by kernel and the device's busy share are printed (and, in
            phases 7 and 8, one 16-bit Table I row and one app run).
7. tune   — Table I (``benchmarks/component_table.py``'s multipliers) on
            the card through ``component_sweep`` and the sweep kernel: 8,
            12 and 16 bits exhaustive (the JAX table samples 16 bits at
            2^10); one launch per sweep; the 8-bit rows and a 16-bit row at
            ``sample_bits=10`` equal the same sweeps on the CPU (integer
            fields and ``best("mae")``); each of the 25 sweeps, launched
            again, equals the plain version (every row up to N = 4096, 1024
            seeded rows at N = 65536), and Table I's seconds are split into
            the sweeps' kernel time and the rest;
8. apps   — Tables II/III (``benchmarks/app_table.py``'s default set: 3
            mul16s multipliers x 7 apps, MD_LO): comp-best from kernel
            sweeps at ``sample_bits=9`` (3 launches a run, each sweep held
            to the plain version), ``tune_app`` on the train seed,
            ``evaluate`` on the test seed; twice, finite and identical; and
            ``sobel`` at a small n on the card equals it on the CPU.

The second-to-last line is the ``kernels`` JSON summary, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
try:                             # the H100 SXM's data-sheet rates, one copy in the port
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.roofline import INT8_OPS as INT8_TENSOR_OPS_PER_S
except ImportError:              # outside a checkout: main() refuses to run
    HBM_BYTES_PER_S = INT8_TENSOR_OPS_PER_S = None
INT32_LANES_PER_SM = 64          # int32 CUDA-core lanes per SM per clock
FP32_LANES_PER_SM = 128          # float32 CUDA-core lanes per SM per clock
TABLE_BYTES = 65536 * 2


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

def small_checks(dev):
    import torch

    from repro_torch.core.multipliers import REGISTRY
    from repro_torch.core.swapper import SwapConfig
    from repro_torch.kernels.ax_matmul import (ax_matmul_cuda, ax_matmul_grid_cuda,
                                               ax_matmul_grid_plain, ax_matmul_plain,
                                               product_table, route_of)
    from repro_torch.quant.ax import _pad_to_multiple

    g = torch.Generator().manual_seed(7)
    # (M, K logical, N, (bm, bn, bk), grid order): ragged M/N edges, K
    # zero-padded to a multiple of bk, both grid orders, decode-sized M, a
    # split K, a full 128-row block
    cases = [(37, 50, 45, (16, 32, 32), "mn"),
             (64, 128, 96, (32, 64, 64), "nm"),
             (4, 256, 200, (4, 128, 128), "mn"),
             (4, 2048, 256, (2, 128, 128), "nm"),
             (128, 256, 160, (64, 32, 128), "mn")]
    n_ok, n_grid, skipped, routes = 0, 0, [], {"T": 0, "C": 0}
    for name, mult in REGISTRY.items():
        dtype = torch.int8 if mult.signed else torch.uint8
        try:
            product_table(mult, dtype, dev)
        except ValueError:
            skipped.append(name)
            continue
        lo, hi = (-128, 128) if mult.signed else (0, 256)
        # a route-T multiplier is also held to plain through route C
        forced = [None] if route_of(mult, dtype) == "C" else [None, "C"]
        routes[route_of(mult, dtype)] += 1
        for M, K, N, (bm, bn, bk), order in cases:
            a = torch.randint(lo, hi, (M, K), generator=g).to(dtype)
            b = torch.randint(lo, hi, (K, N), generator=g).to(dtype)
            a = _pad_to_multiple(a, bk, 1).contiguous().to(dev)
            b = _pad_to_multiple(b, bk, 0).contiguous().to(dev)
            for swap, hist, route in itertools.product(
                    (None, SwapConfig("A", 3, 1), SwapConfig("B", 6, 0)), (False, True), forced):
                got = ax_matmul_cuda(a, b, mult, swap, bm=bm, bn=bn, bk=bk,
                                     grid_order=order, tile_hist=hist, _route=route)
                want = ax_matmul_plain(a, b, mult, swap, bm=bm, bn=bn,
                                       tile_hist=hist)
                torch.cuda.synchronize()
                pairs = zip(got, want) if hist else [(got, want)]
                for x, y in pairs:
                    if not torch.equal(x, y):
                        fail(f"ax_matmul != plain: {name} {(M, K, N)} "
                             f"blocks {(bm, bn, bk)} {order} swap {swap} "
                             f"hist {hist} route {route or 'chosen'}: max |diff| "
                             f"{(x.long() - y.long()).abs().max().item()}")
                n_ok += 1
            grid = mixed_grid(-(-M // bm), -(-b.shape[1] // bn), g, mult.bits).to(dev)
            for hist, route in itertools.product((False, True), forced):
                got = ax_matmul_grid_cuda(a, b, mult, grid, bm=bm, bn=bn, bk=bk,
                                          grid_order=order, tile_hist=hist, _route=route)
                want = ax_matmul_grid_plain(a, b, mult, grid, bm=bm, bn=bn, tile_hist=hist)
                torch.cuda.synchronize()
                for x, y in (zip(got, want) if hist else [(got, want)]):
                    if not torch.equal(x, y):
                        fail(f"ax_matmul_grid != plain: {name} {(M, K, N)} blocks "
                             f"{(bm, bn, bk)} {order} hist {hist} route "
                             f"{route or 'chosen'}: max |diff| "
                             f"{(x.long() - y.long()).abs().max().item()}")
                n_grid += 1
    fits = len(REGISTRY) - len(skipped)
    print(f"kernel ax_matmul == plain (torch.equal) on {n_ok} small cases, "
          f"ax_matmul_grid == plain on {n_grid} ({fits} multipliers: route T "
          f"{routes['T']}, also forced through route C; route C {routes['C']}; table "
          f"does not fit, skipped: {', '.join(skipped) or 'none'})", flush=True)


def mixed_grid(gm: int, gn: int, gen, bits: int = 8):
    """A (gm, gn, 3) int32 grid mixing NoSwap, A-side and B-side triples."""
    import torch

    op = torch.randint(0, 2, (gm, gn), generator=gen)
    bit = torch.randint(0, bits, (gm, gn), generator=gen)
    val = torch.randint(0, 3, (gm, gn), generator=gen)          # 2 = NoSwap
    return torch.stack([op, bit, val], dim=-1).to(torch.int32).contiguous()


MAIN_SHAPES = [("decode mlp in/gate", 4, 8192, 29568), ("decode mlp out", 4, 29568, 8192),
               ("decode attn_out", 4, 8192, 8192), ("prefill mlp in/gate", 128, 8192, 29568),
               ("prefill mlp out", 128, 29568, 8192), ("prefill attn_out", 128, 8192, 8192)]


def main_shape_checks(dev, card: str, clock_mhz: float, grid_kernel: bool,
                      mult_name: str = "mul8s_trunc0_4", shapes=MAIN_SHAPES):
    """One kernel at the main path's shapes: held against its plain version,
    timed beside its bound, its plain version and, for a separable
    multiplier, ``torch._int_mm`` on the K-stacked limbs (the library
    yardstick; the port never calls it).

    ``ax_matmul``: default 128/128/128 blocks, swap A[3]==0.  ``ax_matmul_grid``:
    the blocks of tile mode with 2 row tiles (bm = M/2: 2 at decode, 64 at
    prefill; 128, the block cap, beyond 256 rows, with more tiles) and an
    A-side grid whose row tiles alternate A[3]==0 and A[5]==1.  The bound of
    route T is the larger of the bytes over the memory rate and the
    2 * M * 2K * N operations of the stacked product over the int8
    tensor-core rate; of route C the bytes (the product table included)
    and the M * K * N gathers over the int32 lanes."""
    import torch

    from repro_torch.core.multipliers import get, separable_transforms
    from repro_torch.core.swapper import SwapConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.ax_matmul import route_of
    from repro_torch.kernels.ref import ax_matmul_grid_blocks_ref, ax_matmul_ref
    from repro_torch.kernels.schedule import KernelSchedule

    mult = get(mult_name)
    route = route_of(mult, torch.int8)
    fg = separable_transforms(mult.name) if route == "T" else None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int32_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    gen = torch.Generator(device=dev).manual_seed(11)
    name = "ax_matmul_grid" if grid_kernel else "ax_matmul"
    rows = []

    def ends(n: int, cap: int):
        """All of 0..n-1 up to ``cap``, else the first and the last 128."""
        idx = torch.arange(n, device=dev)
        return idx if n <= cap else torch.cat([idx[:128], idx[-128:]])

    for label, M, K, N in shapes:
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        # bound the plain version's time: every column at decode; at prefill
        # the first 256 columns (grid) or the first and last 128 (static),
        # and beyond 512 rows the first and last 128 rows (static)
        cols = N if M <= 4 else 256
        bs = b[:, :cols].contiguous()
        ri, ci = torch.arange(M, device=dev), torch.arange(cols, device=dev)
        if grid_kernel:
            bm, bn = min(M // 2, 128), 128
            triples = torch.tensor([[1, 3, 0], [1, 5, 1]], dtype=torch.int32, device=dev)
            triples = triples[torch.arange(M // bm, device=dev) % 2]    # alternating row tiles
            grid = triples[:, None, :].expand(M // bm, -(-N // bn), 3).contiguous()
            sched = KernelSchedule(bm, bn, 128)
            run = lambda: ops.ax_matmul_grid(a, b, mult, grid, schedule=sched)  # noqa: E731
            gs = grid[:, :-(-cols // bn)].contiguous()
            plain = lambda: ax_matmul_grid_blocks_ref(a, bs, mult, gs, bm, bn)  # noqa: E731
            row_trip = triples.repeat_interleave(bm, dim=0)            # (M, 3)
            grid_bytes = grid.numel() * 4
        else:
            swap = SwapConfig("A", 3, 0)
            ri, ci = ends(M, 512), ends(N, N if M <= 4 else 256)
            a_p, bs = a.index_select(0, ri), b.index_select(1, ci)
            run = lambda: ops.ax_matmul(a, b, mult, swap)  # noqa: E731
            plain = lambda: ax_matmul_ref(a_p, bs, mult, swap)  # noqa: E731
            row_trip = torch.tensor([[1, 3, 0]], dtype=torch.int32, device=dev).expand(M, 3)
            grid_bytes = 0
        out = run()
        want = plain()
        torch.cuda.synchronize()
        err = (out.index_select(0, ri).index_select(1, ci).long() - want.long()).abs().max().item()
        if err != 0:
            fail(f"{name} != plain at {label} {(M, K, N)} ({mult_name}, route {route}): "
                 f"max |diff| {err}")
        ms = cuda_ms(run, iters=5 if M > 4 and route == "C" else 20)
        plain_ms = cuda_ms(plain, iters=1, warmup=0)

        library_ms, lib_equal = None, None
        if fg is not None:
            # library yardstick: the same function for this separable family
            # and an A-side decision per row, as one int8 GEMM over the
            # K-stacked limbs (M padded to 32 rows)
            f, gfn = fg
            ai, bi = a.to(torch.int32), b.to(torch.int32)
            s_ = (((ai >> row_trip[:, 1:2]) & 1) == row_trip[:, 2:3]).to(torch.int32)
            x = torch.cat([s_ * gfn(ai), (1 - s_) * f(ai)], dim=1).to(torch.int8)
            y = torch.cat([f(bi), gfn(bi)], dim=0).to(torch.int8).contiguous()
            mp = max(32, -(-M // 8) * 8)
            xp = torch.zeros((mp, 2 * K), dtype=torch.int8, device=dev)
            xp[:M] = x
            lib_equal = bool(torch.equal(torch._int_mm(xp, y)[:M], out))
            if not lib_equal:
                fail(f"{name} != torch._int_mm on the K-stacked limbs at {label} "
                     f"{(M, K, N)} ({mult_name})")
            library_ms = cuda_ms(lambda: torch._int_mm(xp, y), iters=20)
            del ai, bi, s_, x, y, xp

        if route == "T":
            nbytes = M * K + K * N + 4 * M * N + 256 * 4 + grid_bytes
            t_ops = 2 * M * 2 * K * N / INT8_TENSOR_OPS_PER_S * 1e3
        else:
            nbytes = M * K + K * N + 4 * M * N + TABLE_BYTES + grid_bytes
            t_ops = M * K * N / int32_rate * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        row = dict(shape=label, M=M, K=K, N=N, mult=mult_name, route=route, ms=ms,
                   plain_ms=plain_ms, plain_rows=len(ri), plain_cols=len(ci),
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=library_ms, library_equal=lib_equal, max_abs_err=err)
        rows.append(row)
        lib = "none (inseparable)" if library_ms is None else \
            f"{library_ms:.4f} ms (equal: {lib_equal})"
        print(f"{name} route {route} {mult_name} {label} (M={M}, K={K}, N={N}): {ms:.4f} ms; "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); kernel/bound "
              f"{ms / row['bound_ms']:.2f}; plain {plain_ms:.2f} ms on {len(ri)} rows x "
              f"{len(ci)} cols; torch._int_mm limbs {lib}; max |diff| {err}; [{card}]", flush=True)
        del a, b, bs, out, want, ri, ci
    torch.cuda.empty_cache()
    return rows


def equal_blocks_timing(dev, card: str):
    """``ax_matmul`` and ``ax_matmul_grid`` (a uniform grid of the same
    triple) at the same default blocks on the decode shapes, timed in turns
    (static, grid, grid, static): the grid's per-block triple load is the
    only difference."""
    import torch

    from repro_torch.core.multipliers import get
    from repro_torch.core.swapper import SwapConfig, cfg_to_triple
    from repro_torch.kernels import ops

    mult, swap = get("mul8s_trunc0_4"), SwapConfig("A", 3, 0)
    gen = torch.Generator(device=dev).manual_seed(12)
    for label, M, K, N in MAIN_SHAPES[:3]:
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        grid = torch.tensor(cfg_to_triple(swap), dtype=torch.int32, device=dev)
        grid = grid.expand(1, -(-N // 128), 3).contiguous()
        static = lambda: ops.ax_matmul(a, b, mult, swap)
        gridded = lambda: ops.ax_matmul_grid(a, b, mult, grid)
        if not torch.equal(static(), gridded()):
            fail(f"uniform-grid ax_matmul_grid != ax_matmul at {label}")
        t = [cuda_ms(fn, iters=20) for fn in (static, gridded, gridded, static)]
        print(f"equal blocks ({M}/128/128) {label}: ax_matmul {t[0]:.4f} / {t[3]:.4f} ms, "
              f"ax_matmul_grid {t[1]:.4f} / {t[2]:.4f} ms (grid/static "
              f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}) [{card}]", flush=True)
        del a, b


def sync_free_grid_launch(dev):
    """A grid launch, and a launch after a new grid value, with the CUDA
    sync debug mode set to raise on any host synchronise."""
    import torch

    from repro_torch.core.multipliers import get
    from repro_torch.kernels import ops
    from repro_torch.kernels.schedule import KernelSchedule

    g = torch.Generator().manual_seed(5)
    a = torch.randint(-127, 128, (4, 8192), generator=g, dtype=torch.int8).to(dev)
    b = torch.randint(-127, 128, (8192, 1024), generator=g, dtype=torch.int8).to(dev)
    grid, other = (mixed_grid(2, 8, g).to(dev) for _ in range(2))
    mult, sched = get("mul8s_trunc0_4"), KernelSchedule(2, 128, 128)
    ops.ax_matmul_grid(a, b, mult, grid, schedule=sched)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.ax_matmul_grid(a, b, mult, grid, schedule=sched, tile_hist=True)
        grid.copy_(other)
        ops.ax_matmul_grid(a, b, mult, grid, schedule=sched)
    except RuntimeError as e:
        fail(f"the grid launch path synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("ax_matmul_grid: launches with a new grid value ran under "
          "set_sync_debug_mode('error') (no host synchronise)", flush=True)


# The float32 sq/rel sums of the sweep: the same rounded float32 terms,
# summed in float64 and rounded once by the kernel and the plain version,
# which differ only in the order of the float64 additions.
SWEEP_RTOL = 1e-6
# Table I rows (benchmarks/component_table.py:11-19) and the Tables II/III
# default set (benchmarks/app_table.py:12-16)
MULTS_8 = ["mul8u_trunc0_4", "mul8u_trunc2_4", "mul8u_perf0_1", "mul8u_bam_v2_h1",
           "mul8u_mitch13_0", "mul8u_drum3_4", "mul8u_drum2_6", "mul8s_trunc0_4",
           "mul8s_bam_v2_h1", "mul8s_drum3_4", "mul8u_trunc2_2", "mul8u_drum4_4"]
MULTS_12 = ["mul12u_trunc0_6", "mul12u_bam_v3_h1", "mul12u_drum4_6", "mul12s_trunc1_7",
            "mul12s_mitch10_13"]
MULTS_16 = ["mul16u_trunc0_8", "mul16u_drum2_14", "mul16s_trunc0_8", "mul16s_bam_v4_h1",
            "mul16s_drum5_8", "mul16s_mitch10_13", "mul16s_trunc4_4"]
APP_MULTS = ["mul16s_drum5_8", "mul16s_bam_v4_h1", "mul16s_mitch10_13"]
APP_N = {"ssim": 64, "are": 256, "miss_rate": 256}
TEST_SEED, TRAIN_SEED = 1234, 42


def sweep_compare(got, want, label: str, rows=None):
    """Fail unless the integer stats are equal and the float32 sums within
    SWEEP_RTOL; returns (the largest |got - want| of the integer stats, the
    largest relative difference of the sums)."""
    from repro_torch.kernels.tuning_sweep import STAT_NAMES, SURF_NAMES

    int_err, rel_err = 0, 0.0
    for surf in SURF_NAMES:
        for st in STAT_NAMES:
            x = got[surf][st] if rows is None else got[surf][st][rows]
            y = want[surf][st]
            if x.dtype != y.dtype or x.shape != y.shape:
                fail(f"tuning_sweep != plain: {label} {surf}.{st} is {x.dtype} "
                     f"{tuple(x.shape)}, plain {y.dtype} {tuple(y.shape)}")
            if st in ("sq", "rel"):
                rel = (x.double() - y.double()).abs() / y.double().abs().clamp(min=1e-30)
                rel_err = max(rel_err, rel.max().item())
            else:
                int_err = max(int_err, (x.long() - y.long()).abs().max().item())
    if int_err != 0 or not rel_err <= SWEEP_RTOL:
        fail(f"tuning_sweep != plain: {label}: integer stats max |diff| {int_err}, "
             f"sums relative diff {rel_err} (tol {SWEEP_RTOL})")
    return int_err, rel_err


def hold_sweeps(dev, specs, label: str):
    """The sweeps of a phase's main path, launched again through the
    ``tuning_sweep`` wrapper on the same operand sets and held to the plain
    version: every row up to N = 4096, 1024 seeded rows above.  Returns
    (the largest integer |diff|, the largest relative difference of the
    sums, the number of sweeps, the sweeps' summed time in ms by CUDA events
    around each wrapper call)."""
    import torch

    from repro_torch.core.tuning import operand_values
    from repro_torch.kernels.tuning_sweep import tuning_sweep, tuning_sweep_plain

    g = torch.Generator().manual_seed(14)
    int_err, rel_err, kernel_ms = 0, 0.0, 0.0
    for m, sample_bits in specs:
        vals = torch.from_numpy(operand_values(m.bits, m.signed, sample_bits)).to(dev)
        n = vals.numel()
        rows = None if n <= 4096 else torch.randperm(n, generator=g)[:1024].to(dev)
        out = {}
        kernel_ms += cuda_ms(lambda: out.update(s=tuning_sweep(m, vals)), iters=1, warmup=0)
        want = tuning_sweep_plain(m, vals, rows=rows)
        i, r = sweep_compare(out["s"], want, f"{label}: {m.name} N={n}", rows)
        int_err, rel_err = max(int_err, i), max(rel_err, r)
    return int_err, rel_err, len(specs), kernel_ms


def sweep_small_checks(dev):
    """``tuning_sweep`` == plain on every REGISTRY multiplier at N = 256, a
    LUT multiplier, a ragged N and a broken array of 16 masked rows (the
    largest instantiation); a multiplier without a kernel descriptor raises
    on the card."""
    import torch

    from repro_torch.core.multipliers import REGISTRY, broken_array, get, lut_mult, make_lut
    from repro_torch.core.swapper import oracle_mult
    from repro_torch.core.tuning import operand_values
    from repro_torch.kernels.tuning_sweep import tuning_sweep, tuning_sweep_plain

    base = get("mul8s_drum3_4")
    cases = [(name, m, operand_values(m.bits, m.signed, None if m.bits == 8 else 8))
             for name, m in REGISTRY.items()]
    cases.append(("lut(mul8s_drum3_4)", lut_mult("lut_mul8s_drum3_4", make_lut(base), True),
                  operand_values(8, True)))
    cases.append(("mul12u_drum4_6 ragged N=300", get("mul12u_drum4_6"),
                  operand_values(12, False, 9, 5)[:300].copy()))
    cases.append(("bam16u_v16_h0 (16 masked rows)", broken_array(16, 16, 0, False),
                  operand_values(16, False, 8)))
    int_err, worst = 0, 0.0
    for label, m, vals in cases:
        v = torch.from_numpy(vals).to(dev)
        got = tuning_sweep(m, v)
        want = tuning_sweep_plain(m, v)
        torch.cuda.synchronize()
        i, r = sweep_compare(got, want, label)
        int_err, worst = max(int_err, i), max(worst, r)
    try:
        tuning_sweep(oracle_mult(base), v)
        fail("tuning_sweep took a multiplier without a kernel descriptor on the card")
    except ValueError:
        pass
    print(f"kernel tuning_sweep == plain on {len(cases)} cases ({len(REGISTRY)} REGISTRY "
          f"multipliers at N=256, a LUT, a ragged N=300, 16 masked rows): integer stats max |diff| "
          f"{int_err}, sq/rel max relative diff {worst:.3g} (tol {SWEEP_RTOL}); a "
          f"multiplier without a descriptor raises", flush=True)
    return int_err, worst


# the exhaustive sweeps timed in phase 3: Table I's 16-bit rows and one
# 12-bit row, beside their times in run E of the earlier design (PERF.md
# section 6; NVIDIA H100 80GB HBM3, 700.00 W)
RUN_E_MS = {"mul16u_trunc0_8": 50.00, "mul16u_drum2_14": 61.45, "mul16s_trunc0_8": 57.26,
            "mul16s_bam_v4_h1": 121.69, "mul16s_drum5_8": 65.14, "mul16s_mitch10_13": 65.97,
            "mul16s_trunc4_4": 57.62}
TIMED_SWEEPS = MULTS_16 + ["mul12u_drum4_6"]


def sweep_full_size(dev, card: str, clock_mhz: float):
    """Exhaustive sweeps (Table I's 16-bit rows, N = 65536, and
    ``mul12u_drum4_6``, N = 4096): the kernel's time beside its bound, its
    earlier time and the plain version's time on 1024 seeded rows (every
    row at N = 4096), which the kernel's rows must equal; a second launch
    must give the same bits.  The bound is the larger of the integer
    operations over the int32 lanes and the float ones over the float32
    lanes (:func:`pair_ops`: N^2 pairs, and N values for the work on one
    operand), and the bytes."""
    import torch

    from repro_torch.core.multipliers import get
    from repro_torch.core.tuning import operand_values
    from repro_torch.kernels.tuning_sweep import (STAT_NAMES, SURF_NAMES, instance, pair_ops,
                                                  tuning_sweep, tuning_sweep_plain)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int32_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    fp32_rate = sms * FP32_LANES_PER_SM * clock_mhz * 1e6
    g = torch.Generator().manual_seed(13)
    rows_out = []
    for name in TIMED_SWEEPS:
        m = get(name)
        vals = torch.from_numpy(operand_values(m.bits, m.signed)).to(dev)
        n = vals.numel()
        out = {}
        ms = cuda_ms(lambda: out.update(s=tuning_sweep(m, vals)), iters=1)
        again = tuning_sweep(m, vals)
        for surf, st in itertools.product(SURF_NAMES, STAT_NAMES):
            if not torch.equal(out["s"][surf][st], again[surf][st]):
                fail(f"tuning_sweep {name}: two launches differ in {surf}.{st}")
        rows = None if n <= 4096 else torch.randperm(n, generator=g)[:1024].to(dev)
        n_rows = n if rows is None else rows.numel()
        plain = {}
        plain_ms = cuda_ms(lambda: plain.update(s=tuning_sweep_plain(m, vals, rows=rows)),
                           iters=1)
        err, rel = sweep_compare(out["s"], plain["s"], f"{name} N={n} ({n_rows} rows)", rows)
        ints, floats, operand = pair_ops(m)
        t_int = (n * n * ints + n * operand) / int32_rate * 1e3
        t_float = n * n * floats / fp32_rate * 1e3
        t_ops = max(t_int, t_float)
        t_bytes = (4 * n + 72 * n) / HBM_BYTES_PER_S * 1e3
        inst = instance(m)
        row = dict(mult=name, N=n, ms=ms, instance=inst,
                   plain_ms=plain_ms, plain_rows=n_rows,
                   bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes
                   else "bytes", bound_int_ms=t_int, bound_float_ms=t_float,
                   pair_int_ops=ints, pair_float_ops=floats, operand_int_ops=operand,
                   max_abs_err=err, max_rel_err_f32=rel)
        rows_out.append(row)
        run_e = f"{RUN_E_MS[name]:.2f} ms" if name in RUN_E_MS else "not measured"
        print(f"tuning_sweep {name} exhaustive N={n} ({n * n} pairs) [{inst}]: {ms:.2f} ms "
              f"(run E: {run_e}); bound {row['bound_ms']:.2f} ms ({row['bound_by']}: {ints} "
              f"integer ops per pair + {operand} per value over int32 lanes, {t_int:.2f} ms; "
              f"{floats} float ops per pair over float32 lanes, {t_float:.2f} ms); "
              f"kernel/bound {ms / row['bound_ms']:.2f}; plain {plain_ms:.2f} ms on {n_rows} "
              f"rows (integer stats max |diff| {err}, sums within {rel:.3g}); two launches "
              f"identical; library: none [{card}]", flush=True)
    return rows_out


def _same_result(card_res, cpu_res, label: str):
    """Integer fields of NoSwap, oracle and every config, and best("mae")."""
    pairs = [(card_res.noswap, cpu_res.noswap), (card_res.oracle, cpu_res.oracle)]
    pairs += [(s, cpu_res.per_config[c]) for c, s in card_res.per_config.items()]
    for x, y in pairs:
        if (x.n, x.sum_abs, x.max_abs, x.count_neq) != (y.n, y.sum_abs, y.max_abs, y.count_neq):
            fail(f"component_sweep card != CPU for {label}")
    if card_res.best("mae") != cpu_res.best("mae"):
        fail(f"best('mae') card {card_res.best('mae')} != CPU {cpu_res.best('mae')}: {label}")


def tune_table(dev, card: str, profile: bool = False):
    """Phase 7: Table I through the kernel.  Returns (rows, launches)."""
    from repro_torch.core.multipliers import get
    from repro_torch.core.tuning import component_sweep
    from repro_torch.kernels.tuning_sweep import LAUNCHES, reset_launches

    reset_launches()
    rows, on_card = [], {}
    t_all = time.perf_counter()
    for name in MULTS_8 + MULTS_12 + MULTS_16:
        m = get(name)
        t0 = time.perf_counter()
        res = component_sweep(m, device=dev)
        dt = time.perf_counter() - t0
        on_card[name] = res
        rows.append(dict(mult=name, bits=m.bits, commutative=m.commutative,
                         original=res.noswap.mae, swapper_reduction=res.reduction("mae"),
                         theoretical_reduction=res.theoretical_reduction("mae"),
                         best_cfg=res.best("mae").short(), exhaustive=True, seconds=dt))
    extra = get("mul16s_drum5_8")
    sampled = component_sweep(extra, sample_bits=10, device=dev)
    total = time.perf_counter() - t_all
    launches = LAUNCHES["tuning_sweep"]
    if launches != len(rows) + 1:
        fail(f"tuning_sweep launches in Table I: {launches}, expected {len(rows) + 1}")
    print(f"Table I (MAE) on the card, every row exhaustive (16 bits: N = 65536, 2^32 pairs; "
          f"the JAX table samples 2^10): {len(rows) + 1} sweeps, {launches} tuning_sweep "
          f"launches, {total:.2f} s [{card}]", flush=True)
    print(f"  {'multiplier':20s} {'orig MAE':>14s} {'SWAPPER':>9s} {'Theor.':>9s}  "
          f"{'best':10s} {'s':>7s}", flush=True)
    for r in rows:
        print(f"  {r['mult']:20s} {r['original']:14.4f} {100 * r['swapper_reduction']:8.2f}% "
              f"{100 * r['theoretical_reduction']:8.2f}%  {r['best_cfg']:10s} "
              f"{r['seconds']:7.3f}", flush=True)
    for name in MULTS_8:
        _same_result(on_card[name], component_sweep(get(name), device="cpu"), name)
    _same_result(sampled, component_sweep(extra, sample_bits=10, device="cpu"),
                 "mul16s_drum5_8 sample_bits=10")
    print(f"Table I card == CPU (integer fields of NoSwap, oracle and all 4M configs; "
          f"best MAE config) on the {len(MULTS_8)} 8-bit rows and mul16s_drum5_8 at "
          f"sample_bits=10", flush=True)
    err = hold_sweeps(dev, [(get(name), None) for name in MULTS_8 + MULTS_12 + MULTS_16]
                      + [(extra, 10)], "Table I")
    print(f"Table I sweeps == plain: {err[2]} sweeps through tuning_sweep (N = 256 and "
          f"4096 every row, N = 65536 on 1024 seeded rows, N = 1024 every row): integer "
          f"stats max |diff| {err[0]}, sums max relative diff {err[1]:.3g}", flush=True)
    print(f"Table I {total:.3f} s: the {err[2]} sweep launches again {err[3] / 1e3:.3f} s "
          f"(CUDA events around each wrapper call), the rest {total - err[3] / 1e3:.3f} s "
          f"(operand sets, copies, host scoring) [{card}]", flush=True)
    if profile:
        profile_serve(lambda: component_sweep(extra, device=dev),
                      "Table I row (mul16s_drum5_8, exhaustive)", card)
    return rows, launches, err


def app_rows(dev):
    """One run of the Tables II/III default set on ``dev``."""
    from repro_torch import apps as A
    from repro_torch.core.multipliers import get
    from repro_torch.core.tuning import component_sweep

    comp_best = {m: component_sweep(get(m), sample_bits=9, device=dev).best("mae")
                 for m in APP_MULTS}
    rows = []
    for app_name in sorted(A.ALL_APPS):
        app = A.ALL_APPS[app_name]
        n = APP_N[app.metric_name]
        v_fp, _ = A.evaluate(app, "fp", n=n, seed=TEST_SEED, device=dev)
        v_fxp, _ = A.evaluate(app, "fxp", n=n, seed=TEST_SEED, device=dev)
        for mname in APP_MULTS:
            mult = get(mname)
            ev = lambda mode: A.evaluate(app, mode, mult=mult, n=n, seed=TEST_SEED,  # noqa: E731
                                         device=dev)[0]
            cfg_app, _, _ = A.tune_app(app, mult, n=n, seed=TRAIN_SEED, device=dev)
            rows.append(dict(app=app_name, metric=app.metric_name, mult=mname, original=v_fp,
                             fxp=v_fxp, noswap=ev(None), swapper_comp=ev(comp_best[mname]),
                             swapper_app=ev(cfg_app), theoretical=ev("oracle"),
                             comp_cfg=comp_best[mname].short(),
                             app_cfg=cfg_app.short() if cfg_app else "NoSwap"))
    return rows


def app_table(dev, card: str, profile: bool = False):
    """Phase 8: Tables II/III on the card, twice, and sobel card vs CPU."""
    import math

    import torch

    from repro_torch import apps as A
    from repro_torch.core.multipliers import get
    from repro_torch.kernels.tuning_sweep import LAUNCHES, reset_launches

    runs, secs = [], []
    for _ in range(2):
        reset_launches()
        t0 = time.perf_counter()
        runs.append(app_rows(dev))
        secs.append(time.perf_counter() - t0)
        if LAUNCHES["tuning_sweep"] != len(APP_MULTS):
            fail(f"tuning_sweep launches in one app table run: {LAUNCHES['tuning_sweep']}, "
                 f"expected {len(APP_MULTS)}")
    keys = ("original", "fxp", "noswap", "swapper_comp", "swapper_app", "theoretical")
    for r in runs[0]:
        if not all(math.isfinite(r[k]) for k in keys):
            fail(f"app row not finite: {r}")
    if runs[0] != runs[1]:
        fail("the app table differs between two runs on the card")
    print(f"Tables II/III (MD_LO, n {APP_N}) on the card: {len(runs[0])} rows, finite and "
          f"identical over two runs; {len(APP_MULTS)} tuning_sweep launches each; "
          f"{secs[0]:.1f} s / {secs[1]:.1f} s [{card}]", flush=True)
    err = hold_sweeps(dev, [(get(m), 9) for m in APP_MULTS], "apps comp-best")
    print(f"apps comp-best sweeps == plain: {err[2]} sweeps at N = 512, every row: integer "
          f"stats max |diff| {err[0]}, sums max relative diff {err[1]:.3g}", flush=True)
    print(f"  {'app':12s} {'mult':18s} {'orig':>8s} {'FxP':>8s} {'NoSwap':>8s} {'Comp.':>8s} "
          f"{'App.':>8s} {'Theor.':>8s}  comp-cfg / app-cfg", flush=True)
    for r in runs[0]:
        print(f"  {r['app']:12s} {r['mult']:18s} {r['original']:8.4f} {r['fxp']:8.4f} "
              f"{r['noswap']:8.4f} {r['swapper_comp']:8.4f} {r['swapper_app']:8.4f} "
              f"{r['theoretical']:8.4f}  {r['comp_cfg']} / {r['app_cfg']} ({r['metric']})",
              flush=True)
    # sobel on the card and on the CPU: the same Q16.16 outputs; the SSIM
    # means are float32 reductions in another order
    app, mult = A.ALL_APPS["sobel"], get(APP_MULTS[0])
    vg, og = A.evaluate(app, None, mult=mult, n=48, seed=TEST_SEED, device=dev)
    vc, oc = A.evaluate(app, None, mult=mult, n=48, seed=TEST_SEED, device="cpu")
    if not torch.equal(og.cpu(), oc) or not abs(vg - vc) <= 1e-6 * abs(vc):
        fail(f"sobel card vs CPU: outputs equal {torch.equal(og.cpu(), oc)}, SSIM {vg} vs {vc}")
    print(f"sobel (n=48, {APP_MULTS[0]}, NoSwap) card == CPU: outputs torch.equal, SSIM "
          f"{vg:.9f} vs {vc:.9f} (tol 1e-6 relative)", flush=True)
    if profile:
        app = A.ALL_APPS["blackscholes"]
        profile_serve(lambda: A.evaluate(app, None, mult=mult, n=APP_N[app.metric_name],
                                         seed=TEST_SEED, device=dev),
                      f"app run (blackscholes, {mult.name}, NoSwap)", card)
    return runs[0], secs, err


# ---------------------------------------------------------------------------
# phase 4: reduced model, card against CPU
# ---------------------------------------------------------------------------

# the reduced configs held card vs CPU (f32; seeded weights made on the CPU
# and copied to the card): name -> (layers, prompt tokens, max |logit diff|,
# mean |logit diff|).  Logits of order 1 agree to ~1e-6 unless a last-bit
# difference sits on an int8 rounding boundary and a code flips, which
# attention carries to later tokens: qwen2 at 2 layers and 8 tokens moves
# by ~1e-2 at most; in the families a flip moved gemma3 (7 layers: one 5:1
# period and a rest layer; 70 tokens, so the reduced ring of 64 wraps),
# starcoder2 and qwen1.5 by 0.10-0.19 (PERF.md section 6), within the
# bounds of the port-vs-JAX comparison with a flip (tests/test_torch_families.py)
# whisper-base met no int8 code flip card vs CPU (2.98e-7 in the logits), so
# it takes qwen2's bound rather than the flip bound of the families
REF_CONFIGS = {"qwen2-72b": (2, 8, 5e-2, None), "gemma3-27b": (7, 70, 0.4, 0.05),
               "whisper-base": (None, 16, 5e-2, None)}
REF_DEFAULT = (None, 16, 0.4, 0.05)
MOE_NEAR_TIE = 1e-3      # a routing flip is allowed only below this probability gap


def _route_recorder():
    """Wrap ``blocks._route`` so that each call's top-k and probabilities
    are kept (the card-vs-CPU MoE routing comparison)."""
    from repro_torch.models import blocks

    real, seen = blocks._route, []

    def rec(flat, w, k):
        out = real(flat, w, k)
        seen.append((out[0].detach().float().cpu(), out[2].cpu()))
        return out

    return real, rec, seen


def card_vs_cpu(name: str, dev):
    """One reduced config (``REF_CONFIGS``) card vs CPU: prefill logits
    within its bounds, greedy tokens equal unless the CPU run's top-2
    margin is below its max bound, MoE routing flips counted, each allowed
    only on a near-tie.  Returns ((max |logit diff|, tokens equal,
    routing flips), (cfg, params on the CPU and on the card, prompt))."""
    import torch

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import AxPolicy
    from repro_torch.models import blocks, init_params, prefill
    from repro_torch.serve import ServeConfig, generate

    layers, S_, tol, tol_mean = REF_CONFIGS.get(name, REF_DEFAULT)
    kw = {"n_layers": layers} if layers else {}
    cfg = dataclasses.replace(reduced(ARCHS[name]), compute_dtype="float32",
                              ax=AxPolicy(backend="kernel"), **kw)
    p_cpu = init_params(cfg, seed=3, device="cpu")
    p_gpu = _to_device(p_cpu, dev)
    prompt = family_prompt(cfg, 2, S_, "cpu", seed=4)
    real, rec, seen = _route_recorder()
    blocks._route = rec
    try:
        with torch.inference_mode():
            lc, _ = prefill(p_cpu, prompt, cfg, max_cache_len=S_ + 8)
            n_cpu = len(seen)
            lg, _ = prefill(p_gpu, {k: v.to(dev) for k, v in prompt.items()}, cfg,
                            max_cache_len=S_ + 8)
    finally:
        blocks._route = real
    flips = _route_flips(cfg, seen[:n_cpu], seen[n_cpu:], f"{name} (reduced)")
    diff = (lc - lg.cpu()).abs()
    err, mean = diff.max().item(), diff.mean().item()
    if not (err <= tol and (tol_mean is None or mean <= tol_mean)):
        fail(f"reduced {name} (f32) prefill logits card vs CPU: max |diff| {err} "
             f"(tol {tol}), mean {mean} (tol {tol_mean})")
    tc = generate(p_cpu, prompt, cfg, ServeConfig(max_new_tokens=6))
    tg = generate(p_gpu, prompt, cfg, ServeConfig(max_new_tokens=6)).cpu()
    equal = bool(torch.equal(tc, tg))
    if not equal:
        # the CPU run's margins along its own tokens decide what may differ
        if "tokens" not in prompt:
            fail(f"{name}: card and CPU tokens differ:\n{tg}\n{tc}")
        seq = torch.cat([prompt["tokens"], tc[:, :-1].to(torch.int64)], 1)
        with torch.inference_mode():
            lm, _ = prefill(p_cpu, dict(prompt, tokens=seq), cfg, max_cache_len=seq.shape[1] + 1)
        top2 = torch.sort(lm[:, S_ - 1:].float(), dim=-1).values[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        for b_ in range(tc.shape[0]):
            d = (tc[b_] != tg[b_]).nonzero().flatten()
            if len(d) and margin[b_, d[0]] > tol:
                fail(f"{name}: card token {d[0].item()} of row {b_} differs from the CPU's "
                     f"at a top-2 margin {margin[b_, d[0]].item()} > {tol}")
    print(f"reduced {name} ({cfg.n_layers} layers, f32, {S_} tokens) card vs CPU: prefill "
          f"logits max |diff| {err:.3g} (tol {tol}), mean {mean:.3g} (tol {tol_mean}); "
          f"greedy tokens equal: {equal}; MoE routing flips {flips}", flush=True)
    return (err, equal, flips), (cfg, p_cpu, p_gpu, prompt)


def reference_check(dev):
    """Phase 4: every reduced config of ``ARCHS`` card vs CPU
    (``card_vs_cpu``), then reduced qwen2's adaptive serve.  Returns
    {name: (max |logit diff|, tokens equal, MoE routing flips)}."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import drift_hook
    from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy
    from repro_torch.serve import ServeConfig, generate

    checks = {}
    for name in ARCHS:
        checks[name], model = card_vs_cpu(name, dev)
        if name == "qwen2-72b":
            cfg, p_cpu, p_gpu, prompt = model
    toks = prompt["tokens"]
    # adaptive, tile mode, with drift: the re-tunes are exact integer
    # decisions, so card and CPU must make the same ones
    runs = []
    for params, d in ((p_cpu, "cpu"), (p_gpu, dev)):
        ctrl = AdaptiveController(SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                  AdaptiveConfig(min_observe_steps=2, cooldown_steps=2,
                                                 drift_threshold=0.02, tile_rows=2), device=d)
        out = generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=12),
                       adaptive=ctrl, param_hook=drift_hook(3, 0.05)).cpu()
        runs.append((out, [e.describe() for e in ctrl.retunes + ctrl.tile_retunes]))
    (tc, ec), (tg, eg) = runs
    if not ec or ec != eg:
        fail(f"reduced qwen2 adaptive re-tunes, card vs CPU:\n{eg}\n{ec}")
    print(f"reduced qwen2 adaptive (tile mode, drift) card vs CPU: {len(ec)} re-tunes "
          f"equal; greedy tokens equal: {bool(torch.equal(tc, tg))}", flush=True)
    return checks


# ---------------------------------------------------------------------------
# phase 5: the full-width serve
# ---------------------------------------------------------------------------

B, S, T, L = 4, 32, 8, 2          # the serve: prompts, prompt length, tokens, layers
T_DRIFT, DRIFT_AT, DRIFT_SCALE = 12, 3, 0.05


def weight_work(params, cfg, card: str):
    """The per-forward weight work that the weight cache removes, timed
    with CUDA events on the serve's weights: what each forward did before
    the cache (per ax weight ``w.to(bf16)``, ``.to(f32)``, then
    ``quantize_rows``: abs, amax, divide, round, clamp, int8 cast; per other
    weight, the lm_head included, ``w.to(bf16)``), against the bytes those
    passes must move: 53 bytes per ax weight element (f32->bf16 6, bf16->f32
    6, abs 8, amax 4, divide 8, round 8, clamp 8, int8 cast 5) and 6 per
    cast element, at the memory rate.  Then the bytes one cached decode
    step reads from the weights (int8 codes, bf16 casts) and their time at
    the memory rate: the floor of a decode step."""
    import torch

    from repro_torch.quant.ax import quantize_rows

    bf16 = torch.bfloat16
    ax_ws = [lp[m][n]["w"] for lp in params["layers"]
             for m, n in (("attn", "o"), ("mlp", "in"), ("mlp", "gate"), ("mlp", "out"))]
    casts = [lp["attn"][n]["w"] for lp in params["layers"] for n in "qkv"]
    casts.append(params["lm_head"]["w"])

    def uncached():
        for w in ax_ws:
            quantize_rows(w.to(bf16).to(torch.float32), axis=0)
        for w in casts:
            w.to(bf16)

    with torch.inference_mode():
        ms = cuda_ms(uncached, iters=3)
    n_ax = sum(w.numel() for w in ax_ws)
    n_cast = sum(w.numel() for w in casts)
    gb = (53 * n_ax + 6 * n_cast) / 1e9
    bound = gb * 1e9 / HBM_BYTES_PER_S * 1e3
    step_gb = (n_ax + 2 * n_cast) / 1e9
    print(f"weight work per forward without the cache: {ms:.2f} ms (CUDA events); "
          f"{gb:.2f} GB moved, {bound:.2f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
          f"({gb / ms:.3f} TB/s achieved); a cached decode step reads "
          f"{step_gb:.3f} GB of weights ({n_ax / 1e9:.3f} G int8 codes, "
          f"{n_cast / 1e9:.3f} G bf16): {step_gb * 1e9 / HBM_BYTES_PER_S * 1e3:.3f} ms "
          f"at the memory rate [{card}]", flush=True)
    return dict(ms=ms, gb=gb, bound_ms=bound, step_gb=step_gb)


def serve(dev, card: str, profile: bool = False):
    """Phase 5: the static serve, ``kernel`` and ``mxu`` backends.  Returns
    (cfg, params, prompts, tokens, launches, stats)."""
    import torch

    from repro_torch.configs import qwen2_72b
    from repro_torch.configs.base import AxPolicy
    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.models import init_params, prefill
    from repro_torch.serve import ServeConfig, generate

    cfg = dataclasses.replace(qwen2_72b, n_layers=L, ax=AxPolicy(backend="kernel"))
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"qwen2-72b x{L} layers: {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} G "
          f"params (f32) initialised on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    weight_work(params, cfg, card)
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, _ = prefill(params, {"tokens": prompts.to(dev)}, cfg,
                            max_cache_len=S + T + 1)
        torch.cuda.synchronize()
    print(f"first prefill (the weight cache built: each weight cast and quantized "
          f"once): {(time.perf_counter() - t0) * 1e3:.1f} ms [{card}]", flush=True)
    if tuple(logits.shape) != (B, S, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    del logits

    expect = L * 4 * T
    eager = ServeConfig(max_new_tokens=T, cuda_graphs=False)
    runs = []
    for _ in range(2):
        stats = {}
        reset_launches()
        toks = generate(params, {"tokens": prompts}, cfg, eager, stats=stats)
        launches = dict(LAUNCHES)
        if launches != {"ax_matmul": expect, "ax_matmul_grid": 0}:
            fail(f"launches in one static serve: {launches}, expected {expect} ax_matmul")
        runs.append((toks.cpu(), stats))
    (t1, _), (t2, stats) = runs
    if not torch.equal(t1, t2):
        fail(f"greedy tokens differ between two runs:\n{t1}\n{t2}")
    if tuple(t1.shape) != (B, T) or int(t1.min()) < 0 or int(t1.max()) >= cfg.vocab:
        fail(f"tokens out of range or misshapen: {tuple(t1.shape)}")
    print(f"serve qwen2-72b (2 layers, kernel backend, eager) B={B} S={S} new={T}: tokens "
          f"deterministic over 2 runs; ax_matmul launches {expect} (= {L}x4x{T}); "
          f"{_speed(stats, T)} [{card}]", flush=True)
    print(f"tokens: {t1.tolist()}", flush=True)
    if profile:
        profile_serve(lambda: generate(params, {"tokens": prompts}, cfg, eager),
                      "static serve (eager)", card)

    # the default backend: mxu launches route T of the same kernel
    cfg_m = dataclasses.replace(cfg, ax=AxPolicy(backend="mxu"))
    stats_m = {}
    reset_launches()
    toks_m = generate(params, {"tokens": prompts}, cfg_m, eager, stats=stats_m).cpu()
    launches_m = dict(LAUNCHES)
    if launches_m != launches or not torch.equal(toks_m, t1):
        fail(f"mxu serve: launches {launches_m} (kernel serve {launches}), tokens equal "
             f"{torch.equal(toks_m, t1)}")
    print(f"serve, mxu backend (route T, eager): tokens and launches {launches_m} equal "
          f"the kernel serve's; {_speed(stats_m, T)} [{card}]", flush=True)

    # the decode step as a CUDA graph: the eager tokens, the launches of an
    # eager serve, one capture, then replays only
    paths = {"static eager": expect, "mxu eager": launches_m["ax_matmul"]}
    for label, c in (("kernel", cfg), ("mxu", cfg_m)):
        for run in range(2):
            got, stats_g, executed, caps = graph_run(
                lambda st: generate(params, {"tokens": prompts}, c,
                                    ServeConfig(max_new_tokens=T), stats=st))
            want_caps = 1 if run == 0 else 0
            if stats_g["path"] != "graph" or executed != {"ax_matmul": expect,
                                                          "ax_matmul_grid": 0} \
                    or caps != want_caps or not torch.equal(got.cpu(), t1):
                fail(f"graph serve ({label}, run {run}): path {stats_g['path']}, executed "
                     f"launches {executed}, captures {caps} (want {want_caps}), tokens "
                     f"equal {torch.equal(got.cpu(), t1)}")
        paths[f"{'static' if label == 'kernel' else 'mxu'} graph"] = executed["ax_matmul"]
        print(f"serve, {label} backend, decode step as a CUDA graph: tokens equal the eager "
              f"serve's; executed launches {executed} (= {L}x4x{T}); captures: 1, then 0 "
              f"on the second run; {_speed(stats_g, T)} (eager: "
              f"{_speed(stats if label == 'kernel' else stats_m, T)}) [{card}]", flush=True)
    if profile:
        profile_serve(lambda: generate(params, {"tokens": prompts}, cfg,
                                       ServeConfig(max_new_tokens=T)),
                      "static serve (graph)", card)
    return cfg, params, prompts, t1, paths, stats


# ---------------------------------------------------------------------------
# phase 5b: the kernel-schedule autotuner
# ---------------------------------------------------------------------------

AT_OPS = ("matmul", "matmul_grid", "int_static", "int_dyn")


def autotune_phase(dev, card: str, cfg, params, prompts, tokens):
    """Phase 5b: ``kernels.autotune.tune_table`` (quick) over the serve's
    three projection shapes at B decode rows and B x S prefill rows, for
    ``matmul``/``matmul_grid`` (``kernel``) and ``int_static``/``int_dyn``
    (``mxu``), each candidate timed as a CUDA graph of back-to-back
    dispatches; every candidate's output and ``tile_hist`` held to the plain
    version; no nvcc run in the sweep or the install; the table published to
    a temporary ``ScheduleStore`` and adopted by a ``ScheduleReader``; the
    serve phase's graph serve after the adoption: its tokens, no capture,
    table hits from the eager prefill.  Returns the per-signature rows."""
    import tempfile

    import torch

    from repro_torch import obs
    from repro_torch.configs.base import AxPolicy
    from repro_torch.core.multipliers import get
    from repro_torch.kernels import _build, autotune as TA, clear_table, installed_table, ops
    from repro_torch.kernels.ax_matmul import route_of
    from repro_torch.kernels.ref import ax_matmul_ref, tile_hist_blocks
    from repro_torch.serve import ServeConfig, generate
    from repro_torch.serve import graph as G

    t_phase = time.perf_counter()
    runs = _build.NVCC_RUNS["count"]
    name = cfg.ax.mult_name
    mult = get(name)
    swap = AxPolicy(mult_name=name).swap          # the swap of TA.dispatch_fn
    d, ff = cfg.d_model, cfg.d_ff
    shapes = sorted({s for m in (B, B * S) for s in ((m, d, d), (m, d, ff), (m, ff, d))})
    t0 = time.perf_counter()
    table, reports = TA.tune_table(shapes, name, backends=("kernel", "mxu"), quick=True,
                                   device=dev)
    tune_s = time.perf_counter() - t0
    if _build.NVCC_RUNS["count"] != runs:
        fail(f"autotune: the sweep ran nvcc {_build.NVCC_RUNS['count'] - runs} time(s)")
    by_sig = {r["sig"]: r for r in reports}
    rows = []
    for r in reports:
        rows.append({k: r[k] for k in ("sig", "winner", "best_us", "default_us", "candidates",
                                       "route", "timer")})
        print(f"autotune {r['sig']}: winner {r['winner']} {r['best_us']:.2f} us, default "
              f"{r['default_us']:.2f} us (winner/default {r['best_us'] / r['default_us']:.3f}; "
              f"{r['candidates']} candidates, {r['timer']}) [{card}]", flush=True)

    # every candidate against the plain version, on operands of its own
    t0 = time.perf_counter()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(23)
    checked = 0
    for M, K, N in shapes:
        a = torch.randint(-128, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-128, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        cols = torch.arange(N, device=dev) if M <= B else \
            torch.cat([torch.arange(128, device=dev), torch.arange(N - 128, N, device=dev)])
        want = ax_matmul_ref(a, b.index_select(1, cols).contiguous(), mult, swap)
        hist_want = {}
        grid = torch.tensor([1, swap.bit, swap.value], dtype=torch.int32, device=dev)
        for op in AT_OPS:
            backend = "kernel" if op.startswith("matmul") else "mxu"
            route = "T" if backend == "mxu" else route_of(mult, torch.int8)
            cands = TA.candidate_schedules(backend, M, K, N, op=op, quick=True, route=route,
                                           sms=sms)
            if len(cands) != by_sig[f"{M}x{K}x{N}/{backend}/{name}/{op}"]["candidates"]:
                fail(f"autotune: {op} at {(M, K, N)} checks {len(cands)} candidates, the "
                     f"sweep timed a different set")
            first = None
            for s in cands:
                got = TA.dispatch_fn(op, a, b, name, s)()
                bm, bn = min(s.bm, M), min(s.bn, N)
                if op in TA.STATIC_OPS:
                    _, hist = ops.ax_matmul(a, b, mult, swap, schedule=s, tile_hist=True)
                else:
                    g = grid.expand(-(-M // bm), -(-N // bn), 3).contiguous()
                    _, hist = ops.ax_matmul_grid(a, b, mult, g, schedule=s, tile_hist=True)
                if (bm, bn) not in hist_want:
                    hist_want[bm, bn] = tile_hist_blocks(a, b, mult.bits, bm, bn)
                first = got if first is None else first
                err = (got.index_select(1, cols).long() - want.long()).abs().max().item()
                if err != 0 or not torch.equal(got, first) or \
                        not torch.equal(hist, hist_want[bm, bn]):
                    fail(f"autotune candidate {s.short()} ({op}, {(M, K, N)}) != plain: max "
                         f"|diff| {err}, equal to the default's output "
                         f"{torch.equal(got, first)}, tile_hist equal "
                         f"{torch.equal(hist, hist_want[bm, bn])}")
                checked += 1
        del a, b, want, hist_want
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0

    # publish, adopt, and serve the graph captured before the install
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sched_") as root:
        store = TA.ScheduleStore(root)
        version = store.publish(table)
        reader = TA.ScheduleReader(store, name="chip_smoke")
        if reader.version != version or installed_table() is not reader.table:
            fail(f"autotune: the reader adopted v{reader.version} of v{version}")
        caps_before = dict(G.CAPTURES)
        hits = obs.default_registry().get("repro_sched_lookups_total").value(result="hit")
        got, stats_g, executed, caps = graph_run(
            lambda st: generate(params, {"tokens": prompts}, cfg,
                                ServeConfig(max_new_tokens=T), stats=st))
        hits = obs.default_registry().get("repro_sched_lookups_total").value(
            result="hit") - hits
    clear_table()
    if not torch.equal(got.cpu(), tokens) or caps != 0 or dict(G.CAPTURES) != caps_before \
            or hits <= 0 or stats_g["path"] != "graph" \
            or executed != {"ax_matmul": L * 4 * T, "ax_matmul_grid": 0}:
        fail(f"autotune: graph serve after the adoption: tokens equal "
             f"{torch.equal(got.cpu(), tokens)}, captures {caps}, the earlier program's "
             f"captures unchanged {dict(G.CAPTURES) == caps_before}, table hits {hits}, "
             f"path {stats_g['path']}, executed {executed}")
    if _build.NVCC_RUNS["count"] != runs:
        fail(f"autotune: nvcc ran {_build.NVCC_RUNS['count'] - runs} time(s) by the install")
    wins = sum(r["best_us"] < r["default_us"] for r in reports)
    print(f"autotune: {len(reports)} signatures tuned in {tune_s:.1f} s, {checked} candidates "
          f"== plain (outputs and tile_hist, max |diff| 0) in {check_s:.1f} s; nvcc runs 0; "
          f"published v{version}, adopted by a reader; graph serve after the adoption: the "
          f"tokens of before, 0 captures ({sum(caps_before.values())} programs' captures "
          f"unchanged), {hits:.0f} table hits (eager prefill), executed {executed}; "
          f"{wins} winners other than the default; phase {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return rows


def graph_run(run):
    """``run(stats)`` with the graph counters read around it: returns (its
    result, stats, the kernel launches it executed, the graphs it
    captured)."""
    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.serve import graph as G

    stats = {}
    before = G.counts()
    reset_launches()
    out = run(stats)
    executed = G.executed_launches(before, dict(LAUNCHES))
    caps = sum(G.CAPTURES.values()) - sum(before[0].values())
    return out, stats, executed, caps


def _speed(stats, steps: int) -> str:
    wall = stats["prefill_s"] + stats["decode_s"]
    return (f"prefill {stats['prefill_s'] * 1e3:.1f} ms; decode "
            f"{stats['decode_s'] * 1e3 / (steps - 1):.1f} ms/step; "
            f"{B * steps / wall:.2f} tokens/s")


def adaptive_serve(cfg, params, prompts, static_tokens, static_stats, card: str,
                   profile: bool = False):
    """Phase 6: adaptive serving of the same model.  Returns the
    ax_matmul_grid launches of each path."""
    import torch

    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.core.swapper import SwapConfig
    from repro_torch.launch.serve import drift_hook
    from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy
    from repro_torch.serve import ServeConfig, generate

    def controller(**kw):
        return AdaptiveController(SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                  AdaptiveConfig(**kw), device=params["embed"]["w"].device)

    # a threshold that never fires: the dynamic path must give the static bits
    ctrl = controller(drift_threshold=1e9)
    ctrl.warmup()
    stats = {}
    reset_launches()
    eager = ServeConfig(max_new_tokens=T, cuda_graphs=False)
    toks = generate(params, {"tokens": prompts}, cfg, eager, adaptive=ctrl, stats=stats).cpu()
    launches = dict(LAUNCHES)
    want = {"ax_matmul": L * 4, "ax_matmul_grid": L * 4 * (T - 1)}
    if launches != want:
        fail(f"launches in the no-drift adaptive serve: {launches}, expected {want}")
    if not torch.equal(toks, static_tokens) or ctrl.retunes or ctrl.step != T - 1:
        fail(f"no-drift adaptive serve: tokens equal {torch.equal(toks, static_tokens)}, "
             f"re-tunes {len(ctrl.retunes)}, observed steps {ctrl.step}")
    print(f"adaptive serve, no drift (scalar mode, eager): tokens equal the static serve's; "
          f"launches {launches}; {_speed(stats, T)} (static: {_speed(static_stats, T)}) "
          f"[{card}]", flush=True)
    grid_paths = {"no-drift eager": launches["ax_matmul_grid"]}

    # the fused adaptive decode as CUDA graphs (an observed step per token):
    # the static tokens, the eager launches, one capture, then a policy
    # update that re-captures nothing
    for run in range(2):
        ctrl = controller(drift_threshold=1e9)
        toks, stats_g, executed, caps = graph_run(lambda st: generate(
            params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=T), adaptive=ctrl,
            stats=st).cpu())
        if stats_g["path"] != "graph" or executed != want or caps != (1 if run == 0 else 0) \
                or not torch.equal(toks, static_tokens) or ctrl.step != T - 1:
            fail(f"no-drift adaptive graph serve (run {run}): path {stats_g['path']}, "
                 f"executed launches {executed}, captures {caps}, tokens equal "
                 f"{torch.equal(toks, static_tokens)}, observed steps {ctrl.step}")
    grid_paths["no-drift graph"] = executed["ax_matmul_grid"]
    print(f"adaptive serve, no drift, CUDA graphs: tokens equal the static serve's; "
          f"executed launches {executed}; captures 1, then 0; {_speed(stats_g, T)} [{card}]",
          flush=True)
    ctrl.policy.set_config("mlp", SwapConfig("B", 5, 1))
    ctrl.policy.set_config("attn_out", SwapConfig("A", 6, 1))
    toks_p, stats_p, executed, caps = graph_run(lambda st: generate(
        params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=T), adaptive=ctrl,
        stats=st).cpu())
    ctrl_e = controller(drift_threshold=1e9)
    ctrl_e.policy.set_config("mlp", SwapConfig("B", 5, 1))
    ctrl_e.policy.set_config("attn_out", SwapConfig("A", 6, 1))
    toks_e = generate(params, {"tokens": prompts}, cfg, eager, adaptive=ctrl_e).cpu()
    if caps != 0 or not torch.equal(toks_p, toks_e):
        fail(f"graph serve after a policy update: captures {caps}, tokens equal the eager "
             f"serve's under the same policy {torch.equal(toks_p, toks_e)}")
    print(f"adaptive serve after set_policy (mlp B[5]==1, attn_out A[6]==1), CUDA graphs: "
          f"no re-capture; tokens equal the eager serve's under that policy (differ from "
          f"the default policy's: {not torch.equal(toks_p, static_tokens)}) [{card}]",
          flush=True)
    # tile mode (2 row tiles, the default triple in every tile): its own
    # program, the static tokens
    for run in range(2):
        ctrl = controller(drift_threshold=1e9, tile_rows=2)
        toks_t, stats_t, executed, caps = graph_run(lambda st: generate(
            params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=T), adaptive=ctrl,
            stats=st).cpu())
        if caps != (1 if run == 0 else 0) or executed != want \
                or not torch.equal(toks_t, static_tokens):
            fail(f"tile-mode adaptive graph serve (run {run}): captures {caps}, executed "
                 f"launches {executed}, tokens equal {torch.equal(toks_t, static_tokens)}")
    grid_paths["tile-mode graph"] = executed["ax_matmul_grid"]
    print(f"adaptive serve, tile mode (tile_rows=2), CUDA graphs: tokens equal the static "
          f"serve's; executed launches {executed}; captures 1, then 0; {_speed(stats_t, T)} "
          f"[{card}]", flush=True)
    if profile:
        profile_serve(lambda: generate(
            params, {"tokens": prompts}, cfg, eager,
            adaptive=controller(drift_threshold=1e9)), "no-drift adaptive serve (eager)", card)
        profile_serve(lambda: generate(
            params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=T),
            adaptive=controller(drift_threshold=1e9)), "no-drift adaptive serve (graph)", card)

    runs = []
    for _ in range(2):
        ctrl = controller(min_observe_steps=2, cooldown_steps=4, tile_rows=2)
        ctrl.warmup()
        stats = {}
        reset_launches()
        toks = generate(params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=T_DRIFT),
                        adaptive=ctrl, param_hook=drift_hook(DRIFT_AT, DRIFT_SCALE),
                        stats=stats).cpu()
        launches = dict(LAUNCHES)
        want = {"ax_matmul": L * 4, "ax_matmul_grid": L * 4 * (T_DRIFT - 1)}
        if launches != want:
            fail(f"launches in the drift serve: {launches}, expected {want}")
        if not (ctrl.retunes or ctrl.tile_retunes):
            fail(f"the drift serve made no re-tune: {ctrl.telemetry.describe()}")
        if tuple(toks.shape) != (B, T_DRIFT) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab:
            fail(f"drift serve tokens out of range or misshapen: {tuple(toks.shape)}")
        runs.append((toks, ctrl, stats))
    (t1, c1, _), (t2, c2, stats) = runs
    events = [[e.describe() for e in c.retunes + c.tile_retunes] for c in (c1, c2)]
    if not torch.equal(t1, t2) or events[0] != events[1]:
        fail(f"the drift serve is not deterministic:\n{t1}\n{t2}\n{events}")
    print(f"adaptive serve, drift x{DRIFT_SCALE} at step {DRIFT_AT} (tile_rows=2) B={B} "
          f"S={S} new={T_DRIFT}: tokens and re-tunes deterministic over 2 runs; launches "
          f"{launches}; {_speed(stats, T_DRIFT)} [{card}]", flush=True)
    for line in c2.log:
        print(f"  [adaptive] {line}", flush=True)
    print(f"  [adaptive] {c2.policy.describe()}", flush=True)
    print(f"  [adaptive] {c2.telemetry.describe()}", flush=True)
    print(f"tokens: {t1.tolist()}", flush=True)
    if profile:
        profile_serve(lambda: generate(
            params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=T_DRIFT),
            adaptive=controller(min_observe_steps=2, cooldown_steps=4, tile_rows=2),
            param_hook=drift_hook(DRIFT_AT, DRIFT_SCALE)), "drift serve", card)
    grid_paths["drift (stepwise, eager)"] = launches["ax_matmul_grid"]
    return grid_paths


SLOT_LENS, SLOT_BUDGETS = (32, 19, 7, 26), (8, 3, 8, 5)
# The same prompt prefilled in a batch of 4 and alone differs by about 3 in
# the logits (the slot phase prints the spread): the
# GEMMs round differently at M = 128 and at M <= 32, and int8
# re-quantization turns such last-bit differences into other codes, layer
# after layer.  Alone padded and alone unpadded agree exactly, and so do a
# batch and the same batch with its slots rotated (PERF.md §6).
TOL_BATCH = 3.5


def _margin(params, cfg, seq) -> float:
    """Top-2 logit margin of the next token after ``seq`` (one prefill)."""
    import torch

    from repro_torch.models import prefill

    with torch.inference_mode():
        lg, _ = prefill(params, {"tokens": seq[None]}, cfg, max_cache_len=len(seq) + 1)
    top2 = torch.topk(lg[0, -1].float(), 2).values
    return float(top2[0] - top2[1])


def slot_serve(cfg, params, card: str):
    """Phase 6b: per-slot serving at full width.  B = 4 prompts right-padded
    to S with lengths ``SLOT_LENS`` and budgets ``SLOT_BUDGETS``, and an EOS
    taken from the eager run's own tokens so that it retires slot 2 early.
    Checks, exact: eager == graph; budgets freeze and EOS retires; the
    batch with its slots rotated gives every request the same tokens (slots
    do not leak into each other); each prompt served alone padded to S
    gives the tokens of it served alone unpadded (pad-mask prefill).
    Against each prompt served alone (batch 1): equal tokens up to a
    divergence, allowed only where the top-2 margin is below
    ``TOL_BATCH``.  Returns the graph serve's executed ax_matmul launches."""
    import numpy as np
    import torch

    from repro_torch.models import prefill
    from repro_torch.serve import ServeConfig, generate

    dev = params["embed"]["w"].device
    lens, budgets = np.asarray(SLOT_LENS), np.asarray(SLOT_BUDGETS)
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab, (int(n),), generator=g) for n in lens]
    pad = lambda p: torch.cat([p, p[-1:].expand(S - len(p))])  # noqa: E731
    batch = torch.stack([pad(p) for p in prompts])
    kw = dict(prompt_lens=lens, slot_new_tokens=budgets, max_cache_len=S + T + 1)
    eager = ServeConfig(max_new_tokens=T, cuda_graphs=False)
    base = generate(params, {"tokens": batch}, cfg, eager, **kw).cpu()
    row = base[2].tolist()
    j = next((i for i in range(2, T - 1) if row[i] not in row[:i]), None)
    if j is None:
        fail(f"per-slot serve: slot 2 repeats one token, no EOS to pick: {row}")
    eos = row[j]
    eager = dataclasses.replace(eager, eos_id=eos)
    stats_e = {}
    toks_e = generate(params, {"tokens": batch}, cfg, eager, stats=stats_e, **kw).cpu()
    if not torch.equal(toks_e[2, :j + 1], base[2, :j + 1]) or not bool((toks_e[2, j:] == eos).all()):
        fail(f"EOS {eos} did not retire slot 2 at index {j}: {toks_e[2].tolist()}")
    for b in range(B):
        n = int(budgets[b])
        if not bool((toks_e[b, n:] == toks_e[b, n - 1]).all()):
            fail(f"slot {b} did not freeze after its budget {n}: {toks_e[b].tolist()}")
    for run in range(2):
        toks_g, stats_g, executed, caps = graph_run(lambda st: generate(
            params, {"tokens": batch}, cfg, ServeConfig(max_new_tokens=T, eos_id=eos),
            stats=st, **kw).cpu())
        if not torch.equal(toks_g, toks_e) or caps != (1 if run == 0 else 0) \
                or executed != {"ax_matmul": L * 4 * T, "ax_matmul_grid": 0}:
            fail(f"per-slot graph serve (run {run}): tokens equal eager "
                 f"{torch.equal(toks_g, toks_e)}, captures {caps}, executed {executed}")
    rot = [1, 2, 3, 0]
    toks_r = generate(params, {"tokens": batch[rot]}, cfg, ServeConfig(max_new_tokens=T, eos_id=eos),
                      prompt_lens=lens[rot], slot_new_tokens=budgets[rot],
                      max_cache_len=S + T + 1).cpu()
    if not torch.equal(toks_r, toks_e[rot]):
        fail(f"rotating the slots changed a request's tokens:\n{toks_r}\n{toks_e[rot]}")
    # the spread behind TOL_BATCH: each prompt's logits in the batch against
    # the same prompt prefilled alone
    with torch.inference_mode():
        lb, _ = prefill(params, {"tokens": batch.to(dev)}, cfg, max_cache_len=S + T + 1,
                        prompt_lens=torch.as_tensor(lens, device=dev))
        spread = max((lb[b, :int(n)].float() - prefill(
            params, {"tokens": prompts[b][None].to(dev)}, cfg,
            max_cache_len=S + T + 1)[0][0].float()).abs().max().item()
            for b, n in enumerate(lens))
        del lb
    compared, margins = 0, []
    for b in range(B):
        one = dict(slot_new_tokens=[int(budgets[b])], max_cache_len=S + T + 1)
        solo = generate(params, {"tokens": prompts[b][None]}, cfg, eager,
                        prompt_lens=[int(lens[b])], **one).cpu()[0]
        solo_pad = generate(params, {"tokens": pad(prompts[b])[None]}, cfg, eager,
                            prompt_lens=[int(lens[b])], **one).cpu()[0]
        if not torch.equal(solo, solo_pad):
            fail(f"slot {b}: served alone, padded to {S} != unpadded: {solo_pad.tolist()} "
                 f"vs {solo.tolist()}")
        for t in range(int(budgets[b])):
            if int(solo[t]) != int(toks_e[b, t]):
                m = _margin(params, cfg, torch.cat([prompts[b], solo[:t].long()]).to(dev))
                margins.append((b, t, round(m, 3)))
                if m > TOL_BATCH:
                    fail(f"slot {b} token {t}: in the batch {int(toks_e[b, t])} != alone "
                         f"{int(solo[t])} with a top-2 margin {m:.3f} > {TOL_BATCH}")
                break
            compared += 1
            if int(solo[t]) == eos:
                break
    print(f"per-slot serve qwen2-72b B={B} lens {SLOT_LENS} right-padded to {S}, budgets "
          f"{SLOT_BUDGETS}, eos_id {eos} (slot 2 retires at index {j}): eager == graph "
          f"tokens; budgets freeze; rotated slots give the same tokens; each prompt alone "
          f"padded == unpadded; executed launches {executed}; captures 1, then 0; against "
          f"each prompt alone (batch 1) {compared} tokens equal before a divergence, "
          f"divergences (slot, token, margin) {margins or 'none'}, each below "
          f"{TOL_BATCH} (prefill logits in the batch vs alone: max |diff| {spread:.3f}); "
          f"eager {_speed(stats_e, T)}; graph {_speed(stats_g, T)} [{card}]",
          flush=True)
    print(f"tokens: {toks_e.tolist()}", flush=True)
    return executed["ax_matmul"]


def token_serve(cfg, params, card: str):
    """Phase 6c: the token-granular API at full width.  A trace of requests
    served by ``prefill_one`` + ``splice_slot`` + ``token_step`` over 4 slots,
    in token mode (a freed slot takes the next request at the next step) and
    in wave mode (new requests only when every slot is free, the oracle):
    the same tokens per request.  Each drain captures its step once; its
    splices re-capture nothing, its steps run with no host synchronise
    (``no_sync`` around each ``token_step``), and a slot that is not active
    in a step keeps its cache rows byte-identical.  Returns the token
    drain's executed ax_matmul launches."""
    import numpy as np
    import torch

    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.models import init_cache
    from repro_torch.serve import graph as G
    from repro_torch.serve import prefill_one, splice_slot, token_step

    dev = params["embed"]["w"].device
    rng = np.random.default_rng(3)
    trace = [(rid, torch.from_numpy(rng.integers(0, cfg.vocab, int(rng.integers(5, S + 1)))),
              int(rng.integers(1, T + 1))) for rid in range(7)]
    max_len = S + T + 1

    def drain(token_mode: bool):
        cache = init_cache(cfg, B, max_len, device=dev)
        queue = list(trace)
        state = [None] * B
        pos, tok = np.zeros(B, np.int64), np.zeros(B, np.int64)
        done, info = {}, dict(splices=0, steps=0, inert=0, caps_after_warmup=0)

        def fill(mid):
            if not token_mode and any(st is not None for st in state):
                return
            for s in range(B):
                while state[s] is None and queue:
                    rid, p, n = queue.pop(0)
                    padded = torch.cat([p, p[-1:].expand(S - len(p))])
                    first, fresh = prefill_one(params, padded[None], len(p), cfg,
                                               max_cache_len=max_len)
                    splice_slot(cache, fresh, s)
                    first = int(first[0])
                    state[s] = dict(rid=rid, left=n - 1, toks=[first])
                    pos[s], tok[s] = len(p), first
                    info["splices"] += int(mid)
                    if state[s]["left"] == 0:
                        done[rid] = state[s]["toks"]
                        state[s] = None

        fill(False)
        caps0 = None
        t_dec = 0.0
        while any(st is not None for st in state):
            active = np.asarray([st is not None for st in state])
            args = [torch.from_numpy(a).to(dev) for a in (tok, pos, active)]
            idle = int(np.argmin(active)) if not active.all() else None
            before = ([c[n][idle].clone() for c in cache for n in ("k", "v")]
                      if idle is not None else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the first step captures (a capture synchronises); every later
            # one must not read from the card
            with (G.no_sync() if caps0 is not None else contextlib.nullcontext()):
                tok_d, cache = token_step(params, cache, *args, cfg)
            torch.cuda.synchronize()
            if caps0 is None:              # the capture step is not timed
                caps0 = sum(G.CAPTURES.values())
            else:
                t_dec += time.perf_counter() - t0
            if before is not None:
                after = [c[n][idle] for c in cache for n in ("k", "v")]
                if not all(torch.equal(x, y) for x, y in zip(before, after)):
                    fail(f"token_step wrote the cache rows of inactive slot {idle}")
                info["inert"] += 1
            tok = tok_d.cpu().numpy().copy()
            pos += active
            info["steps"] += 1
            for s in range(B):
                st = state[s]
                if st is None:
                    continue
                st["toks"].append(int(tok[s]))
                st["left"] -= 1
                if st["left"] == 0:
                    done[st["rid"]] = st["toks"]
                    state[s] = None
            fill(True)
        info["caps_after_warmup"] = sum(G.CAPTURES.values()) - caps0
        info["decode_s"] = t_dec
        return done, info

    before = G.counts()
    reset_launches()
    tok_res, tok_info = drain(True)
    executed = G.executed_launches(before, dict(LAUNCHES))
    wave_res, wave_info = drain(False)
    if tok_info["splices"] == 0 or tok_info["inert"] == 0:
        fail(f"token drain: no mid-flight splice or no inactive slot: {tok_info}")
    if tok_res != wave_res:
        fail(f"token-granular tokens != wave oracle:\n{tok_res}\n{wave_res}")
    if tok_info["caps_after_warmup"] or wave_info["caps_after_warmup"]:
        fail(f"token_step re-captured after its first step: {tok_info}, {wave_info}")
    n_tok = sum(len(v) for v in tok_res.values())
    print(f"token-granular serve ({len(trace)} requests, {B} slots, prefill_one + splice_slot "
          f"+ token_step as a CUDA graph): per-request tokens equal the wave oracle's; "
          f"{tok_info['splices']} mid-flight splices, {tok_info['steps']} steps (wave: "
          f"{wave_info['steps']}); no re-capture after the first step, no host synchronise "
          f"in a step; inactive slots' cache rows unchanged in {tok_info['inert']} steps; "
          f"executed launches {executed}; decode "
          f"{tok_info['decode_s'] * 1e3 / (tok_info['steps'] - 1):.2f} ms/step (host clock "
          f"around each replayed step, synchronised), {n_tok} tokens [{card}]", flush=True)
    return executed["ax_matmul"]


# ---------------------------------------------------------------------------
# phase 6c, fleet: the continuous batcher and the serve CLI
# ---------------------------------------------------------------------------

FLEET_SLOTS, FLEET_BUCKETS, FLEET_T, FLEET_N = 4, (16, 32), 8, 12


def fleet_serve(cfg, params, card: str):
    """Phase 6c, fleet: ``fleet.ContinuousBatcher`` over the serve's model
    with the ``mxu`` backend (route T): 12 seeded requests (prompts of 5-32
    tokens in buckets 16 and 32, budgets 1-8) over 4 slots, an EOS taken
    from the run's own tokens.  Wave == token per request (greedy, sampled
    at temperature 0.8 with per-request seeds, sync and async admission),
    EOS truncation, the adaptive token drain and the adaptive wave == the
    static wave with a QoR summary on every token completion, no capture
    after warm-up nor in a second drain, the exact executed launches,
    ``prefill_one`` free of host synchronises, shedding, deadlines, a
    stall, a crash survived, an arrival trace, and the serve CLI in
    process.  Returns the ax_matmul and ax_matmul_grid launches of its
    paths."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.base import AxPolicy
    from repro_torch.fleet import (BatcherConfig, ContinuousBatcher, Request, chaos,
                                   poisson_arrivals)
    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy
    from repro_torch.serve import graph as G
    from repro_torch.serve import prefill_one

    cfg = dataclasses.replace(cfg, ax=AxPolicy(backend="mxu"))
    dev = params["embed"]["w"].device
    rng = np.random.default_rng(19)
    trace = [(rid, rng.integers(0, cfg.vocab, int(rng.integers(5, 33))).astype(np.int32),
              int(rng.integers(1, FLEET_T + 1))) for rid in range(FLEET_N)]
    per_fwd = L * 4

    def batcher(adaptive=None, **kw):
        bc = dict(n_slots=FLEET_SLOTS, prompt_buckets=FLEET_BUCKETS, new_token_bucket=FLEET_T)
        bc.update(kw)
        return ContinuousBatcher(params, cfg, BatcherConfig(**bc), adaptive=adaptive)

    def controller():
        ctrl = AdaptiveController(SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                  AdaptiveConfig(drift_threshold=1e9), device=dev)
        ctrl.warmup()
        return ctrl

    def drain(bat, label, offset=0, arrivals=False):
        reqs = [Request(rid + offset, p.copy(), n) for rid, p, n in trace]
        s0 = dict(bat.stats)
        before = G.counts()
        caps0 = sum(G.CAPTURES.values())
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if arrivals:
            done = bat.run_arrivals(poisson_arrivals(reqs, 200.0, seed=0))
        else:
            for r in reqs:
                bat.submit(r)
            done = bat.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        info = {k: bat.stats[k] - s0[k] for k in ("decode_steps", "waves", "requests",
                                                   "real_tokens", "stragglers", "splices")}
        info.update(wall=wall, executed=G.executed_launches(before, dict(LAUNCHES)),
                    caps=sum(G.CAPTURES.values()) - caps0,
                    retraces=bat.stats["decode_retraces_post_warmup"])
        toks = {c.rid - offset: [int(t) for t in c.tokens] for c in done}
        if len(done) != FLEET_N or sorted(toks) != list(range(FLEET_N)) or \
                any(c.status != "ok" for c in done):
            fail(f"fleet {label}: completions {[(c.rid, c.status) for c in done]}")
        if info["retraces"] != 0:
            fail(f"fleet {label}: decode_retraces_post_warmup {info['retraces']}")
        return done, toks, info

    # the static wave without EOS; the EOS is a token it produced
    _, base, w0 = drain(batcher(), "static wave")
    want = {"ax_matmul": per_fwd * w0["waves"] * FLEET_T, "ax_matmul_grid": 0}
    if w0["executed"] != want:
        fail(f"fleet static wave: executed launches {w0['executed']}, expected {want}")
    eos = next(t[1] for t in base.values() if len(t) >= 3)
    trunc = {rid: (t[:t.index(eos) + 1] if eos in t else t) for rid, t in base.items()}
    n_eos = sum(eos in t for t in base.values())

    runs = {}
    for temp in (0.0, 0.8):
        for mode in ("wave", "sync", "async"):
            bat = batcher(eos_id=eos, temperature=temp, seed=5, token_granular=mode != "wave",
                          async_admission=mode == "async")
            done, toks, info = drain(bat, f"{mode} T={temp}")
            runs[temp, mode] = (bat, done, toks, info)
            if temp == 0.0 and mode == "sync":
                # a second drain on the same batcher captures nothing
                _, toks2, info2 = drain(bat, "second sync drain", offset=100)
                if info2["caps"] != 0 or toks2 != toks:
                    fail(f"fleet second drain: {info2['caps']} captures, tokens equal "
                         f"{toks2 == toks}")
    for temp in (0.0, 0.8):
        toks = {m: runs[temp, m][2] for m in ("wave", "sync", "async")}
        if not toks["wave"] == toks["sync"] == toks["async"]:
            fail(f"fleet T={temp}: wave/sync/async tokens differ:\n{toks}")
    if runs[0.0, "wave"][2] != trunc or runs[0.0, "wave"][0].stats["eos_retired"] != n_eos:
        fail(f"fleet EOS {eos}: wave tokens are not the EOS-free wave's truncated at EOS "
             f"({runs[0.0, 'wave'][0].stats['eos_retired']} EOS retirements, want {n_eos})")
    if runs[0.8, "wave"][2] == runs[0.0, "wave"][2]:
        fail("fleet: the sampled drain gave the greedy tokens")
    for mode in ("sync", "async"):
        info = runs[0.0, mode][3]
        want = {"ax_matmul": per_fwd * (info["requests"] + info["decode_steps"]),
                "ax_matmul_grid": 0}
        if info["executed"] != want:
            fail(f"fleet static token drain ({mode}): executed {info['executed']}, "
                 f"expected {want}")

    # adaptive, a threshold that never fires: the static wave's tokens
    abat = batcher(adaptive=controller(), eos_id=eos, token_granular=True)
    adone, atoks, ainfo = drain(abat, "adaptive token")
    want = {"ax_matmul": per_fwd * ainfo["requests"],
            "ax_matmul_grid": per_fwd * ainfo["decode_steps"]}
    if atoks != trunc or ainfo["executed"] != want or abat.adaptive.retunes:
        fail(f"fleet adaptive token drain: tokens equal {atoks == trunc}, executed "
             f"{ainfo['executed']} (want {want}), re-tunes {len(abat.adaptive.retunes)}")
    if not all(c.qor is not None and c.corr for c in adone):
        fail(f"fleet adaptive token drain: completions without a QoR summary")
    wbat = batcher(adaptive=controller(), eos_id=eos)
    wdone, wtoks, winfo = drain(wbat, "adaptive wave")
    want = {"ax_matmul": per_fwd * winfo["waves"],
            "ax_matmul_grid": per_fwd * winfo["waves"] * (FLEET_T - 1)}
    if wtoks != trunc or winfo["executed"] != want:
        fail(f"fleet adaptive wave: tokens equal {wtoks == trunc}, executed "
             f"{winfo['executed']} (want {want})")
    if not all(c.qor is None and c.corr for c in wdone):
        fail("fleet adaptive wave: a completion carries a QoR summary or lacks a corr id")

    # an admission's prefill reads nothing back from the card
    rid0, p0, _ = trace[0]
    bucket0 = min(b for b in FLEET_BUCKETS if b >= len(p0))
    padded0 = np.concatenate([p0, np.full(bucket0 - len(p0), p0[-1], np.int32)])[None]
    admit = dict(max_cache_len=FLEET_BUCKETS[-1] + FLEET_T + 1)
    with G.no_sync():
        first, _ = prefill_one(params, padded0, len(p0), cfg, rows=FLEET_SLOTS, **admit)
    if int(first[0]) != base[rid0][0]:
        fail(f"prefill_one under no_sync: first token {int(first[0])}, wave {base[rid0][0]}")
    # why an admission prefills over the slot count: alone (1 row) a request
    # rounds otherwise than in the wave's batch (printed, not gated)
    alone = 0
    for rid, p, _ in trace:
        bucket = min(b for b in FLEET_BUCKETS if b >= len(p))
        one = np.concatenate([p, np.full(bucket - len(p), p[-1], np.int32)])[None]
        alone += int(prefill_one(params, one, len(p), cfg, **admit)[0][0]) == base[rid][0]
    ms = {r: cuda_ms(lambda r=r: prefill_one(params, padded0, len(p0), cfg, rows=r, **admit),
                     iters=20) for r in (1, FLEET_SLOTS)}
    print(f"admission prefill: alone (1 row) {alone} of {FLEET_N} requests get the wave's "
          f"first token, over {FLEET_SLOTS} rows all {FLEET_N}; prefill_one of a "
          f"{len(p0)}-token prompt (bucket {bucket0}) {ms[1]:.3f} ms at 1 row, "
          f"{ms[FLEET_SLOTS]:.3f} ms at {FLEET_SLOTS} rows (CUDA events) [{card}]", flush=True)

    # robustness: shedding, a lapsed deadline and a stall; a crash survived
    rbat = batcher(eos_id=eos, token_granular=True, max_queue=8)
    acc = [rbat.submit(Request(rid, p.copy(), n, deadline_s=0.0 if rid == 0 else None))
           for rid, p, n in trace]
    plan = chaos.FaultPlan([chaos.FaultSpec("sched.step", "stall_step", at=1, arg=0.05)])
    with chaos.active(plan) as h:
        rdone = {c.rid: c for c in rbat.run()}
    if acc != [True] * 8 + [False] * 4 or rbat.stats["shed"] != 4 or sorted(rdone) != \
            list(range(8)) or h.fired_count("stall_step") != 1:
        fail(f"fleet shedding/stall: accepted {acc}, shed {rbat.stats['shed']}, retired "
             f"{sorted(rdone)}, stalls {h.fired_count('stall_step')}")
    if rdone[0].status != "timeout" or len(rdone[0].tokens) or \
            any(rdone[r].status != "ok" or list(rdone[r].tokens) != trunc[r]
                for r in range(1, 8)):
        fail(f"fleet deadline: rid 0 {rdone[0].status} {list(rdone[0].tokens)}; others "
             f"{[(r, rdone[r].status) for r in range(1, 8)]}")
    cbat = batcher(eos_id=eos)
    for rid, p, n in trace:
        cbat.submit(Request(rid, p.copy(), n))
    plan = chaos.FaultPlan([chaos.FaultSpec("sched.step", "crash_replica", at=0)])
    cdone, crashes = [], 0
    with chaos.active(plan):
        while True:
            try:
                cdone.extend(cbat.run())
                break
            except chaos.InjectedFault:
                crashes += 1
    if crashes != 1 or sorted(c.rid for c in cdone) != list(range(FLEET_N)) or \
            {c.rid: [int(t) for t in c.tokens] for c in cdone} != trunc:
        fail(f"fleet crash: {crashes} crashes, retired {sorted(c.rid for c in cdone)}")

    # an arrival trace at 200 req/s, token mode
    abat2 = batcher(eos_id=eos, token_granular=True)
    _, rtoks, rinfo = drain(abat2, "arrivals", arrivals=True)
    if rtoks != trunc:
        fail("fleet arrivals: tokens differ from the direct drain's")

    # a cross-bucket backfill: the oldest request (20 tokens, bucket 32)
    # opens a wave of bucket 32 and the three 16-bucket requests fill its
    # free slots, prefilled at 32 there.  A token-mode drain whose only
    # bucket is the wave's prefills every admission at 32 over the slot
    # count, as the wave does: its tokens equal the wave's bit for bit.  A
    # token-mode drain with both buckets prefills the three at 16: it may
    # diverge, below a top-2 margin of TOL_BATCH
    from repro_torch import obs

    back = [(rid, rng.integers(0, cfg.vocab, n).astype(np.int32), FLEET_T)
            for rid, n in enumerate((20, 6, 9, 12))]
    wave_bucket = min(b for b in FLEET_BUCKETS if b >= len(back[0][1]))
    got = {}
    for mode, kw in (("wave", {}), ("token", dict(token_granular=True)),
                     ("token at the wave's bucket",
                      dict(token_granular=True, prompt_buckets=(wave_bucket,)))):
        bbat = batcher(**kw)
        n0 = obs.default_registry().get("repro_backfills_total").total()
        for rid, p, n in back:
            bbat.submit(Request(rid + 200, p.copy(), n))
        bdone = bbat.run()
        got[mode] = {c.rid - 200: [int(t) for t in c.tokens] for c in bdone}
        if sorted(got[mode]) != list(range(len(back))):
            fail(f"fleet backfill drain ({mode}): retired {sorted(got[mode])}")
        if mode == "wave":
            n_back = obs.default_registry().get("repro_backfills_total").total() - n0
            if n_back <= 0 or bbat.stats["backfilled"] != 3 or bbat.stats["waves"] != 1:
                fail(f"fleet backfill drain: repro_backfills_total +{n_back}, backfilled "
                     f"{bbat.stats['backfilled']}, waves {bbat.stats['waves']} (want 3 in 1)")
    at_wave = got["token at the wave's bucket"]
    if at_wave != got["wave"]:
        fail(f"fleet backfill: the token-mode drain prefilled at the wave's bucket "
             f"{wave_bucket} and {FLEET_SLOTS} rows gave\n{at_wave}\nthe backfilled wave\n"
             f"{got['wave']}")
    back_div = []
    for rid, p, _ in back:
        w, t = got["wave"][rid], got["token"][rid]
        d = next((i for i in range(FLEET_T) if w[i] != t[i]), None)
        if d is not None:
            seq = torch.cat([torch.from_numpy(p).long(), torch.tensor(t[:d]).long()]).to(dev)
            m = _margin(params, cfg, seq)
            back_div.append((rid, d, round(m, 3)))
            if m > TOL_BATCH:
                fail(f"fleet backfill: request {rid} token {d} in the wave {w[d]} != token "
                     f"mode {t[d]} at a top-2 margin {m:.3f} > {TOL_BATCH}")
    print(f"fleet backfill drain (prompts 20/6/9/12 tokens, {FLEET_SLOTS} slots, buckets "
          f"{FLEET_BUCKETS}): one wave of bucket {wave_bucket} with 3 requests backfilled "
          f"from bucket 16 (repro_backfills_total +{n_back:.0f}); token mode prefilled at "
          f"bucket {wave_bucket} == the wave's tokens for all {len(back)} requests; token mode "
          f"with both buckets == the wave's for {len(back) - len(back_div)} of {len(back)}, "
          f"divergences (request, token, top-2 margin) {back_div or 'none'} (bound "
          f"{TOL_BATCH}) [{card}]", flush=True)

    for label, (bat, info) in (("wave", runs[0.0, "wave"][::3]),
                               ("token sync", runs[0.0, "sync"][::3]),
                               ("token async", runs[0.0, "async"][::3]),
                               ("token adaptive", (abat, ainfo)),
                               ("token arrivals 200 req/s", (abat2, rinfo))):
        s = bat.latency_summary()
        per_step = (f"{info['wall'] * 1e3 / info['decode_steps']:.2f} ms/step (drain wall / "
                    f"steps, admissions included), median step dispatch "
                    f"{np.median(bat.watchdog.times) * 1e3:.2f} ms; "
                    if bat.mode == "token" else "")
        qd = (f"queue delay p50/p99 {s['queue_delay_p50'] * 1e3:.1f}/"
              f"{s['queue_delay_p99'] * 1e3:.1f} ms; " if "queue_delay_p50" in s else "")
        print(f"fleet {label}: {FLEET_N} requests in {info['wall'] * 1e3:.1f} ms, "
              f"{info['decode_steps']} steps, {info['waves']} waves, {info['splices']} "
              f"splices; {per_step}TTFT p50/p99 {s['ttft_p50'] * 1e3:.1f}/"
              f"{s['ttft_p99'] * 1e3:.1f} ms, e2e p50/p99 {s['e2e_p50'] * 1e3:.1f}/"
              f"{s['e2e_p99'] * 1e3:.1f} ms; {qd}occupancy {bat.occupancy():.3f}, "
              f"{info['real_tokens'] / info['wall']:.1f} tokens/s, stragglers "
              f"{info['stragglers']} [{card}]", flush=True)
    print(f"fleet (qwen2-72b x{L} layers, mxu route T, {FLEET_SLOTS} slots, buckets "
          f"{FLEET_BUCKETS}, {FLEET_N} requests, EOS {eos}): wave == token per request, "
          f"greedy and sampled (T=0.8, per-request seeds), sync and async admission; EOS "
          f"truncation ({n_eos} requests); adaptive token drain and adaptive wave == the "
          f"static wave, QoR on every token completion; 0 captures after warm-up and in a "
          f"second drain; executed launches: static wave {w0['executed']}, static token "
          f"{runs[0.0, 'sync'][3]['executed']}, adaptive token {ainfo['executed']}, adaptive "
          f"wave {winfo['executed']}; prefill_one under no_sync; 4 shed, a queued timeout, "
          f"a stall, a crash survived with every request retired once; arrivals == direct "
          f"[{card}]", flush=True)

    # the serve CLI in process, on the card (the reduced model of --smoke)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        obs_dir, store = f"{tmp}/obs", f"{tmp}/store"
        t0 = time.perf_counter()
        cli_bat, cli_done = serve_main(["--smoke", "--ax", "--fleet", "1", "--token-granular",
                                        "--requests", "8", "--obs-dir", obs_dir,
                                        "--policy-store", store])
        events = json.loads(Path(obs_dir, "trace.json").read_text())["traceEvents"]
        n_steps = sum(e["name"] == "token_step" for e in events)
        if len(cli_done) != 8 or n_steps == 0 or cli_bat.stats["decode_retraces_post_warmup"]:
            fail(f"serve CLI --fleet 1: {len(cli_done)} completions, {n_steps} token_step "
                 f"spans")
        cli_out, cli_ctrl = serve_main(["--smoke", "--ax", "--adaptive"])
        if cli_out.shape != (4, 32) or cli_ctrl.step == 0:
            fail(f"serve CLI --adaptive: tokens {cli_out.shape}, observed {cli_ctrl.step}")
        print(f"serve CLI in process (--smoke --ax --fleet 1 --token-granular: 8 served, "
              f"{n_steps} token_step spans in trace.json; --smoke --ax --adaptive: "
              f"{len(cli_ctrl.retunes)} re-tunes): {time.perf_counter() - t0:.1f} s "
              f"[{card}]", flush=True)

    paths = {"fleet static wave": w0["executed"]["ax_matmul"],
             "fleet static token": runs[0.0, "sync"][3]["executed"]["ax_matmul"],
             "fleet adaptive token (prefill)": ainfo["executed"]["ax_matmul"],
             "fleet adaptive wave (prefill)": winfo["executed"]["ax_matmul"]}
    grid_paths = {"fleet adaptive token": ainfo["executed"]["ax_matmul_grid"],
                  "fleet adaptive wave": winfo["executed"]["ax_matmul_grid"]}
    return paths, grid_paths


# ---------------------------------------------------------------------------
# phase 6d: observability and the guarded rollout
# ---------------------------------------------------------------------------

ROLLOUT_SPANS = ("prefill", "decode", "retune", "canary", "rollback")
# the families the serve, the controller, the store and the chaos harness
# report into; each must hold a nonzero series after the phase
ROLLOUT_FAMILIES = (
    "repro_retraces_total", "repro_prefill_dispatch_seconds", "repro_decode_dispatch_seconds",
    "repro_decode_tokens_total", "repro_slots_retired_total", "repro_retunes_total",
    "repro_retune_seconds", "repro_canary_total", "repro_rollbacks_total",
    "repro_policy_store_published", "repro_policy_publishes_total",
    "repro_policy_adoptions_total", "repro_policy_poll_total", "repro_store_rollbacks_total",
    "repro_drift_score", "repro_telemetry_quarantined_total",
    "repro_chaos_faults_injected_total")
ROLLOUT_SEED = 7


def _audit(ctrl):
    """A controller's audit events without the wall clock."""
    return [{k: v for k, v in e.items() if k != "unix_time"} for e in ctrl.audit.read()]


def _nonzero_families(text: str):
    """The metric families of a Prometheus text with a series above 0 (a
    histogram through its ``_count``)."""
    out = set()
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, value = line.split("{")[0].split(" ")[0], float(line.rsplit(" ", 1)[1])
        if name.endswith("_bucket") or name.endswith("_sum"):
            continue
        if value > 0:
            out.add(name[:-len("_count")] if name.endswith("_count") else name)
    return out


def rollout_serve(cfg, params, prompts, card: str):
    """Phase 6d: a writer serve re-tunes with the canary, publishes to a
    ``PolicyStore`` and is replayed on the CPU; a canary that rejects
    everything keeps the store and the tokens; a replica adopts every
    version on the graph path with no capture; a guard-band regression
    rolls back; an armed but idle fault plan changes nothing and a seeded
    poison lands in quarantine; the exports and the trace hold the
    serve's series and spans.  Returns the ax_matmul and ax_matmul_grid
    launches of the writer and replica paths, and a function that runs one
    replica serve under ``obs.device_trace``."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.fleet import PolicyReader, PolicyStore, chaos
    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.launch.serve import drift_hook
    from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy
    from repro_torch.serve import ServeConfig, generate
    from repro_torch.serve import graph as G

    dev = params["embed"]["w"].device
    targets = cfg.ax.targets
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_rollout_")
    root = Path(tmp.name)
    writer_kw = dict(min_observe_steps=2, cooldown_steps=2, drift_threshold=0.02, canary=True)

    def controller(policy=None, store=None, device=dev, **kw):
        return AdaptiveController(policy or SwapPolicy.from_ax_policy(cfg.ax), targets,
                                  AdaptiveConfig(**kw), store=store, device=device)

    def serve(adaptive, **kw):
        stats = {}
        toks = generate(params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=T, **kw),
                        adaptive=adaptive, stats=stats).cpu()
        return toks, stats

    # the QoR SLOs' guard bands: 1.5x each target's ew_mae in a serve
    # without drift (the reference the policy was tuned on)
    ref = controller(drift_threshold=1e9)
    serve(ref, cuda_graphs=False)
    slo_refs = {t: float(s["ew_mae"]) for t, s in ref.telemetry.snapshot().items()}

    def attach(ctrl):
        eng = obs.SLOEngine(obs.default_serving_slos(qor_targets=targets), audit=ctrl.audit)
        for t, mae in slo_refs.items():
            eng.set_reference(t, mae)
        ctrl.attach_slo(eng)

    def drive_writer(name, margin=0.0, on_start=None, on_log=None, plan=None, **kw):
        store = PolicyStore(str(root / name))
        ctrl = controller(store=store, **dict(writer_kw, canary_margin=margin, **kw))
        ctrl.warmup()
        ctrl.resume_from_store()
        attach(ctrl)
        records, ew = [], []
        observe = ctrl.observe

        def recording_observe(recs):
            records.append({t: {k: np.array(v) for k, v in r.items()} for t, r in recs.items()})
            lines = observe(recs)
            ew.append({t: s.get("ew_mae") for t, s in ctrl.telemetry.snapshot().items()})
            return lines

        ctrl.observe = recording_observe
        if on_start is not None:
            on_start(ctrl, store)
        ctrl._log_fn = on_log
        stats = {}
        reset_launches()
        with (chaos.active(plan) if plan is not None else contextlib.nullcontext()) as harness:
            toks = generate(params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=T_DRIFT),
                            adaptive=ctrl, param_hook=drift_hook(DRIFT_AT, DRIFT_SCALE),
                            stats=stats).cpu()
        return dict(toks=toks, ctrl=ctrl, store=store, records=records, ew=ew, stats=stats,
                    launches=dict(LAUNCHES), harness=harness)

    # -- the writer, with a replica polling after each publish ----------
    rec = obs.TraceRecorder()
    prev_rec = obs.install_recorder(rec)
    replica, adoptions = None, []

    def replica_serve():
        before, l0, c0 = G.counts(), dict(LAUNCHES), sum(G.CAPTURES.values())
        toks, stats = serve(replica)
        executed = G.executed_launches(before, {k: LAUNCHES[k] - l0[k] for k in LAUNCHES})
        return toks, executed, sum(G.CAPTURES.values()) - c0, stats

    def start_replica(ctrl, store):
        nonlocal replica
        replica = PolicyReader(PolicyStore(store.root), targets, device=dev)
        toks, executed, caps, _ = replica_serve()
        adoptions.append(dict(version=replica.version, lag=None, stale=replica.staleness(),
                              toks=toks, executed=executed, caps=caps, step=0))

    def on_publish(line):
        if not line.startswith("published policy v"):
            return
        w = writer1
        old = replica.version
        lag = replica.staleness()
        if not replica.poll():
            fail(f"the replica did not adopt after '{line}'")
        stale = replica.staleness()
        toks, executed, caps, _ = replica_serve()
        adoptions.append(dict(version=replica.version, old=old, lag=lag, stale=stale, toks=toks,
                              executed=executed, caps=caps, step=w.step,
                              ew_before={t: s.get("ew_mae")
                                         for t, s in w.telemetry.snapshot().items()}))

    writer1 = None

    def on_start1(ctrl, store):
        nonlocal writer1
        writer1 = ctrl
        start_replica(ctrl, store)

    run1 = drive_writer("writer", on_start=on_start1, on_log=on_publish)
    w1, store = run1["ctrl"], run1["store"]
    canaried = [e for e in w1.retunes if e.candidate_version is not None]
    promoted = [e for e in w1.retunes if e.promoted]
    published = [int(line.rsplit("v", 1)[1]) for line in w1.log
                 if line.startswith("published policy v")]
    if not canaried:
        fail(f"the writer serve made no canaried re-tune: {[e.describe() for e in w1.retunes]}")
    if store.current_version() != (published[-1] if published else 1) \
            or store.versions() != [1] + published or len(published) != len(promoted):
        fail(f"writer store: CURRENT {store.current_version()}, versions {store.versions()}, "
             f"published {published}, promotions {len(promoted)}")
    kinds1 = [e["kind"] for e in _audit(w1)]
    print(f"rollout writer (drift x{DRIFT_SCALE} at step {DRIFT_AT}, {T_DRIFT} tokens, "
          f"stepwise, scalar mode, canary on, SLO attached): {len(w1.retunes)} re-tunes, "
          f"{len(canaried)} canaried, {len(promoted)} promoted; CURRENT v"
          f"{store.current_version()} = the last promotion; audit kinds {kinds1} [{card}]",
          flush=True)
    for line in w1.log:
        print(f"  [writer] {line}", flush=True)

    # a second run, no replica: the same tokens and audit kinds
    run2 = drive_writer("writer2")
    w2 = run2["ctrl"]
    want = {"ax_matmul": L * 4, "ax_matmul_grid": L * 4 * (T_DRIFT - 1)}
    if run2["launches"] != want:
        fail(f"writer serve (run 2): launches {run2['launches']}, expected {want}")
    if [e["kind"] for e in _audit(w2)] != kinds1 or not torch.equal(run2["toks"], run1["toks"]):
        fail(f"the writer serve is not deterministic: audit kinds {kinds1} vs "
             f"{[e['kind'] for e in _audit(w2)]}, tokens equal "
             f"{torch.equal(run2['toks'], run1['toks'])}")
    # the card writer's host records replayed through a CPU controller and
    # a CPU store: every audit event the same
    cpu_store = PolicyStore(str(root / "replay"))
    cpu = controller(store=cpu_store, device="cpu", **writer_kw)
    cpu.resume_from_store()
    attach(cpu)
    for r in run2["records"]:
        cpu.observe(r)
    if _audit(cpu) != _audit(w2) or cpu_store.versions() != run2["store"].versions():
        fail(f"CPU replay of the writer's records: audit\n{_audit(cpu)}\nvs the card's\n"
             f"{_audit(w2)}")
    print(f"writer run 2 (no replica): tokens and audit kinds equal run 1's; launches "
          f"{run2['launches']}; {_speed(run2['stats'], T_DRIFT)}; its {len(run2['records'])} "
          f"host records replayed through a CPU controller and store: all "
          f"{len(_audit(w2))} audit events equal (kind, target, old, new, scores, "
          f"versions) [{card}]", flush=True)

    # -- canary rejection: nothing promoted, the never-changing tokens -----
    run_r = drive_writer("reject", margin=1.0)
    wr = run_r["ctrl"]
    never = controller(drift_threshold=1e9)
    toks_never = generate(params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=T_DRIFT),
                          adaptive=never, param_hook=drift_hook(DRIFT_AT, DRIFT_SCALE)).cpu()
    kinds_r = [e["kind"] for e in _audit(wr)]
    store_r = run_r["store"]
    # a re-tune that re-elects the incumbent is not canaried and republishes
    # it (the JAX package's rule), so CURRENT can move without a change
    v1 = store_r.load(1).dyn_tree(targets, device="cpu")
    same = all(all(torch.equal(v1[t], store_r.load(v).dyn_tree(targets, device="cpu")[t])
                   for t in targets) for v in store_r.versions())
    reelected = sum(e.promoted for e in wr.retunes)
    if not same or "canary_rejected" not in kinds_r \
            or any(e.promoted for e in wr.retunes if e.candidate_version is not None) \
            or (reelected == 0 and store_r.current_version() != 1) \
            or not torch.equal(run_r["toks"], toks_never):
        fail(f"canary_margin=1.0: CURRENT {store_r.current_version()} (re-elected "
             f"incumbents {reelected}), every version resolves like v1 {same}, audit "
             f"{kinds_r}, tokens equal the never-changing policy's "
             f"{torch.equal(run_r['toks'], toks_never)}")
    print(f"canary rejection (canary_margin=1.0): no candidate promoted; CURRENT v"
          f"{store_r.current_version()} ({reelected} re-tunes re-elected the incumbent and "
          f"republished it), every stored version resolves like v1; audit {kinds_r}; tokens "
          f"equal a serve whose policy never changed [{card}]", flush=True)

    # -- the replica: one program, every version a value ------------------
    for a in adoptions:
        pol = store.load(a["version"])
        want_toks, _ = serve(controller(pol, drift_threshold=1e9), cuda_graphs=False)
        if not torch.equal(a["toks"], want_toks) or a["stale"] != 0 or a["caps"] != 0 \
                or (a["lag"] is not None and a["lag"] != a["version"] - a["old"]):
            fail(f"replica under v{a['version']}: tokens equal a controller serve of "
                 f"store.load({a['version']}) {torch.equal(a['toks'], want_toks)}, "
                 f"staleness after the poll {a['stale']}, lag {a['lag']} (versions "
                 f"{a.get('old')} -> {a['version']}), new captures {a['caps']}")
    retr = {k: obs.retrace_total(k) for k in ("fused", "fused_adaptive", "token_step")}
    caps_by_kind = G.captures_by_kind()
    if any(retr[k] != caps_by_kind.get(k, 0) for k in retr) or \
            obs.retrace_total("prefill") != 0:
        fail(f"repro_retraces_total {retr} != graph captures by kind {caps_by_kind}")
    rep_exec = adoptions[-1]["executed"]
    if rep_exec != {"ax_matmul": L * 4, "ax_matmul_grid": L * 4 * (T - 1)}:
        fail(f"replica serve executed launches {rep_exec}")
    print(f"replica (PolicyReader on {dev}, fused graph path, {T} tokens): adopted "
          f"{[a['version'] for a in adoptions]} after each publish (lag before the poll "
          f"{[a['lag'] for a in adoptions]}, 0 after it); tokens under each version equal an "
          f"eager controller serve of store.load(N); 0 captures in {len(adoptions)} serves; "
          f"repro_retraces_total {retr} == graph captures by kind; executed launches "
          f"{rep_exec} [{card}]", flush=True)

    # -- rollback: the low-then-high regimes, scored on the card ----------
    n_writer = len(adoptions)
    c0 = store.current_version()
    rb = controller(store=PolicyStore(store.root), decay=0.4, drift_threshold=10.0,
                    min_observe_steps=1, cooldown_steps=0, buffer_size=1024, canary=True,
                    rollback_guard=0.5, rollback_min_steps=2, rollback_window=32)
    rb.warmup()
    rb.resume_from_store()
    writer1 = rb
    rb._log_fn = on_publish
    rng = np.random.default_rng(6)
    # JAX's regimes are uint8 0..63, then the top half 128..255 of both
    # operands; the int8 counterpart of the top half is 64..127
    for _ in range(4):
        rb.observe_operands("mlp", rng.integers(0, 64, 2048), rng.integers(0, 64, 2048))
    ev = rb.retune("mlp")
    if not ev.promoted or ev.candidate_version is None:
        fail(f"rollback set-up: the low-regime re-tune was not a canaried promotion: "
             f"{ev.describe()}")
    for _ in range(12):
        rb.observe_operands("mlp", rng.integers(64, 128, 2048), rng.integers(64, 128, 2048))
        if rb.rollbacks:
            break
    caps0 = sum(G.CAPTURES.values())
    lag = replica.staleness()
    polled = replica.poll()
    toks_rb, exec_rb, caps_rb, _ = replica_serve()
    want_rb, _ = serve(controller(store.load(c0), drift_threshold=1e9), cuda_graphs=False)
    before_rb = [a for a in adoptions if a["version"] == c0]
    if len(rb.rollbacks) != 1 or store.current_version() != c0 \
            or rb.policy.to_json() != store.load(c0).to_json() or not polled \
            or replica.version != c0 or caps_rb or sum(G.CAPTURES.values()) != caps0 \
            or not torch.equal(toks_rb, want_rb) \
            or not all(torch.equal(toks_rb, a["toks"]) for a in before_rb):
        fail(f"rollback: {len(rb.rollbacks)} rollbacks, CURRENT {store.current_version()} "
             f"(last good v{c0}), policy == store.load(last good) "
             f"{rb.policy.to_json() == store.load(c0).to_json()}, replica adopted "
             f"{polled} v{replica.version} with {caps_rb} captures, tokens equal those "
             f"under last good {torch.equal(toks_rb, want_rb)}")
    info = rb.rollbacks[0]
    print(f"rollback (the low-then-high regimes on mlp, scored on {dev}): v"
          f"{ev.candidate_version} promoted, ew_mae {info['observed']:.2f} > band "
          f"{info['baseline'] * 1.5:.2f} at step {info['step']} -> CURRENT re-pointed to v{c0}, "
          f"the policy byte-identical to store.load({c0}); the replica (lag {lag}) adopted v{c0} "
          f"on its next poll with 0 captures, tokens equal those under v{c0} [{card}]",
          flush=True)
    obs.install_recorder(prev_rec)

    # -- armed but idle; one seeded poison --------------------------------
    idle = chaos.FaultPlan([chaos.FaultSpec(s, k, at=10 ** 6)
                            for s, ks in chaos.SITES.items() for k in ks])
    run_i = drive_writer("idle", plan=idle)
    if not torch.equal(run_i["toks"], run2["toks"]) or run_i["harness"].fired \
            or [e["kind"] for e in _audit(run_i["ctrl"])] != kinds1:
        fail(f"armed but idle fault plan: tokens equal {torch.equal(run_i['toks'], run2['toks'])}"
             f", fired {run_i['harness'].fired}, audit {_audit(run_i['ctrl'])}")
    at = int(np.random.default_rng(ROLLOUT_SEED).integers(0, DRIFT_AT))
    run_p = drive_writer("poison", plan=chaos.FaultPlan(
        [chaos.FaultSpec("controller.observe", "poison_nan", at=at)], seed=ROLLOUT_SEED))
    wp = run_p["ctrl"]
    quar = [e for e in _audit(wp) if e["kind"] == "quarantine"]
    if run_p["harness"].fired_count("poison_nan") != 1 or {e["step"] for e in quar} != {at} \
            or sorted(e["target"] for e in quar) != sorted(targets) \
            or any(e.step == at + 1 for e in wp.retunes) \
            or not all(np.isfinite(s["bit_probs"]).all()
                       for s in wp.telemetry.snapshot().values()):
        fail(f"seeded poison at observe visit {at}: fired "
             f"{run_p['harness'].fired_count('poison_nan')}, quarantine {quar}, re-tunes "
             f"{[e.describe() for e in wp.retunes]}")
    print(f"fault plans: armed but idle ({len(idle.faults)} specs that never come): tokens "
          f"and audit kinds equal the unarmed run's; a seeded poison_nan at observe visit "
          f"{at}: both targets quarantined, no re-tune from it; "
          f"visits {run_p['harness'].visits} [{card}]", flush=True)

    # -- quality of result: the card's records, per target ----------------
    for i, r in enumerate(run2["records"]):
        scalars, _ = obs.step_error_summary(r)
        print(f"  [qor] step {i}: " + ", ".join(f"{t} step MAE {v:.3f}"
                                                 for t, v in sorted(scalars.items())),
              flush=True)
    ew = run1["ew"]
    for a in adoptions[1:n_writer]:
        after = ew[min(a["step"] + 2, len(ew) - 1)]
        print(f"  [qor] adoption of v{a['version']} at step {a['step']}: ew_mae "
              + ", ".join(f"{t} {a['ew_before'].get(t, float('nan')):.3f} -> "
                          f"{after.get(t, float('nan')):.3f}" for t in targets)
              + f" (2 steps later) [{card}]", flush=True)

    # -- exports and traces ------------------------------------------------
    text = obs.prometheus_text()
    missing = set(ROLLOUT_FAMILIES) - _nonzero_families(text)
    if missing:
        fail(f"prometheus_text() lacks nonzero series for {sorted(missing)}")
    trace_path = rec.save(str(root / "trace.json"))
    with open(trace_path) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"] if e["ph"] == "X"}
    if not set(ROLLOUT_SPANS) <= spans:
        fail(f"trace.json lacks spans {sorted(set(ROLLOUT_SPANS) - spans)}")
    (root / "metrics.prom").write_text(text)
    snap = obs.write_snapshot(str(root / "metrics.jsonl"))
    print(f"exports: prometheus_text {len(text.splitlines())} lines, nonzero series in all "
          f"{len(ROLLOUT_FAMILIES)} families; trace.json {len(rec.events())} events, spans "
          f"{sorted(spans)}; snapshot of {len(snap['metrics'])} metrics [{card}]", flush=True)

    def device_trace_serve():
        """One replica graph serve under ``obs.device_trace``.  The script
        runs it last: a ``torch.profiler`` session slows the host-bound
        phases that follow it."""
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
            with obs.device_trace(d) as dpath:
                replica_serve()
            with open(dpath) as f:
                events = json.load(f)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        route = [e for e in kern if "route_t_kernel" in e.get("name", "")]
        glaunch = [e for e in events if "cudaGraphLaunch" in e.get("name", "")]
        print(f"device_trace of one replica graph serve: {len(kern)} kernel events, "
              f"{len(route)} of them route_t_kernel (the 8 launches of the eager prefill and "
              f"the {L * 4 * (T - 1)} ax_matmul_grid launches replayed from the graph), "
              f"{len(glaunch)} cudaGraphLaunch [{card}]", flush=True)

    # -- overhead and walls -------------------------------------------------
    rows = []
    for on in (False, True, True, False):
        prev = obs.install_recorder(obs.TraceRecorder() if on else None)
        _, stats = serve(None)
        obs.install_recorder(prev)
        rows.append((on, stats["decode_s"] * 1e3 / (T - 1), stats["path"]))
    off = [ms for on, ms, _ in rows if not on]
    onr = [ms for on, ms, _ in rows if on]
    spans_ms = {}
    for e in rec.events():
        if e["ph"] == "X":
            spans_ms.setdefault(e["name"], []).append(e["dur"] / 1e3)
    wall_store = PolicyStore(str(root / "walls"))
    pol = SwapPolicy.from_ax_policy(cfg.ax)
    t0 = time.perf_counter()
    for _ in range(20):
        wall_store.publish(pol)
    publish_ms = (time.perf_counter() - t0) * 1e3 / 20
    reader = PolicyReader(wall_store, targets, device=dev)
    t0 = time.perf_counter()
    for _ in range(200):
        reader.poll()
    fast_ms = (time.perf_counter() - t0) * 1e3 / 200
    full = []
    for _ in range(10):
        wall_store.publish(pol)
        t0 = time.perf_counter()
        reader.poll()
        full.append((time.perf_counter() - t0) * 1e3)
    mean = lambda v: sum(v) / len(v) if v else float("nan")
    print(f"overhead: static graph decode {', '.join(f'{ms:.3f}' for _, ms, _ in rows)} "
          f"ms/step (recorder off, on, on, off; paths {[p for _, _, p in rows]}): "
          f"{mean(onr):.3f} with a recorder installed vs {mean(off):.3f} without "
          f"[{card}]", flush=True)
    print(f"walls (host clock): retune {mean(spans_ms.get('retune', [])):.2f} ms "
          f"({len(spans_ms.get('retune', []))} spans), canary "
          f"{mean(spans_ms.get('canary', [])):.2f} ms ({len(spans_ms.get('canary', []))}), "
          f"rollback {mean(spans_ms.get('rollback', [])):.2f} ms; publish with fsync "
          f"{publish_ms:.3f} ms; poll {fast_ms * 1e3:.1f} us on the heartbeat path, "
          f"{mean(full):.3f} ms adopting a new version [{card}]", flush=True)
    tmp.cleanup()
    return ({"writer prefill": run2["launches"]["ax_matmul"],
             "replica prefill": rep_exec["ax_matmul"]},
            {"writer (stepwise, eager)": run2["launches"]["ax_matmul_grid"],
             "replica graph": rep_exec["ax_matmul_grid"]}, device_trace_serve)


# ---------------------------------------------------------------------------
# phase 6e: the decoder-only families at their published widths
# ---------------------------------------------------------------------------

# depth cut to the leading layers plus one period of each configuration
FAMILY_DEPTH = {"gemma3-27b": 6, "starcoder2-15b": 2, "qwen1.5-110b": 2, "qwen2-vl-72b": 2,
                "deepseek-moe-16b": 2, "granite-moe-1b-a400m": 2, "recurrentgemma-2b": 3,
                "mamba2-370m": 2}
# gemma3's long serve: prompts whose decode crosses the 1024-row ring
LONG_PROMPT = 1020
# the forward-consistency check's own f32 bound (relative to the full
# forward's largest logit), beside test_arch_smoke's bf16 ones; measured
# at most 4.4e-6 (PERF.md section 6), while one wrong ring row among 1024
# keys moves a logit by more
TOL_CONSIST_F32 = 1e-4


def _padded(v: int, cap: int = 128) -> int:
    """A dimension as the dense path hands it to the kernel: zero-padded to
    a multiple of its block, the schedule's 128 clamped to the dimension
    (``quant/ax.py::_pad_for_kernel``)."""
    blk = min(cap, v)
    return -(-v // blk) * blk


def family_kernel_shapes(cfg, name: str, Ms) -> dict:
    """{(M, K, N): label} of the kernel launches of ``cfg``'s approximate
    projections (``transformer.ax_projections``) at each row count of
    ``Ms`` (B at decode, B x S at prefill), padded as the dense path pads
    them."""
    from repro_torch.models.transformer import ax_projections

    shapes = {}
    for M in Ms:
        for _, proj, K, N in ax_projections(cfg):
            key = (_padded(M), _padded(K), _padded(N))
            shapes.setdefault(key, [f"{name} M={M}"]).append(proj)
    return {k: f"{v[0]} {'/'.join(dict.fromkeys(v[1:]))}" for k, v in shapes.items()}


@contextlib.contextmanager
def kernel_shapes():
    """Record the (M, K, N) of every launch the dense path makes of each
    kernel (``quant/ax.py`` calls the wrappers by these names); the
    wrappers and their launch counts are untouched."""
    from repro_torch.quant import ax as QA

    seen = {"ax_matmul": set(), "ax_matmul_grid": set()}
    real = {n: getattr(QA, n) for n in seen}

    def wrap(n):
        def call(a, b, *args, **kw):
            seen[n].add((a.shape[0], a.shape[1], b.shape[1]))
            return real[n](a, b, *args, **kw)
        return call

    for n in seen:
        setattr(QA, n, wrap(n))
    try:
        yield seen
    finally:
        for n in seen:
            setattr(QA, n, real[n])


def family_prompt(cfg, B_: int, S_: int, dev, seed: int, frames: int = 0):
    """``{"tokens"}``, or for the vlm ``{"embeds", "pos"}`` with three
    distinct M-RoPE streams (temporal, t // 4, t % 4), or for the
    encoder-decoder ``{"frames", "tokens"}`` with ``frames`` (2 x S_ when 0)
    seeded normal frame embeddings in bf16, as the JAX serve CLI makes
    them."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "encdec":
        fr = torch.randn((B_, frames or 2 * S_, cfg.d_model), generator=gen)
        return {"frames": fr.to(torch.bfloat16).to(dev),
                "tokens": torch.randint(0, cfg.vocab, (B_, S_), generator=gen).to(dev)}
    if cfg.family == "vlm":
        t = torch.arange(S_)
        pos = torch.stack([t, t // 4, t % 4], -1)[None].expand(B_, S_, 3).contiguous()
        emb = torch.randn((B_, S_, cfg.d_model), generator=gen)
        return {"embeds": emb.to(dev), "pos": pos.to(dev)}
    return {"tokens": torch.randint(0, cfg.vocab, (B_, S_), generator=gen).to(dev)}


def forward_consistency(params, cfg, toks, label: str, extra=None):
    """Prefill of all but the last 3 tokens, then 3 decode steps, against
    the full forward, to ``tests/test_arch_smoke.py``'s tolerances (the
    last prefill logit rtol 0.1 / atol 0.15; each decode step's max |diff|
    below 0.15 of the full forward's max |logit|), on the exact projections
    as that test runs them, in f32: in bf16 the prefill's and the decode's
    GEMMs round differently, and an int8 code flip (0.24-0.65 relative with
    the approximate projection on the reduced configs on the CPU) or a MoE
    routing flip on a near-tie (granite, 0.29 on the exact path) moves a
    logit further.  A MoE config runs with a capacity that drops nothing
    (C = T), as the reduced configs do: a capacity-bounded dispatch drops
    other choices in a forward of S tokens than in a prefill of S - 3
    (deepseek at its published 1.25: 0.20 in the last prefill logits).
    Beside those bounds, every compared logit is held to ``TOL_CONSIST_F32``
    of the full forward's largest.  ``extra`` joins the prompt batch (the
    encoder-decoder's frames).  Returns the worst relative difference (the
    last prefill logits and the decode steps)."""
    import torch

    from repro_torch.models import decode_step, prefill, registry

    cfg = dataclasses.replace(cfg, ax=None, compute_dtype="float32",
                              moe_capacity=float(max(cfg.n_experts, 1)))
    extra = extra or {}
    S_ = toks.shape[1]
    with torch.inference_mode():
        full, _ = registry._mod(cfg).forward(params, dict(extra, tokens=toks), cfg,
                                             mode="train")
        full = full.float()
        lg, cache = prefill(params, dict(extra, tokens=toks[:, :S_ - 3]), cfg,
                            max_cache_len=S_ + 2)
        a, b = full[:, S_ - 4], lg[:, -1].float()
        rel = ((a - b).abs().max() / a.abs().max().clamp(min=1e-6)).item()
        if not (bool(((a - b).abs() <= 0.15 + 0.1 * b.abs()).all()) and rel <= TOL_CONSIST_F32):
            fail(f"{label}: prefill's last logits vs the full forward: max |diff| "
                 f"{(a - b).abs().max().item()}, relative {rel} (f32 tol {TOL_CONSIST_F32})")
        worst = rel
        for i in range(3):
            p = S_ - 3 + i
            lg, cache = decode_step(params, cache, toks[:, p:p + 1], p, cfg)
            a = full[:, p]
            rel = ((a - lg[:, 0].float()).abs().max() / a.abs().max().clamp(min=1e-6)).item()
            worst = max(worst, rel)
            if not (rel < 0.15 and rel <= TOL_CONSIST_F32):
                fail(f"{label}: decode step {i} (position {p}) vs the full forward: "
                     f"relative max |diff| {rel} (f32 tol {TOL_CONSIST_F32})")
    return worst


def family_serve(name: str, dev, card: str):
    """One family at its published widths, depth ``FAMILY_DEPTH``, random f32
    weights from a seed, bf16 compute, SWAPPER ``kernel`` (the serve
    phase's policy): prefill + 3 decode steps vs the full forward (exact
    projections, ``forward_consistency``); B = 4
    prompts of 32 tokens (embeds and 3-stream positions for the vlm), 8
    greedy tokens eagerly and as a CUDA graph twice (equal tokens, the
    launches reckoned from the config, one capture then none); for gemma3
    a 1022-token prefill whose decode crosses the 1024-row ring, and a
    1020-token serve; for recurrentgemma and deepseek a no-drift adaptive
    serve (the static tokens, through ``ax_matmul_grid``).  Returns a
    row of times and launches."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import AxPolicy
    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.models import init_params
    from repro_torch.models.transformer import ax_projections
    from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy
    from repro_torch.serve import ServeConfig, generate
    from repro_torch.serve import graph as G

    cfg = dataclasses.replace(ARCHS[name], n_layers=FAMILY_DEPTH[name],
                              ax=AxPolicy(backend="kernel"))
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    init_s = time.perf_counter() - t0
    n_ax = len(ax_projections(cfg))
    row = dict(name=name, layers=cfg.n_layers, kinds=list(cfg.layer_kinds()),
               params_g=n_params / 1e9, ax_per_forward=n_ax)

    with kernel_shapes() as seen:
        toks = family_prompt(dataclasses.replace(cfg, family="dense"), 2, 24, dev, seed=5)["tokens"]
        row["decode_vs_full_rel"] = forward_consistency(params, cfg, toks, name)

        prompts = family_prompt(cfg, B, S, dev, seed=1)
        want = {"ax_matmul": n_ax * T, "ax_matmul_grid": 0}
        stats_e = {}
        reset_launches()
        eager = generate(params, prompts, cfg, ServeConfig(max_new_tokens=T, cuda_graphs=False),
                         stats=stats_e).cpu()
        if dict(LAUNCHES) != want:
            fail(f"{name}: launches in one eager serve {dict(LAUNCHES)}, expected {want} "
                 f"({n_ax} approximate projections a forward x {T} forwards)")
        if tuple(eager.shape) != (B, T) or int(eager.min()) < 0 or int(eager.max()) >= cfg.vocab:
            fail(f"{name}: tokens out of range or misshapen: {tuple(eager.shape)}")
        for run in range(2):
            got, stats_g, executed, caps = graph_run(lambda st: generate(
                params, prompts, cfg, ServeConfig(max_new_tokens=T), stats=st).cpu())
            if stats_g["path"] != "graph" or executed != want or caps != (1 if run == 0 else 0) \
                    or not torch.equal(got, eager):
                fail(f"{name} graph serve (run {run}): path {stats_g['path']}, executed "
                     f"{executed} (want {want}), captures {caps}, tokens equal the eager "
                     f"serve's {torch.equal(got, eager)}")
        row.update(eager=dict(stats_e), graph=dict(stats_g), launches=want["ax_matmul"],
                   graph_launches=executed["ax_matmul"], tokens=eager.tolist())
        print(f"family {name} ({cfg.n_layers} layers {'/'.join(cfg.layer_kinds())}, "
              f"{n_params / 1e9:.3f} G params f32, init {init_s:.2f} s): prefill + 3 decode "
              f"steps vs the full forward, worst relative diff {row['decode_vs_full_rel']:.3g} "
              f"(< 0.15, f32 tol {TOL_CONSIST_F32}); graph tokens == eager; ax_matmul launches "
                  f"{want['ax_matmul']} "
              f"(= {n_ax} x {T}) eager and executed by the graph; eager {_speed(stats_e, T)}; "
              f"graph {_speed(stats_g, T)} [{card}]", flush=True)

        if name == "gemma3-27b":
            # decode crosses the 1024-row ring of the local layers
            long = family_prompt(cfg, 1, LONG_PROMPT + 6, dev, seed=6)["tokens"]
            rel = forward_consistency(params, cfg, long, f"{name} 1023-token ring")
            p_long = family_prompt(cfg, B, LONG_PROMPT, dev, seed=7)
            st_l = {}
            out_l = generate(params, p_long, cfg, ServeConfig(max_new_tokens=T, cuda_graphs=False),
                             stats=st_l).cpu()
            for _ in range(2):          # the second run replays the captured step
                got_l, st_lg, _, _ = graph_run(lambda st: generate(
                    params, p_long, cfg, ServeConfig(max_new_tokens=T), stats=st).cpu())
                if not torch.equal(out_l, got_l):
                    fail(f"{name}: 1020-token serve, graph tokens != eager")
            row.update(ring_rel=rel, long_eager=st_l, long_graph=st_lg)
            print(f"family {name}: a 1023-token prefill and decode steps at positions "
                  f"1023-1025 (ring row 1024 % 1024 = 0 overwritten) vs the full forward: "
                  f"worst relative diff {rel:.3g}; a 1020-token serve (decode positions "
                  f"1020-1027 cross the ring) graph == eager; eager {_speed(st_l, T)}; graph "
                  f"{_speed(st_lg, T)} [{card}]", flush=True)

        if name in ("recurrentgemma-2b", "deepseek-moe-16b"):
            ctrl = AdaptiveController(SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                      AdaptiveConfig(drift_threshold=1e9), device=dev)
            ctrl.warmup()
            st_a = {}
            reset_launches()
            got = generate(params, prompts, cfg, ServeConfig(max_new_tokens=T, cuda_graphs=False),
                           adaptive=ctrl, stats=st_a).cpu()
            want_a = {"ax_matmul": n_ax, "ax_matmul_grid": n_ax * (T - 1)}
            if dict(LAUNCHES) != want_a or not torch.equal(got, eager) or ctrl.retunes:
                fail(f"{name} no-drift adaptive serve: launches {dict(LAUNCHES)} (want "
                     f"{want_a}), tokens equal the static serve's {torch.equal(got, eager)}, "
                     f"re-tunes {len(ctrl.retunes)}")
            row.update(adaptive=st_a, grid_launches=want_a["ax_matmul_grid"])
            print(f"family {name}: no-drift adaptive serve (eager) gives the static tokens; "
                  f"launches {want_a}; {_speed(st_a, T)} [{card}]", flush=True)

    # every launch above ran at a kernel shape reckoned from the config, and
    # families() holds each of these shapes against the plain version
    Ms = (B, B * S) + ((B * LONG_PROMPT,) if name == "gemma3-27b" else ())
    row["kernel_shapes"] = {
        "ax_matmul": family_kernel_shapes(cfg, name, Ms),
        "ax_matmul_grid": family_kernel_shapes(cfg, name, (B,)) if "adaptive" in row else {}}
    if seen != {k: set(v) for k, v in row["kernel_shapes"].items()}:
        fail(f"{name}: kernel shapes launched {seen}, reckoned from the config "
             f"{row['kernel_shapes']}")
    G.clear_programs()
    del params
    torch.cuda.empty_cache()
    return row


def families(dev, card: str, clock: float):
    """Phase 6e: the eight decoder-only configurations other than qwen2-72b
    (``family_serve``), then each kernel at every shape those serves
    launched, against its plain version.  Returns (rows, ax_matmul shape
    rows, ax_matmul_grid shape rows, ax_matmul launches by path,
    ax_matmul_grid launches by path)."""
    from repro_torch.configs import ARCHS

    names = [n for n in ARCHS if n != "qwen2-72b" and ARCHS[n].family != "encdec"]
    if sorted(names) != sorted(FAMILY_DEPTH):
        fail(f"the families phase covers {sorted(FAMILY_DEPTH)}, the port holds {sorted(ARCHS)}")
    rows = [family_serve(n, dev, card) for n in names]
    checked = {}
    for kernel in ("ax_matmul", "ax_matmul_grid"):
        shapes = {}
        for r in rows:
            for key, label in r["kernel_shapes"][kernel].items():
                shapes[key] = f"{shapes[key]}; {label}" if key in shapes else label
        checked[kernel] = main_shape_checks(
            dev, card, clock, grid_kernel=kernel == "ax_matmul_grid",
            shapes=[(label,) + key for key, label in sorted(shapes.items())])
    paths = {"families eager": sum(r["launches"] for r in rows),
             "families graph": sum(r["graph_launches"] for r in rows)}
    grid_paths = {"families no-drift": sum(r.get("grid_launches", 0) for r in rows)}
    return rows, checked["ax_matmul"], checked["ax_matmul_grid"], paths, grid_paths


# ---------------------------------------------------------------------------
# phase 6f: whisper-base, the encoder-decoder
# ---------------------------------------------------------------------------

W_FRAMES, W_TOKENS, W_T = 1500, 8, 16     # Whisper's 30-s window, decoder prompt, tokens


def whisper_kernel_shapes(cfg, B_: int, frames: int, tokens: int, modes=("prefill", "decode")):
    """{(M, K, N): label} of the kernel launches of ``cfg``'s approximate
    projections (``models.whisper.ax_projections``): encoder and cross
    rows B x frames, decoder rows B x tokens in a full forward and B at
    decode, padded as the dense path pads them."""
    from repro_torch.models.whisper import ax_projections

    rows = {"enc": B_ * frames, "cross": B_ * frames, "dec": B_ * tokens}
    shapes = {}
    for mode in modes:
        for stack, _, proj, K, N in ax_projections(cfg, mode):
            M = B_ if mode == "decode" else rows[stack]
            key = (_padded(M), _padded(K), _padded(N))
            shapes.setdefault(key, [f"whisper {stack} M={M}"]).append(proj)
    return {k: f"{v[0]} {'/'.join(dict.fromkeys(v[1:]))}" for k, v in shapes.items()}


def whisper_phase(dev, card: str, clock: float):
    """Phase 6f: whisper-base at its full published config (6 encoder and 6
    decoder layers, d_model 512, vocab 51865), random f32 weights from a
    seed, bf16 compute, SWAPPER ``kernel`` (the serve phase's policy): prefill
    + 3 decode steps vs the full forward (exact projections, f32, 1500
    frames: the encoder's and the cross-attention's non-causal attention
    over keys padded to 2048); B = 4 with 1500 seeded frames, 8 decoder
    tokens and 16 greedy tokens, eagerly and as a CUDA graph twice (equal
    tokens, the launches reckoned from the config, one capture then none);
    adaptive serving refused; then the kernel against its plain version at
    every shape the serves launched.  Returns (a row, the shape rows, the
    launches by path)."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import AxPolicy
    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.models import init_params
    from repro_torch.models.whisper import ax_projections
    from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy
    from repro_torch.serve import ServeConfig, generate
    from repro_torch.serve import graph as G

    cfg = dataclasses.replace(ARCHS["whisper-base"], ax=AxPolicy(backend="kernel"))
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    init_s = time.perf_counter() - t0
    n_pre, n_dec = len(ax_projections(cfg)), len(ax_projections(cfg, "decode"))
    if (n_pre, n_dec) != (18 + 24, 24):
        fail(f"whisper-base: {n_pre} approximate projections in a full forward and {n_dec} "
             f"at decode, expected 42 (18 encoder + 24 decoder) and 24")
    want = {"ax_matmul": n_pre + n_dec * (W_T - 1), "ax_matmul_grid": 0}
    row = dict(name="whisper-base", layers=cfg.n_layers, enc_layers=cfg.n_enc_layers,
               params_g=n_params / 1e9, ax_per_forward=n_pre, ax_per_decode=n_dec)
    with kernel_shapes() as seen:
        small = family_prompt(cfg, 2, 24, dev, seed=5, frames=W_FRAMES)
        row["decode_vs_full_rel"] = forward_consistency(
            params, cfg, small["tokens"], "whisper-base", extra={"frames": small["frames"]})
        prompts = family_prompt(cfg, B, W_TOKENS, dev, seed=1, frames=W_FRAMES)
        stats_e = {}
        reset_launches()
        eager = generate(params, prompts, cfg, ServeConfig(max_new_tokens=W_T, cuda_graphs=False),
                         stats=stats_e).cpu()
        if dict(LAUNCHES) != want:
            fail(f"whisper-base: launches in one eager serve {dict(LAUNCHES)}, expected {want} "
                 f"({n_pre} in the prefill + {n_dec} x {W_T - 1} decode steps)")
        if tuple(eager.shape) != (B, W_T) or int(eager.min()) < 0 or \
                int(eager.max()) >= cfg.vocab:
            fail(f"whisper-base: tokens out of range or misshapen: {tuple(eager.shape)}")
        for run in range(2):
            got, stats_g, executed, caps = graph_run(lambda st: generate(
                params, prompts, cfg, ServeConfig(max_new_tokens=W_T), stats=st).cpu())
            if stats_g["path"] != "graph" or executed != want or caps != (1 if run == 0 else 0) \
                    or not torch.equal(got, eager):
                fail(f"whisper-base graph serve (run {run}): path {stats_g['path']}, executed "
                     f"{executed} (want {want}), captures {caps}, tokens equal the eager "
                     f"serve's {torch.equal(got, eager)}")
    ctrl = AdaptiveController(SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                              AdaptiveConfig(), device=dev)
    try:
        generate(params, prompts, cfg, ServeConfig(max_new_tokens=2), adaptive=ctrl)
        fail("whisper-base: an adaptive serve was not refused")
    except ValueError as e:
        if "JAX package fails" not in str(e):
            raise
    shapes = whisper_kernel_shapes(cfg, B, W_FRAMES, W_TOKENS)
    if seen["ax_matmul"] != set(shapes) or seen["ax_matmul_grid"]:
        fail(f"whisper-base: kernel shapes launched {seen}, reckoned from the config {shapes}")
    dec_ms = stats_g["decode_s"] * 1e3 / (W_T - 1)
    row.update(eager=dict(stats_e), graph=dict(stats_g), launches=want["ax_matmul"],
               graph_launches=executed["ax_matmul"], tokens=eager.tolist(), init_s=init_s,
               graph_decode_ms_per_step=dec_ms)
    print(f"whisper-base ({cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers, "
          f"{n_params / 1e9:.3f} G params f32, init {init_s:.2f} s): prefill + 3 decode steps "
          f"vs the full forward over {W_FRAMES} frames, worst relative diff "
          f"{row['decode_vs_full_rel']:.3g} (< 0.15, f32 tol {TOL_CONSIST_F32}); B={B}, "
          f"{W_FRAMES} frames, {W_TOKENS} decoder tokens, {W_T} greedy tokens: graph tokens == "
          f"eager; ax_matmul launches {want['ax_matmul']} (= {n_pre} + {n_dec} x {W_T - 1}) "
          f"eager and executed by the graph, captures 1 then 0; adaptive refused; eager "
          f"{_speed(stats_e, W_T)}; graph {_speed(stats_g, W_T)} [{card}]", flush=True)
    G.clear_programs()
    del params
    torch.cuda.empty_cache()
    rows = main_shape_checks(dev, card, clock, grid_kernel=False,
                             shapes=[(label,) + key for key, label in sorted(shapes.items())])
    paths = {"whisper eager": want["ax_matmul"], "whisper graph": executed["ax_matmul"]}
    return row, rows, paths


# ---------------------------------------------------------------------------
# phase 6g: training on one card
# ---------------------------------------------------------------------------

TRAIN_LR, TRAIN_WARMUP = 3e-3, 2
# card vs CPU, reduced qwen2 and deepseek-moe at 2 layers, f32, 5 AdamW
# steps, each card step from the CPU's state before it: losses and grad
# norms within TOL_TRAIN_STEP relative, and each parameter leaf's update
# within TOL_TRAIN_UPDATE of the CPU's, relative to the CPU's update (a
# step that leaves a leaf unchanged reads 1).  The same bounds hold the
# port's step to JAX's on the CPU (tests/test_torch_train.py), where one
# step read 1.06e-5 (loss), 3.7e-5 (grad norm) and 0.021 (update) through
# the SWAPPER projection, whose int8 codes flip on ulp-level differences.
# A step that meets a flip is held to TOL_TRAIN_STEP_FLIP: an int8
# activation code flip, shown to be a rounding flip (in the first
# projection that differs, each code one step apart and the CPU's
# x / scale within TOL_CODE_FLIP, relative, of a rounding boundary: read
# 0 to 5.6e-7), whose change later projections inherit (on an H100 80GB
# HBM3 at 700 W, one root flip in deepseek's SWAPPER step 4 became 6376
# differing codes: loss 1.3e-4, grad norm 1.65e-3, update 0.092 apart;
# qwen2's step 4, grad norm 1.0086e-4); or a MoE routing flip, allowed only on a near-tie
# (MOE_NEAR_TIE, as the ref phase), whose step's update is not held (the
# flipped token moves its experts' whole update).  The kernels themselves
# are held bit-exact at every train shape; this check holds the float
# path around them
TOL_TRAIN_STEP, TOL_TRAIN_UPDATE, TOL_TRAIN_STEP_FLIP = 1e-4, 0.1, 1e-2
TOL_CODE_FLIP = 1e-5
TRAIN_STEPS, TRAIN_ADAPTIVE_STEPS = 10, 4
DS_B, DS_S = 4, 256                      # deepseek at its widths: 1024 tokens a step
W_TRAIN_TOKENS = 64                      # whisper: 4 x 1500 frames, 64 target tokens


class FramesStream:
    """A ``SyntheticStream`` of decoder tokens and labels with seeded frame
    embeddings (bf16, the step's own seed) beside them: the whisper train
    batch, resumable from the step counter alone."""

    def __init__(self, stream, frames: int, d_model: int, seed: int = 0):
        self.stream, self.frames, self.d_model, self.seed = stream, frames, d_model, seed

    def next(self):
        import torch

        gen = torch.Generator().manual_seed(self.seed * 1000003 + self.stream.step)
        b = self.stream.next()
        B_ = b["tokens"].shape[0]
        fr = torch.randn((B_, self.frames, self.d_model), generator=gen).to(torch.bfloat16)
        return dict(b, frames=fr)

    def state(self):
        return self.stream.state()

    def restore(self, state):
        self.stream.restore(state)
        return self


def _train_diff(a, b) -> float:
    from repro_torch.train.optimizer import tree_leaves

    return max((x.float().cpu() - y.float().cpu()).abs().max().item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _update_gap(new, ref, start) -> float:
    """The largest over leaves of |(new - start) - (ref - start)| /
    |ref - start|: how far one step's update departs from the reference's."""
    from repro_torch.train.optimizer import tree_leaves

    gaps = []
    for x, y, p in zip(tree_leaves(new), tree_leaves(ref), tree_leaves(start)):
        p = p.float().cpu()
        dx, dy = x.float().cpu() - p, y.float().cpu() - p
        gaps.append(((dx - dy).norm() / dy.norm()).item())
    return max(gaps)


def _route_flips(cfg, cpu_routes, card_routes, label: str) -> int:
    """Tokens routed apart card vs CPU (``_route_recorder``'s records of
    the same forwards); each must be a near-tie of the CPU's probabilities
    (``MOE_NEAR_TIE``).  Returns how many."""
    import torch

    flips = 0
    for (pc, ic), (_, ig) in zip(cpu_routes, card_routes):
        for r in (ic != ig).any(-1).nonzero().flatten().tolist():
            top = torch.sort(pc[r], descending=True).values
            gap = (top[cfg.top_k - 1] - top[cfg.top_k]).item()
            print(f"{label}: MoE routing flip card vs CPU at token {r}: "
                  f"{ic[r].tolist()} vs {ig[r].tolist()}, top-k gap {gap:.3g}", flush=True)
            if gap > MOE_NEAR_TIE:
                fail(f"{label}: MoE routing differs card vs CPU away from a near-tie "
                     f"(gap {gap} > {MOE_NEAR_TIE})")
            flips += 1
    return flips


def _code_recorder():
    """Wrap ``quant.ax.quantize_rows`` so that each activation quantization
    keeps its int8 codes and its pre-rounding ``x / scale`` (the train
    card-vs-CPU check's code flips)."""
    from repro_torch.quant import ax as QA

    real, seen = QA.quantize_rows, []

    def rec(x, axis=-1):
        q, s = real(x, axis)
        if axis == -1:
            seen.append((q.detach().cpu(), (x / s).detach().float().cpu()))
        return q, s

    return QA, real, rec, seen


def _code_flips(cpu_codes, card_codes, label: str) -> int:
    """int8 activation codes that differ card vs CPU in one step.  In the
    first projection (in forward order) that differs, each must be a
    rounding flip: one step apart, the CPU's ``x / scale`` within
    ``TOL_CODE_FLIP`` (relative) of a rounding boundary; later projections
    inherit the change.  Returns how many codes differ."""
    if len(cpu_codes) != len(card_codes):
        fail(f"train card vs CPU {label}: {len(card_codes)} activation quantizations on "
             f"the card, {len(cpu_codes)} on the CPU")
    n = 0
    for (qc, rc), (qg, _) in zip(cpu_codes, card_codes):
        d = qc != qg
        if not bool(d.any()):
            continue
        if n == 0:
            step = (qc[d].int() - qg[d].int()).abs()
            r = rc[d].abs()
            dist = (r % 1 - 0.5).abs()
            print(f"train card vs CPU {label}: first int8 code flips: {int(d.sum())} codes, "
                  f"steps {sorted(set(step.tolist()))}, distance from a rounding boundary up "
                  f"to {(dist / r.clamp(min=1)).max().item():.3g} relative", flush=True)
            if not (bool((step == 1).all()) and
                    bool((dist <= TOL_CODE_FLIP * r.clamp(min=1)).all())):
                fail(f"train card vs CPU {label}: int8 codes differ away from a rounding "
                     f"boundary: steps {step.tolist()[:8]}, x / scale {rc[d].tolist()[:8]}")
        n += int(d.sum())
    return n


def train_card_vs_cpu(dev):
    """Reduced qwen2 and deepseek-moe (2 layers, f32) train 5 AdamW steps on
    the CPU; each step also runs on the card from the CPU's state before
    it, on the same batch, on the exact path and through the SWAPPER
    projection (``mxu``).  Returns {label: {"loss", "grad_norm", "update":
    the largest relative differences, "code_flips", "route_flips"}}."""
    from repro_torch.configs import ARCHS, ParallelConfig, reduced
    from repro_torch.configs.base import AxPolicy
    from repro_torch.models import blocks
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticStream, fresh_train_state,
                                   make_train_step)
    from repro_torch.train.optimizer import tree_map

    out = {}
    opt = AdamWConfig(lr=TRAIN_LR, warmup=TRAIN_WARMUP)
    real, rec, seen = _route_recorder()
    QA, q_real, q_rec, codes = _code_recorder()
    for name in ("qwen2-72b", "deepseek-moe-16b"):
        for ax in (None, AxPolicy(backend="mxu")):
            cfg = dataclasses.replace(reduced(ARCHS[name]), n_layers=2, compute_dtype="float32",
                                      ax=ax)
            label = f"{name} {'exact' if ax is None else 'swapper'}"
            step = make_train_step(cfg, ParallelConfig(remat="none"), opt)
            cpu = fresh_train_state(cfg, opt, seed=0, device="cpu")
            stream = SyntheticStream(DataConfig(cfg.vocab, 32, 4, seed=1, mode="arith"))
            row = {"loss": 0.0, "grad_norm": 0.0, "update": 0.0, "code_flips": 0,
                   "route_flips": 0}
            held = 0
            for i in range(5):
                b = stream.next()
                card = tree_map(lambda t: t.to(dev), cpu)
                blocks._route, QA.quantize_rows = rec, q_rec
                try:
                    seen.clear()
                    codes.clear()
                    new_cpu, mc = step(cpu, b)
                    n_cpu, c_cpu = len(seen), len(codes)
                    card, mg = step(card, b)
                finally:
                    blocks._route, QA.quantize_rows = real, q_real
                flips = _route_flips(cfg, seen[:n_cpu], seen[n_cpu:], f"train {label} step {i}")
                n_codes = _code_flips(codes[:c_cpu], codes[c_cpu:], f"{label} step {i}")
                gaps = {k: abs(float(mg[k]) / float(mc[k]) - 1) for k in ("loss", "grad_norm")}
                if not all(math.isfinite(float(mg[k])) for k in gaps):
                    fail(f"train card vs CPU {label}: step {i} metrics {mg}")
                tol = TOL_TRAIN_STEP_FLIP if flips or n_codes else TOL_TRAIN_STEP
                upd = None if flips else _update_gap(card["params"], new_cpu["params"],
                                                     cpu["params"])
                if max(gaps.values()) > tol or (upd is not None and upd > TOL_TRAIN_UPDATE):
                    fail(f"train card vs CPU {label} step {i}: relative loss / grad norm "
                         f"differences {gaps} (tol {tol}), update {upd} "
                         f"(tol {TOL_TRAIN_UPDATE}), int8 code flips {n_codes}, routing "
                         f"flips {flips}")
                for k, v in gaps.items():
                    row[k] = max(row[k], v)
                row["update"] = max(row["update"], upd or 0.0)
                row["code_flips"] += n_codes
                row["route_flips"] += flips
                held += upd is not None
                cpu = new_cpu
            if not held:
                fail(f"train card vs CPU {label}: every step met a routing flip")
            out[label] = row
            print(f"train card vs CPU, reduced {label} (2 layers, f32, 5 AdamW steps, each "
                  f"from the CPU's state): relative loss diff {row['loss']:.4g}, grad norm "
                  f"{row['grad_norm']:.4g} (tol {TOL_TRAIN_STEP}, {TOL_TRAIN_STEP_FLIP} in a "
                  f"step with a flip), update {row['update']:.4g} (tol "
                  f"{TOL_TRAIN_UPDATE}, {held} of 5 steps held), int8 code flips "
                  f"{row['code_flips']}, MoE routing flips {row['route_flips']}", flush=True)
            del cpu, card
    return out


def _timed_steps(step, state, batches, *args):
    """Run ``step`` over ``batches``; returns (state, losses, ms per step)."""
    import torch

    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        state, m = step(state, b, *args)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    return state, [float(x) for x in losses], ms


def train_phase(dev, card: str, clock: float):
    """Phase 6g: training on the card.  Card vs CPU on the reduced configs
    (``train_card_vs_cpu``); then at published widths with ``--ax``
    semantics (``mxu``, route T): whisper-base (full config; 4 x 1500
    frames, 64 target tokens) and deepseek-moe-16b (depth 2: its dense
    leading layer and one MoE layer) each take 10 steps: finite losses,
    ``ax_matmul`` launches = projections a forward x steps (the backward
    launches none); deepseek takes 4 adaptive steps, the policy changed
    between steps 2 and 3 (telemetry from every target, ``ax_matmul_grid``
    launches = projections x steps, nothing rebuilt); ``run_supervised`` on
    whisper-base with a ``SimulatedFailure`` at step 6 of 12
    (``ckpt_every=4``) ends within 1e-5 relative of the uninterrupted run;
    then each kernel against its plain version at every shape the steps
    launched.  Returns (rows, ax_matmul shape rows, ax_matmul_grid shape
    rows, launches by path, grid launches by path)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, ParallelConfig
    from repro_torch.configs.base import AxPolicy
    from repro_torch.kernels import _build
    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.models import transformer, whisper
    from repro_torch.runtime import SwapPolicy
    from repro_torch.runtime.telemetry import records_to_host
    from repro_torch.train import (AdamWConfig, DataConfig, FaultConfig, SimulatedFailure,
                                   SyntheticStream, fresh_train_state, make_train_step,
                                   run_supervised)
    from repro_torch.train.optimizer import tree_leaves

    rows = {"card_vs_cpu": train_card_vs_cpu(dev)}
    opt = AdamWConfig(lr=1e-4, warmup=2)
    par = ParallelConfig(remat="none")
    ax = AxPolicy(backend="mxu")
    nvcc0, libs0 = _build.NVCC_RUNS["count"], len(_build._LOADED)
    paths, grid_paths = {}, {}
    with kernel_shapes() as seen:
        # whisper-base, 10 static steps
        wcfg = dataclasses.replace(ARCHS["whisper-base"], ax=ax)
        wstream = lambda: FramesStream(SyntheticStream(DataConfig(  # noqa: E731
            wcfg.vocab, W_TRAIN_TOKENS, B, seed=2)), W_FRAMES, wcfg.d_model, seed=2)
        n_w = len(whisper.ax_projections(wcfg, "train"))
        wstep = make_train_step(wcfg, par, opt)
        state = fresh_train_state(wcfg, opt, seed=0, device=dev)
        ws = wstream()
        batches = [ws.next() for _ in range(TRAIN_STEPS)]
        step_0 = wstep(state, batches[0])           # the first step, outside the timing
        reset_launches()
        state, losses, w_ms = _timed_steps(wstep, step_0[0], batches[1:])
        want = {"ax_matmul": n_w * (TRAIN_STEPS - 1), "ax_matmul_grid": 0}
        losses = [float(step_0[1]["loss"])] + losses
        if dict(LAUNCHES) != want or not all(math.isfinite(x) for x in losses):
            fail(f"whisper-base train: launches {dict(LAUNCHES)} (want {want}: {n_w} a forward, "
                 f"none in the backward), losses {losses}")
        w_tok = B * W_TRAIN_TOKENS / w_ms * 1e3
        rows["whisper"] = dict(steps=TRAIN_STEPS, ms_per_step=w_ms, target_tokens_per_s=w_tok,
                               frames_per_s=B * W_FRAMES / w_ms * 1e3, losses=losses,
                               ax_per_forward=n_w)
        paths["train whisper (9 timed steps)"] = want["ax_matmul"]
        print(f"train whisper-base (full config, --ax mxu, B={B} x {W_FRAMES} frames, "
              f"{W_TRAIN_TOKENS} target tokens, {TRAIN_STEPS} steps): losses {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, all finite; {w_ms:.1f} ms/step over steps 2-{TRAIN_STEPS}, "
              f"{w_tok:.0f} target tokens/s, {B * W_FRAMES / w_ms * 1e3:.0f} frames/s; "
              f"ax_matmul launches {want['ax_matmul']} (= {n_w} x {TRAIN_STEPS - 1}, none in "
              f"the backward) [{card}]", flush=True)
        del state, step_0, batches

        # deepseek-moe-16b at depth 2, 10 static steps, then 4 adaptive ones
        dcfg = dataclasses.replace(ARCHS["deepseek-moe-16b"], n_layers=2, ax=ax)
        n_d = len(transformer.ax_projections(dcfg))
        dstream = SyntheticStream(DataConfig(dcfg.vocab, DS_S, DS_B, seed=3, mode="arith"))
        batches = [dstream.next() for _ in range(TRAIN_STEPS + TRAIN_ADAPTIVE_STEPS)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state = fresh_train_state(dcfg, opt, seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(state["params"]))
        state_gb = 4 * 3 * n_params / 1e9
        init_s = time.perf_counter() - t0
        dstep = make_train_step(dcfg, par, opt)
        state, m0 = dstep(state, batches[0])
        reset_launches()
        state, losses, d_ms = _timed_steps(dstep, state, batches[1:TRAIN_STEPS])
        losses = [float(m0["loss"])] + losses
        want = {"ax_matmul": n_d * (TRAIN_STEPS - 1), "ax_matmul_grid": 0}
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        if dict(LAUNCHES) != want or not all(math.isfinite(x) for x in losses):
            fail(f"deepseek-moe-16b train: launches {dict(LAUNCHES)} (want {want}), "
                 f"losses {losses}")
        d_tok = DS_B * DS_S / d_ms * 1e3
        rows["deepseek"] = dict(steps=TRAIN_STEPS, ms_per_step=d_ms, tokens_per_s=d_tok,
                                losses=losses, params_g=n_params / 1e9, ax_per_forward=n_d,
                                peak_gb=peak)
        paths["train deepseek (9 timed steps)"] = want["ax_matmul"]
        print(f"train deepseek-moe-16b (2 layers {'/'.join(dcfg.layer_kinds())}, "
              f"{n_params / 1e9:.3f} G params, {state_gb:.1f} GB of f32 parameters and AdamW "
              f"moments, init {init_s:.1f} s, peak allocated {peak:.1f} GB; --ax mxu, B={DS_B} x "
              f"S={DS_S}, {TRAIN_STEPS} steps): losses {losses[0]:.4f} -> {losses[-1]:.4f}, all "
              f"finite; {d_ms:.1f} ms/step over steps 2-{TRAIN_STEPS}, {d_tok:.0f} tokens/s; "
              f"ax_matmul launches {want['ax_matmul']} (= {n_d} x {TRAIN_STEPS - 1}) [{card}]",
              flush=True)

        astep = make_train_step(dcfg, par, opt, adaptive=True)
        pol_a = SwapPolicy.from_ax_policy(ax)
        pol_b = SwapPolicy.from_ax_policy(dataclasses.replace(ax, swap_bit=5, swap_value=1))
        dyns = [p.dyn_tree(ax.targets, device=dev) for p in (pol_a, pol_a, pol_b, pol_b)]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a_losses, ns = [], []
        for i in range(TRAIN_ADAPTIVE_STEPS):
            state, m = astep(state, batches[TRAIN_STEPS + i], dyns[i])
            rec = records_to_host(m["ax_telemetry"])
            ns.append({t: int(np.sum(r["n"])) for t, r in rec.items()})
            a_losses.append(float(m["loss"]))
        a_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_ADAPTIVE_STEPS
        want = {"ax_matmul": 0, "ax_matmul_grid": n_d * TRAIN_ADAPTIVE_STEPS}
        rebuilt = (_build.NVCC_RUNS["count"] - nvcc0, len(_build._LOADED) - libs0)
        if dict(LAUNCHES) != want or rebuilt != (0, 0) or not all(
                sorted(n) == sorted(ax.targets) and min(n.values()) > 0 for n in ns) or \
                not all(math.isfinite(x) for x in a_losses):
            fail(f"deepseek adaptive train: launches {dict(LAUNCHES)} (want {want}), rebuilt "
                 f"{rebuilt}, telemetry n {ns}, losses {a_losses}")
        rows["deepseek_adaptive"] = dict(steps=TRAIN_ADAPTIVE_STEPS, ms_per_step=a_ms,
                                         tokens_per_s=DS_B * DS_S / a_ms * 1e3, n=ns,
                                         losses=a_losses)
        grid_paths["train deepseek adaptive"] = want["ax_matmul_grid"]
        # the MoE dispatch sums with index_add_ (atomics on the card): is a
        # step bit-deterministic? (printed, not gated)
        twice = [dstep(state, batches[0])[0]["params"] for _ in range(2)]
        moe_equal = all(torch.equal(x, y) for x, y in zip(tree_leaves(twice[0]),
                                                          tree_leaves(twice[1])))
        moe_diff = _train_diff(twice[0], twice[1])
        rows["deepseek"].update(step_bit_equal=moe_equal, step_rerun_max_diff=moe_diff)
        del twice
        print(f"train deepseek-moe-16b: one step run twice from the same state and batch: "
              f"bit-equal {moe_equal}, max parameter diff {moe_diff:.3g}", flush=True)
        print(f"train deepseek-moe-16b adaptive ({TRAIN_ADAPTIVE_STEPS} steps, policy "
              f"{pol_a.describe()} then {pol_b.describe()} from step 3): telemetry n per "
              f"target {ns}; ax_matmul_grid launches {want['ax_matmul_grid']} (= {n_d} x "
              f"{TRAIN_ADAPTIVE_STEPS}); no nvcc run, no new library; {a_ms:.1f} ms/step "
              f"(telemetry read each step), {DS_B * DS_S / a_ms * 1e3:.0f} tokens/s [{card}]",
              flush=True)
        del state, batches, m, m0
        torch.cuda.empty_cache()

        # supervised restart on whisper-base
        wstep = make_train_step(wcfg, par, opt)
        params0 = fresh_train_state(wcfg, opt, seed=0, device=dev)["params"]

        def make_state():
            from repro_torch.train import init_train_state
            return init_train_state(params0, opt)

        fired = []

        def chaos(i):
            if i == 6 and not fired:
                fired.append(i)
                raise SimulatedFailure("node died")

        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            reset_launches()
            t0 = time.perf_counter()
            s_ref, log_ref = run_supervised(make_state, wstep, wstream(), 12,
                                            FaultConfig(ckpt_dir=f"{tmp}/ref", ckpt_every=4))
            ref_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            s_chaos, log_chaos = run_supervised(make_state, wstep, wstream(), 12,
                                                FaultConfig(ckpt_dir=f"{tmp}/chaos",
                                                            ckpt_every=4), chaos=chaos)
            chaos_s = time.perf_counter() - t0
        launched = dict(LAUNCHES)["ax_matmul"]
        pairs = list(zip(tree_leaves(s_ref["params"]), tree_leaves(s_chaos["params"])))
        close = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6) for a, b in pairs)
        bit_equal = all(torch.equal(a, b) for a, b in pairs)
        rel = max(((a - b).abs().max() / a.abs().max().clamp(min=1e-12)).item() for a, b in pairs)
        if log_ref["restarts"] != 0 or log_chaos["restarts"] != 1 or not close or \
                launched != n_w * (12 + 12 + 2):
            fail(f"supervised restart: restarts {log_ref['restarts']}/{log_chaos['restarts']}, "
                 f"within 1e-5 relative {close} (worst {rel}), launches {launched} (want "
                 f"{n_w * 26})")
        rows["restart"] = dict(bit_equal=bit_equal, worst_rel=rel, ref_s=ref_s, chaos_s=chaos_s)
        paths["train supervised restart"] = launched
        print(f"supervised restart (whisper-base, 12 steps, ckpt_every 4, SimulatedFailure at "
              f"step 6): 1 restart, the steps 5-6 redone from the step-4 checkpoint; final "
              f"parameters within 1e-5 relative of the uninterrupted run (worst {rel:.3g}), "
              f"bit-equal: {bit_equal}; walls {ref_s:.1f} s and {chaos_s:.1f} s [{card}]",
              flush=True)
        del s_ref, s_chaos, params0, pairs
        torch.cuda.empty_cache()

    shapes = whisper_kernel_shapes(wcfg, B, W_FRAMES, W_TRAIN_TOKENS, modes=("train",))
    dshapes = {}
    for _, proj, K, N in transformer.ax_projections(dcfg):
        key = (_padded(DS_B * DS_S), _padded(K), _padded(N))
        dshapes.setdefault(key, f"deepseek train M={DS_B * DS_S} {proj}")
    if seen["ax_matmul"] != set(shapes) | set(dshapes) or seen["ax_matmul_grid"] != set(dshapes):
        fail(f"train: kernel shapes launched {seen}, reckoned {shapes} and {dshapes}")
    shapes.update(dshapes)
    ax_rows = main_shape_checks(dev, card, clock, grid_kernel=False,
                                shapes=[(label,) + k for k, label in sorted(shapes.items())])
    grid_rows = main_shape_checks(dev, card, clock, grid_kernel=True,
                                  shapes=[(label,) + k for k, label in sorted(dshapes.items())])
    return rows, ax_rows, grid_rows, paths, grid_paths


# ---------------------------------------------------------------------------
# phase 4c: the fleet mesh
# ---------------------------------------------------------------------------

MESH_B, MESH_RANKS, MESH_SLOTS, MESH_N = 8, 2, 8, 12


def _mesh_model(dev):
    """The serve phase's model: qwen2-72b at its published widths, 2
    layers, random weights from seed 0, ``mxu`` (route T of
    ``mul8s_trunc0_4``)."""
    from repro_torch.configs import qwen2_72b
    from repro_torch.configs.base import AxPolicy
    from repro_torch.models import init_params

    cfg = dataclasses.replace(qwen2_72b, n_layers=L, ax=AxPolicy(backend="mxu"))
    return cfg, init_params(cfg, seed=0, device=dev)


def _mesh_inputs(cfg):
    """B = 8 seeded prompts of S tokens; 12 seeded requests (prompts of 5-32
    tokens, budgets 1-T) for the drains."""
    import numpy as np
    import torch

    prompts = torch.randint(0, cfg.vocab, (MESH_B, S),
                            generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(19)
    trace = [(rng.integers(0, cfg.vocab, int(rng.integers(5, 33))).astype(np.int32),
              int(rng.integers(1, T + 1))) for _ in range(MESH_N)]
    return prompts, trace


def _mesh_ctrl(cfg, dev):
    """A controller that never re-tunes, its observed records kept in
    ``ctrl.seen``."""
    import copy

    from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy

    ctrl = AdaptiveController(SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                              AdaptiveConfig(drift_threshold=1e9), device=dev)
    ctrl.warmup()
    ctrl.seen = []
    observe = ctrl.observe

    def keep(records):
        ctrl.seen.append(copy.deepcopy(records))
        return observe(records)

    ctrl.observe = keep
    return ctrl


def _mesh_serve(params, cfg, prompts, ctrl, mesh=None, fused=True):
    """One adaptive serve of T tokens: (tokens on the host, stats, executed
    launches, captures)."""
    from repro_torch.serve import ServeConfig, generate

    out, stats, executed, caps = graph_run(
        lambda st: generate(params, {"tokens": prompts}, cfg,
                            ServeConfig(max_new_tokens=T, fused=fused), adaptive=ctrl,
                            mesh=mesh, stats=st))
    return out.cpu(), stats, executed, caps


def _mesh_drain(params, cfg, trace, ctrl, mesh=None):
    """A token-mode drain of the requests over MESH_SLOTS slots: ({rid:
    tokens}, wall)."""
    import torch

    from repro_torch.fleet import BatcherConfig, ContinuousBatcher, Request

    bat = ContinuousBatcher(params, cfg, BatcherConfig(
        n_slots=MESH_SLOTS, prompt_buckets=(16, 32), new_token_bucket=T, token_granular=True),
        adaptive=ctrl, mesh=mesh)
    for rid, (p, n) in enumerate(trace):
        bat.submit(Request(rid, p.copy(), n))
    sync = torch.cuda.synchronize if bat.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    done = bat.run()
    sync()
    if sorted(c.rid for c in done) != list(range(MESH_N)) or \
            bat.stats["decode_retraces_post_warmup"] != 0:
        fail(f"mesh drain: completions {sorted(c.rid for c in done)}, retraces "
             f"{bat.stats['decode_retraces_post_warmup']}")
    return {c.rid: [int(t) for t in c.tokens] for c in done}, time.perf_counter() - t0


def _records_equal(a, b) -> bool:
    return set(a) == set(b) and all(
        set(a[t]) == set(b[t]) and all(a[t][k].dtype == b[t][k].dtype and
                                       (a[t][k] == b[t][k]).all() for k in b[t])
        for t in b)


def _first_gap(a, b):
    """The first index where two token lists differ (None when equal)."""
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def _gloo_card_probe(group, dev) -> dict:
    """Which ``gloo`` collectives take card tensors (each rank runs the same
    calls; an unsupported one raises before it communicates)."""
    import torch
    import torch.distributed as dist

    t = torch.arange(3, dtype=torch.int64, device=dev) + dist.get_rank()
    calls = {
        "all_reduce SUM": lambda: dist.all_reduce(t.clone(), group=group),
        "all_reduce MAX": lambda: dist.all_reduce(t.clone(), op=dist.ReduceOp.MAX,
                                                  group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(
            dist.get_world_size(group))], t, group=group),
        "broadcast": lambda: dist.broadcast(t.clone(), src=0, group=group),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[name] = "card tensors taken"
        except Exception as e:          # recorded: the port stages gloo through the host
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"
    return out


def mesh_rank(rank, mesh, ref_drain):
    """One of the two ``gloo`` ranks sharing the card (phase 4c): this
    rank's solo serve of its half of the batch, the mesh serve of all of
    it, a policy update, the 2-rank drain; rank 0 also the single-process
    unrolled loop over the whole batch and the top-2 margins where tokens
    differ.  Everything numpy or plain Python."""
    import torch

    from repro_torch.core import SwapConfig
    from repro_torch.fleet import collect
    from repro_torch.kernels import _build
    from repro_torch.serve import graph as G

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc0 = _build.NVCC_RUNS["count"]
    t0 = time.perf_counter()
    cfg, params = _mesh_model(torch.device(mesh.device_type, torch.cuda.current_device())
                              if mesh.device_type == "cuda" else torch.device("cpu"))
    dev = params["embed"]["w"].device
    if dev.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    probe = _gloo_card_probe(mesh.get_group("data"), dev)
    prompts, trace = _mesh_inputs(cfg)
    half = MESH_B // MESH_RANKS
    rows = slice(rank * half, (rank + 1) * half)
    solo_c = _mesh_ctrl(cfg, dev)
    solo = _mesh_serve(params, cfg, prompts[rows], solo_c)
    solo_again = _mesh_serve(params, cfg, prompts[rows], _mesh_ctrl(cfg, dev))
    # the collectives' share of the observed steps: host wall of aggregate_records
    agg = {"s": 0.0, "calls": 0}
    aggregate = collect.aggregate_records

    def timed(records, group=None):
        t = time.perf_counter()
        out = aggregate(records, group)
        agg["s"] += time.perf_counter() - t
        agg["calls"] += 1
        return out

    collect.aggregate_records = timed
    mesh_c = _mesh_ctrl(cfg, dev)
    meshed = _mesh_serve(params, cfg, prompts, mesh_c, mesh=mesh)
    collect.aggregate_records = aggregate
    caps0, nvcc1 = sum(G.CAPTURES.values()), _build.NVCC_RUNS["count"]
    mesh_c.policy.set_config("mlp", SwapConfig("B", 5, 1))
    updated = _mesh_serve(params, cfg, prompts, mesh_c, mesh=mesh)
    update = dict(captures=sum(G.CAPTURES.values()) - caps0,
                  nvcc=_build.NVCC_RUNS["count"] - nvcc1, path=updated[1]["path"],
                  changed=not torch.equal(updated[0], meshed[0]))
    drain, drain_wall = _mesh_drain(params, cfg, trace, _mesh_ctrl(cfg, dev), mesh=mesh)
    # the single-process unrolled adaptive loop (stepwise, eager) over this
    # rank's rows: the computation the rank's block of the mesh serve makes
    unrolled = _mesh_serve(params, cfg, prompts[rows], _mesh_ctrl(cfg, dev), fused=False)
    res = dict(probe=probe, unrolled_equal=bool(torch.equal(unrolled[0], meshed[0][rows])),
               unrolled_path=unrolled[1]["path"], init_s=init_s, nvcc=_build.NVCC_RUNS["count"] - nvcc0,
               solo=solo[0].numpy(), solo_records=solo_c.seen, solo_exec=solo[2],
               solo_stats=solo_again[1], solo_again=torch.equal(solo[0], solo_again[0]),
               tokens=meshed[0].numpy(), records=mesh_c.seen[:T - 1], exec=meshed[2],
               caps=meshed[3], stats=meshed[1], agg=agg, update=update, drain=drain,
               drain_wall=drain_wall,
               telemetry={t: (int(x.stats.n), int(x.stats.sum_abs), int(x.stats.count_neq),
                              int(x.stats.max_abs))
                          for t, x in solo_c.telemetry.targets.items()},
               mesh_telemetry=None)
    # the fleet telemetry of the first mesh serve alone (before the update)
    fleet = _mesh_ctrl(cfg, dev)
    for rec in mesh_c.seen[:T - 1]:
        fleet.observe(rec)
    res["mesh_telemetry"] = {t: (int(x.stats.n), int(x.stats.sum_abs), int(x.stats.count_neq),
                                 int(x.stats.max_abs))
                             for t, x in fleet.telemetry.targets.items()}
    if rank == 0:
        # the same loop over all 8 rows in one process: its prefill runs over
        # 8 rows where each rank's runs over 4
        full = _mesh_serve(params, cfg, prompts, _mesh_ctrl(cfg, dev), fused=False)[0]
        res["unrolled"] = full.numpy()
        res["margins"] = {}
        for b in range(MESH_B):
            j = _first_gap(meshed[0][b].tolist(), full[b].tolist())
            if j is not None:
                seq = torch.cat([prompts[b], full[b, :j]]).to(dev)
                res["margins"][f"serve {b}"] = (j, _margin(params, cfg, seq))
        for rid, want in ref_drain.items():
            j = _first_gap(drain[rid], want)
            if j is not None:
                seq = torch.tensor(list(trace[rid][0]) + want[:j], device=dev)
                res["margins"][f"drain {rid}"] = (j, _margin(params, cfg, seq))
    from repro_torch.serve import graph as G2

    G2.clear_programs()
    return res


def mesh_phase(dev, card: str):
    """Phase 4c (module note): (a) a one-rank ``nccl`` world in this
    process, (b) two ``gloo`` ranks spawned on the card while this process
    holds no model.  Returns the executed launches of its paths and the
    phase's walls."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_fleet_mesh, spawn
    from repro_torch.runtime.telemetry import combine_records
    from repro_torch.serve import graph as G

    # (a) one nccl rank: the mesh path against the same serve without one
    t_a = time.perf_counter()
    mesh = make_fleet_mesh(1, device="cuda")
    if dist.get_backend() != "nccl" or tuple(mesh.shape) != (1,):
        fail(f"mesh: backend {dist.get_backend()}, shape {tuple(mesh.shape)}")
    cfg, params = _mesh_model(dev)
    prompts, trace = _mesh_inputs(cfg)
    plain_c, mesh_c = _mesh_ctrl(cfg, dev), _mesh_ctrl(cfg, dev)
    _mesh_serve(params, cfg, prompts, _mesh_ctrl(cfg, dev))   # the weight cache, the graph
    plain = _mesh_serve(params, cfg, prompts, plain_c)
    meshed = _mesh_serve(params, cfg, prompts, mesh_c, mesh=mesh)
    per_fwd = L * 4
    want_exec = {"ax_matmul": per_fwd, "ax_matmul_grid": per_fwd * (T - 1)}
    if not torch.equal(plain[0], meshed[0]) or meshed[1]["path"] != "graph" or \
            plain[2] != want_exec or meshed[2] != want_exec or meshed[3] != 0 or \
            len(mesh_c.seen) != T - 1 or \
            not all(_records_equal(a, b) for a, b in zip(mesh_c.seen, plain_c.seen)):
        fail(f"mesh 1-rank nccl: tokens equal {torch.equal(plain[0], meshed[0])}, path "
             f"{meshed[1]['path']}, executed {plain[2]} / {meshed[2]} (want {want_exec}), "
             f"captures {meshed[3]}, records equal "
             f"{[_records_equal(a, b) for a, b in zip(mesh_c.seen, plain_c.seen)]}")
    _mesh_drain(params, cfg, trace, _mesh_ctrl(cfg, dev))       # captures the token step
    ref_drain, wall_plain = _mesh_drain(params, cfg, trace, _mesh_ctrl(cfg, dev))
    mesh_drain, wall_mesh = _mesh_drain(params, cfg, trace, _mesh_ctrl(cfg, dev), mesh=mesh)
    if mesh_drain != ref_drain:
        fail(f"mesh 1-rank nccl drain: {sum(mesh_drain[r] != ref_drain[r] for r in ref_drain)} "
             f"of {MESH_N} requests differ from the drain without a mesh")
    dist.destroy_process_group()
    one = dict(serve_ms=(meshed[1]["prefill_s"] + meshed[1]["decode_s"]) * 1e3,
               plain_ms=(plain[1]["prefill_s"] + plain[1]["decode_s"]) * 1e3,
               drain_s=wall_mesh, plain_drain_s=wall_plain)
    print(f"mesh (a) one nccl rank, qwen2-72b x{L} B={MESH_B} S={S} T={T} (mxu, route T, "
          f"adaptive, graph): tokens, {T - 1} fleet records and executed launches "
          f"{meshed[2]} equal the serve without a mesh; serve {one['serve_ms']:.1f} ms "
          f"(no mesh {one['plain_ms']:.1f}); token drain of {MESH_N} requests over "
          f"{MESH_SLOTS} slots equal per request, {wall_mesh:.3f} s (no mesh "
          f"{wall_plain:.3f} s) [{card}]", flush=True)
    G.clear_programs()
    del params, plain, meshed
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    phase_a = t_b - t_a

    # (b) two gloo ranks sharing the card
    res = spawn(mesh_rank, MESH_RANKS, args=(ref_drain,), device="cuda", backend="gloo",
                timeout_s=600)
    phase_b = time.perf_counter() - t_b
    r0 = res[0]
    print(f"mesh (b) gloo with card tensors: {r0['probe']}", flush=True)
    problems = []
    for rank, r in enumerate(res):
        if r["nvcc"] != 0:
            problems.append(f"rank {rank}: {r['nvcc']} nvcc runs")
        if not r["solo_again"]:
            problems.append(f"rank {rank}: two solo serves differ")
        if not r["unrolled_equal"] or r["unrolled_path"] != "eager":
            problems.append(f"rank {rank}: its rows differ from the unrolled loop over them "
                            f"(path {r['unrolled_path']})")
        if r["stats"]["path"] != "graph" or r["solo_stats"]["path"] != "graph":
            problems.append(f"rank {rank}: paths {r['stats']['path']}/{r['solo_stats']['path']}")
        if r["exec"] != r["solo_exec"] or r["exec"] != want_exec:
            problems.append(f"rank {rank}: executed {r['exec']}, solo {r['solo_exec']}, "
                            f"want {want_exec}")
        if not np.array_equal(r["tokens"], res[0]["tokens"]):
            problems.append(f"rank {rank}: tokens differ from rank 0's")
        u = r["update"]
        if u["captures"] or u["nvcc"] or u["path"] != "graph":
            problems.append(f"rank {rank}: policy update {u}")
    tokens = r0["tokens"]
    half = MESH_B // MESH_RANKS
    solo_tok = np.concatenate([r["solo"] for r in res])
    if not np.array_equal(tokens, solo_tok):
        problems.append("mesh tokens differ from the ranks' solo serves")
    for i in range(T - 1):
        want = combine_records([r["solo_records"][i] for r in res])
        if not all(_records_equal(r["records"][i], want) for r in res):
            problems.append(f"step {i}: fleet records differ from combine_records")
    sums = {}
    for t in r0["telemetry"]:
        solo_t = [r["telemetry"][t] for r in res]
        sums[t] = (sum(s[0] for s in solo_t), sum(s[1] for s in solo_t),
                   sum(s[2] for s in solo_t), max(s[3] for s in solo_t))
        if any(r["mesh_telemetry"][t] != sums[t] for r in res):
            problems.append(f"{t}: fleet telemetry {r0['mesh_telemetry'][t]} != solo "
                            f"sums {sums[t]}")
    drain_eq = sum(r0["drain"][rid] == ref_drain[rid] for rid in ref_drain)
    if any(r["drain"] != r0["drain"] for r in res):
        problems.append("the ranks' drains differ")
    serve_eq = int(sum(np.array_equal(tokens[b], r0["unrolled"][b]) for b in range(MESH_B)))
    bad_margins = {k: v for k, v in r0["margins"].items() if v[1] >= TOL_BATCH}
    if bad_margins:
        problems.append(f"divergences at top-2 margins >= {TOL_BATCH}: {bad_margins}")
    if problems:
        fail("mesh (b) two gloo ranks: " + "; ".join(problems))
    stats = r0["stats"]
    agg = r0["agg"]
    share = agg["s"] / stats["decode_s"] if stats["decode_s"] else float("nan")
    two = dict(serve_ms=(stats["prefill_s"] + stats["decode_s"]) * 1e3,
               solo_ms=(r0["solo_stats"]["prefill_s"] + r0["solo_stats"]["decode_s"]) * 1e3,
               decode_ms_step=stats["decode_s"] * 1e3 / (T - 1),
               agg_ms=agg["s"] * 1e3 / max(agg["calls"], 1), agg_share=share,
               drain_s=r0["drain_wall"], init_s=r0["init_s"])
    print(f"mesh (b) two gloo ranks on one card, B={MESH_B} ({half} per rank): mesh tokens "
          f"== the ranks' solo serves and == the single-process unrolled adaptive loop over "
          f"each rank's rows (bit for bit); the same loop over all {MESH_B} rows in one "
          f"process (an 8-row prefill) gives {serve_eq} of {MESH_B} rows (the rest diverge "
          f"at top-2 margins "
          f"{ {k: round(v[1], 4) for k, v in r0['margins'].items() if k.startswith('serve')} } "
          f"< {TOL_BATCH}); {T - 1} fleet records == combine_records of the solo records; "
          f"telemetry (n, sum_abs, count_neq, max_abs) == the solo sums/max {sums}; executed "
          f"launches per rank {r0['exec']} == the solo half-batch serve's; a policy update: "
          f"captures 0, nvcc 0; 2-rank drain == 1-rank drain on {drain_eq} of {MESH_N} "
          f"requests (the rest below the margin bound) [{card}]", flush=True)
    print(f"mesh walls: (a) serve {one['serve_ms']:.1f} ms, drain {one['drain_s']:.3f} s; "
          f"(b) per rank: model init {two['init_s']:.1f} s, mesh serve {two['serve_ms']:.1f} ms "
          f"(solo half batch {two['solo_ms']:.1f} ms), decode {two['decode_ms_step']:.2f} "
          f"ms/step, aggregate_records {two['agg_ms']:.2f} ms per observed step = "
          f"{100 * share:.1f}% of the decode wall, drain {two['drain_s']:.3f} s (a capture "
          f"included); phase (a) "
          f"{phase_a:.1f} s, (b) {phase_b:.1f} s incl. spawn [{card}]", flush=True)
    paths = {"mesh 1-rank nccl": want_exec["ax_matmul"],
             "mesh 2-rank gloo (rank 0)": r0["exec"]["ax_matmul"]}
    grid_paths = {"mesh 1-rank nccl": want_exec["ax_matmul_grid"],
                  "mesh 2-rank gloo (rank 0)": r0["exec"]["ax_matmul_grid"]}
    return paths, grid_paths, dict(one=one, two=two, probe=r0["probe"], serve_equal=serve_eq,
                                   drain_equal=drain_eq)




# ---------------------------------------------------------------------------
# phase 4d: the sharded train step
# ---------------------------------------------------------------------------

TM_STEPS, TM_ADAPTIVE_STEPS = 4, 2
TM_RANKS = 2
TM_RESTART = (6, 2, 3)                   # steps, ckpt_every, the step that crashes
TOL_TM_STEP1 = TOL_TRAIN_STEP_FLIP       # step 1 against the one-card step (routing flips)
TOL_TM_RESTART = 1e-5
TM_METRICS = ("loss", "ce", "aux", "grad_norm")
COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
               "all_reduce")


TM_TP = ("c", "d")                       # the layouts with tensor parallelism
TM_ADAPTIVE = ("a", "c")                 # + 2 adaptive steps, the policy changed between
TM_REMAT = ("b", "d")                    # + a remat="layer" step from step 1's state


def _tm_layouts(remat: bool = False):
    """(label, mesh shape, axes, ParallelConfig) of the phase: (a) FSDP over
    ``("data",)`` (JAX's rules need ``dp_only`` on a mesh without
    ``"model"``), (b) the expert all-to-all over ``("data", "model")`` =
    (1, 2) with ``dp_only`` + ``ep`` (32 of the 64 experts a rank), (c)
    tensor parallelism over ``("data", "model")`` = (1, 2) with ``ep`` (the
    heads, ``ff`` and vocab split, the rank's experts sliced from the
    replicated dispatch), (d) (c) with ``seq_shard`` (the residual on its
    seq shard, the expert all-to-all over the token shards).  ``remat``:
    also (b) and (d) with ``remat="layer"``, whose recomputed layers run
    their collectives in the backward, on autograd's device thread."""
    from repro_torch.configs import ParallelConfig

    out = [("a", (2,), ("data",), ParallelConfig(dp_only=True, fsdp=True, remat="none")),
           ("b", (1, 2), ("data", "model"), ParallelConfig(dp_only=True, ep=True,
                                                           remat="none")),
           ("c", (1, 2), ("data", "model"), ParallelConfig(ep=True, remat="none")),
           ("d", (1, 2), ("data", "model"), ParallelConfig(seq_shard=True, ep=True,
                                                           remat="none"))]
    if remat:
        out += [(f"{lb} remat", shape, axes, dataclasses.replace(par, remat="layer"))
                for lb, shape, axes, par in out if lb in TM_REMAT]
    return out


def _tm_configs():
    """deepseek-moe-16b at its published widths, depth 2, ``mxu``; the
    reduced deepseek and the reduced qwen2 in f32 on the exact path (the
    deepseek's capacity drops nothing; qwen2's one kv head splits inside a
    head over two ranks)."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import AxPolicy

    big = dataclasses.replace(ARCHS["deepseek-moe-16b"], n_layers=2,
                              ax=AxPolicy(backend="mxu"))
    small = {n: dataclasses.replace(reduced(ARCHS[n]), n_layers=2, compute_dtype="float32",
                                    ax=None) for n in ("deepseek-moe-16b", "qwen2-72b")}
    return big, small


def _tm_tp_shapes(cfg, M: int, n: int, who: str = "deepseek train TP") -> dict:
    """{(M, K, N): label} of the kernel launches of ``cfg``'s approximate
    projections on a rank of ``n`` tensor-parallel ranks: the output
    projections (``out``) split over K, the others over N."""
    from repro_torch.models.transformer import ax_projections

    shapes = {}
    for _, proj, K, N in ax_projections(cfg):
        K, N = (K // n, N) if proj.endswith(" out") else (K, N // n)
        shapes.setdefault((_padded(M), _padded(K), _padded(N)), f"{who} M={M} {proj}")
    return shapes


def _tm_batches(cfg, n: int, b: int, s: int, seed: int):
    from repro_torch.train import DataConfig, SyntheticStream

    stream = SyntheticStream(DataConfig(cfg.vocab, s, b, seed=seed, mode="arith"))
    return [stream.next() for _ in range(n)]


def _tm_flat(tree):
    from repro_torch.launch.mesh import tree_paths

    paths, leaves = tree_paths(tree)
    return {p: v.detach().float().cpu().numpy() for p, v in zip(paths, leaves)}


@contextlib.contextmanager
def _collective_timer():
    """Host wall of each collective the step issues, the card synchronised
    before and after it (``gloo`` stages card tensors through the host, so
    it waits for the stream anyway)."""
    import torch
    import torch.distributed as dist

    acc = {"s": 0.0, "calls": 0}
    real = {n: getattr(dist, n) for n in COLLECTIVES}

    def wrap(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc["s"] += time.perf_counter() - t
            acc["calls"] += 1
            return out
        return call

    for n, fn in real.items():
        setattr(dist, n, wrap(fn))
    try:
        yield acc
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)


def _gloo_train_probe(dev) -> dict:
    """The collectives of the sharded step on card tensors over ``gloo``,
    their values checked (each rank runs the same calls)."""
    import torch
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.arange(2 * n, dtype=torch.float32, device=dev) + 10 * r
    out = {}
    # tensor parallelism: the amax all-reduce (MAX, f32), the int32 partial
    # sums (SUM) and their reduce-scatter over seq
    mx = torch.tensor([1.0 + r, 5.0 - r], device=dev)
    dist.all_reduce(mx, op=dist.ReduceOp.MAX)
    out["all_reduce MAX f32"] = mx.cpu().tolist() == [float(n), 5.0]
    xi = torch.arange(2 * n, dtype=torch.int32, device=dev) + (1 << 28) * r
    si = xi.clone()
    dist.all_reduce(si)
    want = sum(torch.arange(2 * n, dtype=torch.int64) + (1 << 28) * k for k in range(n))
    out["all_reduce SUM int32"] = torch.equal(si.cpu().to(torch.int64), want)
    ri = torch.empty(2, dtype=torch.int32, device=dev)
    dist.reduce_scatter_tensor(ri, xi)
    out["reduce_scatter_tensor int32"] = torch.equal(ri.cpu().to(torch.int64),
                                                     want[2 * r:2 * r + 2])
    g = torch.empty(2 * n * n, device=dev)
    dist.all_gather_into_tensor(g, x)
    out["all_gather_into_tensor"] = torch.equal(g.cpu(), torch.cat(
        [torch.arange(2 * n, dtype=torch.float32) + 10 * k for k in range(n)]))
    rs = torch.empty(2, device=dev)
    dist.reduce_scatter_tensor(rs, x)
    out["reduce_scatter_tensor"] = torch.equal(rs.cpu(), sum(
        torch.arange(2 * n, dtype=torch.float32)[2 * r:2 * r + 2] + 10 * k for k in range(n)))
    a2a = torch.empty_like(x)
    dist.all_to_all_single(a2a, x)
    out["all_to_all_single"] = torch.equal(a2a.cpu(), torch.cat(
        [torch.arange(2 * r, 2 * r + 2, dtype=torch.float32) + 10 * k for k in range(n)]))
    return out


KSPLIT_K, KSPLIT_N = 29568, 8192          # qwen2-72b's mlp out


def _ksplit_card(dev, mesh) -> dict:
    """The SWAPPER projection split over K on the two ranks against the
    one-card call (each rank makes both from one seed, on the card) at
    qwen2-72b's ``mlp out`` shape, K 29568 -> 14784 a rank, N 8192, bf16,
    ``mxu``: ``ax_dense`` and ``ax_dense_dyn`` (a triple, the grid kernel),
    4 and 512 rows, the int32 sums all-reduced and, at 512 rows,
    reduce-scattered over ``seq``.  {check: bit-equal}."""
    import torch

    from repro_torch.configs import ParallelConfig
    from repro_torch.configs.base import AxPolicy
    from repro_torch.quant.ax import ax_dense, ax_dense_dyn
    from repro_torch.train import distributed as D

    tp = D.train_mesh(mesh, ParallelConfig(remat="none")).tp
    tp_seq = D.TensorParallel(tp.group, tp.index, tp.n, seq=True)
    gen = torch.Generator(device=dev).manual_seed(21)
    w = (torch.randn((KSPLIT_K, KSPLIT_N), generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    pol = AxPolicy(backend="mxu")
    trip = torch.tensor([1, 3, 0], dtype=torch.int32, device=dev)
    k0, k1 = tp.block(KSPLIT_K)
    out = {}
    with torch.no_grad():
        for rows in (4, 512):
            x = torch.randn((1, rows, KSPLIT_K), generator=gen, device=dev).to(torch.bfloat16)
            for mode in ("ax_dense", "ax_dense_dyn"):
                def call(xa, wa, tp_=None):
                    if mode == "ax_dense":
                        return ax_dense(xa, wa, pol, tp=tp_)
                    return ax_dense_dyn(xa, wa, pol, trip, tp=tp_,
                                        tp_role="row" if tp_ is not None else None)

                one = call(x, w)
                out[f"{mode} {rows} rows"] = torch.equal(call(x[..., k0:k1], w[k0:k1], tp),
                                                         one)
                if rows > 4:
                    s0, s1 = tp_seq.block(rows)
                    out[f"{mode} {rows} rows, seq reduce-scatter"] = torch.equal(
                        call(x[..., k0:k1], w[k0:k1], tp_seq), one[:, s0:s1])
    del w
    torch.cuda.empty_cache()
    return out


def train_mesh_rank(rank, _fleet, ref):
    """One of the two ``gloo`` ranks sharing the card (phase 4d): the
    collectives probed; the K-split projection against the one-card call
    (:func:`_ksplit_card`); per layout 4 static steps of deepseek-moe-16b x2
    from the seeded state (the rank builds its blocks), the last of them
    with the collectives timed, (a) and (c) also 2 adaptive steps with the
    policy changed between them, (b) and (d) also a ``remat="layer"`` step
    from the same state as step 1; the reduced deepseek f32 step on every
    layout and on (b) and (d) with ``remat="layer"``, the reduced qwen2 f32
    step on (c) and (d); the restart on (a).  Everything numpy or plain
    Python."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params, transformer
    from repro_torch.runtime import SwapPolicy
    from repro_torch.runtime.telemetry import records_to_host
    from repro_torch.train import (AdamWConfig, FaultConfig, SimulatedFailure, SyntheticStream,
                                   DataConfig, gather_state, init_train_state, make_train_step,
                                   run_supervised)
    from repro_torch.train import distributed as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device()) if _fleet.device_type == "cuda"
           else torch.device("cpu"))
    nvcc0 = _build.NVCC_RUNS["count"]
    res = {"probe": _gloo_train_probe(dev), "layouts": {}, "small": {}, "shapes": {}}
    res["ksplit"] = _ksplit_card(dev, make_mesh((1, 2), ("data", "model"), device=dev.type,
                                                backend="gloo"))
    big, small = _tm_configs()
    opt = AdamWConfig(lr=1e-4, warmup=2)
    n_d = len(transformer.ax_projections(big))
    batches = _tm_batches(big, TM_STEPS + TM_ADAPTIVE_STEPS, DS_B, DS_S, 3)
    for label, shape, axes, par in _tm_layouts():
        with kernel_shapes() as seen:
            mesh = make_mesh(shape, axes, device=dev.type, backend="gloo")
            specs = D.state_specs(big, opt, mesh, par)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole = init_params(big, seed=0, device=dev)
            state = init_train_state(D.local_state(whole, specs["params"], mesh), opt)
            del whole
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            state_gb = sum(t.numel() * t.element_size() for t in _leaves(state)) / 1e9
            torch.cuda.reset_peak_memory_stats(dev)
            remat_m = None
            if label in TM_REMAT:
                # remat="layer" from the same state and batch as step 1 (its
                # new state dropped): the recompute's collectives run on
                # autograd's device thread
                out_r = make_train_step(big, dataclasses.replace(par, remat="layer"), opt,
                                        mesh=mesh)(state, batches[0])
                remat_m = {k: float(out_r[1][k]) for k in TM_METRICS}
                del out_r
                torch.cuda.empty_cache()
            step = make_train_step(big, par, opt, mesh=mesh)
            reset_launches()
            losses, walls = [], []
            for i in range(TM_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                # the last step times its collectives, a synchronise before and
                # after each; the steps before it run uninstrumented
                with (_collective_timer() if i == TM_STEPS - 1 else
                      contextlib.nullcontext()) as coll:
                    state, m = step(state, batches[i])
                    losses.append(float(m["loss"]))
                walls.append(time.perf_counter() - t)
                if i == 0:
                    first_m = {k: float(m[k]) for k in TM_METRICS}
            row = dict(losses=losses, launches=dict(LAUNCHES), n_d=n_d, init_s=init_s,
                       state_gb=state_gb,
                       ms_per_step=1e3 * sum(walls[1:-1]) / (TM_STEPS - 2),
                       first_ms=1e3 * walls[0], timed_ms=1e3 * walls[-1], coll_s=coll["s"],
                       coll_calls=coll["calls"], coll_share=coll["s"] / walls[-1],
                       grad_norm=float(m["grad_norm"]), remat=remat_m, step1=first_m)
            if label in TM_ADAPTIVE:
                astep = make_train_step(big, par, opt, adaptive=True, mesh=mesh)
                pol_a = SwapPolicy.from_ax_policy(big.ax)
                pol_b = SwapPolicy.from_ax_policy(dataclasses.replace(big.ax, swap_bit=5,
                                                                      swap_value=1))
                reset_launches()
                a_losses, ns, a_walls = [], [], []
                for i, pol in enumerate((pol_a, pol_b)):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    state, m = astep(state, batches[TM_STEPS + i],
                                     pol.dyn_tree(big.ax.targets, device=dev))
                    rec = records_to_host(m["ax_telemetry"])
                    a_walls.append(time.perf_counter() - t)
                    ns.append({tg: int(np.sum(r["n"])) for tg, r in rec.items()})
                    a_losses.append(float(m["loss"]))
                row.update(adaptive_losses=a_losses, adaptive_n=ns,
                           adaptive_launches=dict(LAUNCHES),
                           adaptive_ms=[1e3 * w for w in a_walls],
                           policies=[pol_a.describe(), pol_b.describe()])
            row["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            res["layouts"][label] = row
            del state, step, m
            torch.cuda.empty_cache()
        res["shapes"][label] = {k: sorted(v) for k, v in seen.items()}

    # the reduced configs in f32: one sharded step against the one-card one
    for label, shape, axes, par in _tm_layouts(remat=True):
        mesh = make_mesh(shape, axes, device=dev.type, backend="gloo")
        for name, cfg in small.items():
            if name == "qwen2-72b" and label[0] not in TM_TP:
                continue
            specs = D.state_specs(cfg, opt, mesh, par)
            whole = init_train_state(init_params(cfg, seed=0, device=dev), opt)
            new, m = make_train_step(cfg, par, opt, mesh=mesh)(
                D.local_state(whole, specs, mesh), ref["small_batch"][name])
            back = gather_state(new, specs, mesh)
            res["small"][f"{name} {label}"] = dict(
                metrics={k: float(m[k]) for k in ("loss", "grad_norm")},
                params=_tm_flat(back["params"]) if rank == 0 else None)

    # the supervised restart on (a), the reduced deepseek
    label, shape, axes, par = _tm_layouts()[0]
    small_ds = small["deepseek-moe-16b"]
    mesh = make_mesh(shape, axes, device=dev.type, backend="gloo")
    specs = D.state_specs(small_ds, opt, mesh, par)
    step = make_train_step(small_ds, par, opt, mesh=mesh)
    n_steps, every, crash = TM_RESTART

    def make_state():
        return init_train_state(D.local_state(init_params(small_ds, seed=0, device=dev),
                                              specs["params"], mesh), opt)

    fired = []

    def chaos(i):
        if i == crash and not fired:
            fired.append(i)
            raise SimulatedFailure("rank lost")

    runs = {}
    for name, hook in (("ref", None), ("chaos", chaos)):
        stream = SyntheticStream(DataConfig(small_ds.vocab, 32, 4, seed=1, mode="arith"))
        t = time.perf_counter()
        st, log = run_supervised(make_state, step, stream, n_steps,
                                 FaultConfig(ckpt_dir=f"{ref['ckpt']}/{name}", ckpt_every=every),
                                 chaos=hook, sharding_tree=specs, mesh=mesh)
        runs[name] = (gather_state(st, specs, mesh)["params"], log, time.perf_counter() - t)
    pairs = list(zip(_leaves(runs["ref"][0]), _leaves(runs["chaos"][0])))
    res["restart"] = dict(
        restarts=[runs[k][1]["restarts"] for k in ("ref", "chaos")],
        worst_rel=max(((a - b).abs().max() / a.abs().max().clamp(min=1e-12)).item()
                      for a, b in pairs),
        bit_equal=all(torch.equal(a, b) for a, b in pairs),
        walls=[runs[k][2] for k in ("ref", "chaos")])
    res["nvcc"] = _build.NVCC_RUNS["count"] - nvcc0
    return res


def train_mesh_phase(dev, card: str, clock: float):
    """Phase 4d (module note): the one-card reference steps in this process,
    then two ``gloo`` ranks spawned on the card while it holds no model.
    Returns (rows, ax_matmul shape rows, ax_matmul_grid shape rows, the same
    two of the tensor-parallel layouts, launches by path, grid launches by
    path)."""
    import tempfile

    import torch

    from repro_torch.configs import ParallelConfig
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import transformer
    from repro_torch.train import AdamWConfig, fresh_train_state, make_train_step

    t_ref = time.perf_counter()
    # the two ranks need the card's room: drop what earlier phases left unreferenced
    gc.collect()
    torch.cuda.empty_cache()
    left_gb = torch.cuda.memory_allocated(dev) / 1e9
    big, small = _tm_configs()
    opt = AdamWConfig(lr=1e-4, warmup=2)
    n_d = len(transformer.ax_projections(big))
    # one card: step 1 of deepseek x2, and the reduced f32 steps
    state = fresh_train_state(big, opt, seed=0, device=dev)
    b0 = _tm_batches(big, 1, DS_B, DS_S, 3)[0]
    one_loss = float(make_train_step(big, ParallelConfig(remat="none"), opt)(state, b0)[1]["loss"])
    del state
    torch.cuda.empty_cache()
    small_batch, one_small = {}, {}
    for name, cfg in small.items():
        small_batch[name] = _tm_batches(cfg, 1, 8, 32, 5)[0]
        s0 = fresh_train_state(cfg, opt, seed=0, device=dev)
        s1, m1 = make_train_step(cfg, ParallelConfig(remat="none"), opt)(s0, small_batch[name])
        one_small[name] = dict(metrics={k: float(m1[k]) for k in ("loss", "grad_norm")},
                               params=_tm_flat(s1["params"]), start=_tm_flat(s0["params"]))
        del s0, s1, m1
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_ref
    # what this process keeps on the card while the two ranks train beside it
    held_gb = (torch.cuda.memory_allocated(dev) / 1e9, torch.cuda.memory_reserved(dev) / 1e9)
    print(f"train mesh: earlier phases left {left_gb:.2f} GB allocated; this process holds "
          f"{held_gb[0]:.2f} GB allocated, {held_gb[1]:.2f} GB reserved while the ranks run "
          f"[{card}]", flush=True)

    t_b = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_mesh_") as tmp:
        res = spawn(train_mesh_rank, TM_RANKS, args=(dict(small_batch=small_batch, ckpt=tmp),),
                    device=dev.type, backend="gloo", timeout_s=900)
    ranks_s = time.perf_counter() - t_b
    problems = []
    r0 = res[0]
    want = {"ax_matmul": n_d * TM_STEPS, "ax_matmul_grid": 0}
    want_a = {"ax_matmul": 0, "ax_matmul_grid": n_d * TM_ADAPTIVE_STEPS}
    for rank, r in enumerate(res):
        if r["nvcc"]:
            problems.append(f"rank {rank}: {r['nvcc']} nvcc runs")
        if not all(r["probe"].values()):
            problems.append(f"rank {rank}: gloo card collectives {r['probe']}")
        if not all(r["ksplit"].values()):
            problems.append(f"rank {rank}: the K-split projection vs one card {r['ksplit']}")
        for label, row in r["layouts"].items():
            losses = row["losses"] + row.get("adaptive_losses", [])
            if not all(math.isfinite(x) for x in losses):
                problems.append(f"rank {rank} ({label}): losses {losses}")
            if row["launches"] != want:
                problems.append(f"rank {rank} ({label}): launches {row['launches']} (want "
                                f"{want})")
            gap = abs(row["losses"][0] / one_loss - 1)
            if gap > TOL_TM_STEP1:
                problems.append(f"rank {rank} ({label}): step 1 loss {row['losses'][0]} vs "
                                f"one card {one_loss} ({gap:.3g} > {TOL_TM_STEP1})")
            if row["remat"] is not None:
                gaps = {k: abs(row["remat"][k] / row["step1"][k] - 1) for k in TM_METRICS}
                # the same forward: (d) holds loss, ce and aux equal
                exact = [k for k in ("loss", "ce", "aux") if label in TM_TP and gaps[k]]
                if max(gaps.values()) > TOL_TRAIN_STEP or exact:
                    problems.append(f"rank {rank} ({label}): the remat='layer' step vs step 1 "
                                    f"{gaps} (tol {TOL_TRAIN_STEP}; equal: {exact or 'yes'})")
            if label in TM_ADAPTIVE and (row["adaptive_launches"] != want_a or not all(
                    min(n.values()) > 0 for n in row["adaptive_n"])):
                problems.append(f"rank {rank} ({label}) adaptive: launches "
                                f"{row['adaptive_launches']} (want {want_a}), telemetry n "
                                f"{row['adaptive_n']}")
        if r["restart"]["restarts"] != [0, 1] or r["restart"]["worst_rel"] > TOL_TM_RESTART:
            problems.append(f"rank {rank}: restart {r['restart']}")
        for label in r["layouts"]:
            if r["layouts"][label]["losses"] != r0["layouts"][label]["losses"]:
                problems.append(f"rank {rank} ({label}): reported losses differ from rank 0's")
    small_rows = {}
    for key, got in r0["small"].items():
        name = key.split(" ")[0]
        want_s = one_small[name]
        gaps = {k: abs(got["metrics"][k] / want_s["metrics"][k] - 1)
                for k in ("loss", "grad_norm")}
        upd = _update_gap_np(got["params"], want_s["params"], want_s["start"])
        small_rows[key] = dict(gaps, update=upd)
        if max(gaps.values()) > TOL_TRAIN_STEP or upd > TOL_TRAIN_UPDATE:
            problems.append(f"reduced f32 step ({key}) vs one card: {gaps}, update {upd} "
                            f"(tol {TOL_TRAIN_STEP}, {TOL_TRAIN_UPDATE})")
    # every launched shape: the ranks' rows, reckoned from the config
    M = DS_B * DS_S // TM_RANKS
    dshapes = {}
    for _, proj, K, N in transformer.ax_projections(big):
        dshapes.setdefault((_padded(M), _padded(K), _padded(N)),
                           f"deepseek train mesh M={M} {proj}")
    tp_shapes = _tm_tp_shapes(big, DS_B * DS_S, TM_RANKS)
    for label in r0["shapes"]:
        seen = {k: set(map(tuple, v)) for k, v in r0["shapes"][label].items()}
        reck = set(tp_shapes if label in TM_TP else dshapes)
        grid_reck = reck if label in TM_ADAPTIVE else set()
        if seen["ax_matmul"] != reck or seen["ax_matmul_grid"] != grid_reck:
            problems.append(f"({label}) kernel shapes launched {seen}, reckoned "
                            f"{sorted(reck)} ({sorted(grid_reck)} grid)")
    if problems:
        fail("train mesh: " + "; ".join(problems))
    shape_list = [(label,) + k for k, label in sorted(dshapes.items())]
    tp_list = [(label,) + k for k, label in sorted(tp_shapes.items())]
    ax_rows = main_shape_checks(dev, card, clock, grid_kernel=False, shapes=shape_list)
    grid_rows = main_shape_checks(dev, card, clock, grid_kernel=True, shapes=shape_list)
    tp_ax_rows = main_shape_checks(dev, card, clock, grid_kernel=False, shapes=tp_list)
    tp_grid_rows = main_shape_checks(dev, card, clock, grid_kernel=True, shapes=tp_list)
    print(f"train mesh: gloo takes card tensors for {sorted(r0['probe'])} (values checked); "
          f"one-card step 1 of deepseek-moe-16b x2 loss {one_loss:.6f} [{card}]", flush=True)
    print(f"train mesh: the K-split SWAPPER projection (K {KSPLIT_K} -> {KSPLIT_K // TM_RANKS} "
          f"a rank, N {KSPLIT_N}, bf16, mxu) on two gloo ranks == the one-card call bit for "
          f"bit: {', '.join(k for k, v in r0['ksplit'].items() if v)} [{card}]", flush=True)
    rows = {"one_card_loss": one_loss, "small": small_rows, "restart": r0["restart"],
            "ref_s": ref_s, "ranks_s": ranks_s, "parent_gb": held_gb,
            "ksplit": r0["ksplit"]}
    for label, shape, axes, par in _tm_layouts():
        per = [r["layouts"][label] for r in res]
        row = per[0]
        tokens = DS_B * DS_S if label in TM_TP else DS_B * DS_S // TM_RANKS
        rows[label] = dict(mesh=f"{dict(zip(axes, shape))}", ms_per_step=row["ms_per_step"],
                           first_ms=row["first_ms"], losses=row["losses"],
                           peak_gb=[p["peak_gb"] for p in per],
                           state_gb=[p["state_gb"] for p in per],
                           coll_share=[p["coll_share"] for p in per],
                           coll_ms=[1e3 * p["coll_s"] for p in per],
                           timed_ms=[p["timed_ms"] for p in per],
                           coll_calls=row["coll_calls"],
                           tokens_per_s=DS_B * DS_S / row["ms_per_step"] * 1e3)
        extra = ""
        if row["remat"] is not None:
            rows[label]["remat_gap"] = {k: abs(row["remat"][k] / row["step1"][k] - 1)
                                        for k in TM_METRICS}
            gaps = ", ".join(f"{k} {v:.3g}" for k, v in rows[label]["remat_gap"].items())
            extra = (f"; remat='layer' from step 1's state: loss {row['remat']['loss']:.6f}, "
                     f"gaps {gaps} (tol {TOL_TRAIN_STEP})")
        if label in TM_ADAPTIVE:
            rows[label].update(adaptive_ms=row["adaptive_ms"], adaptive_n=row["adaptive_n"])
            extra = (f"; 2 adaptive steps ({row['policies'][0]} then {row['policies'][1]}): "
                     f"telemetry n {row['adaptive_n']}, ax_matmul_grid {want_a['ax_matmul_grid']} "
                     f"a rank, {', '.join(f'{x:.0f}' for x in row['adaptive_ms'])} ms")
        flags = "+".join(f for f in ("dp_only", "fsdp", "seq_shard", "ep") if getattr(par, f))
        print(f"train mesh ({label}) {dict(zip(axes, shape))} {flags}: deepseek-moe-16b x2 "
              f"(--ax mxu, B={DS_B} x {DS_S}, {tokens} tokens a rank), {TM_STEPS} "
              f"steps: losses {', '.join(f'{x:.5f}' for x in row['losses'])} (step 1 "
              f"{abs(row['losses'][0] / one_loss - 1):.3g} from one card, tol {TOL_TM_STEP1}); "
              f"ax_matmul {want['ax_matmul']} a rank (= {n_d} x {TM_STEPS}); "
              f"{row['ms_per_step']:.1f} ms/step over steps 2-{TM_STEPS - 1} (first "
              f"{row['first_ms']:.0f} ms), {rows[label]['tokens_per_s']:.0f} tokens/s; state "
              f"{row['state_gb']:.2f} GB a rank, peak allocated "
              f"{', '.join(f'{p:.1f}' for p in rows[label]['peak_gb'])} GB; collectives "
              f"{rows[label]['coll_calls']} a step, "
              f"{', '.join(f'{100 * c:.1f}%' for c in rows[label]['coll_share'])} of step "
              f"{TM_STEPS}'s wall ({', '.join(f'{x:.1f}' for x in rows[label]['timed_ms'])} ms, "
              f"a synchronise around each collective){extra} [{card}]", flush=True)
    rs = r0["restart"]
    print(f"train mesh: reduced configs (2 layers, f32, exact) sharded vs one card "
          f"{ {k: {n: float(f'{v:.3g}') for n, v in g.items()} for k, g in small_rows.items()} } "
          f"(tol {TOL_TRAIN_STEP}, update {TOL_TRAIN_UPDATE}); run_supervised on (a) "
          f"({TM_RESTART[0]} steps, ckpt_every {TM_RESTART[1]}, a crash at step "
          f"{TM_RESTART[2]}): 1 restart, within {rs['worst_rel']:.3g} relative of the "
          f"uninterrupted run (tol {TOL_TM_RESTART}), bit-equal {rs['bit_equal']}, walls "
          f"{rs['walls'][0]:.1f} / {rs['walls'][1]:.1f} s; the one-card references "
          f"{ref_s:.1f} s, the ranks {ranks_s:.1f} s with the spawn [{card}]", flush=True)
    paths = {f"train mesh ({label}, rank 0)": want["ax_matmul"] for label in "abcd"}
    grid_paths = {f"train mesh ({label}) adaptive, rank 0": want_a["ax_matmul_grid"]
                  for label in TM_ADAPTIVE}
    return rows, ax_rows, grid_rows, tp_ax_rows, tp_grid_rows, paths, grid_paths


TPS_RANKS = 2
TPS_LEN = 42                             # S + T + 1 = 41 rows, even for the 2-row split
TOL_TPS_F32 = TOL_CONSIST_F32            # of the largest one-card value, f32 exact
# the bf16 serve against one card whose plain q/k/v GEMMs are the ranks' column
# blocks (``tps_witness``): the same kernels on the same operands, the same bits
TOL_TPS_WITNESS = 0.0


@contextlib.contextmanager
def tps_witness(n: int, attention: bool = False):
    """One card, in this process, computing the plain (not SWAPPER) q/k/v
    projections as ``n`` column blocks, each a GEMM of the shape and layout
    that a rank of the tp serve's ``n`` model ranks runs; everything else as
    one card computes it.  The witness of the cause of the ranks' bf16 gap
    against the plain one-card serve: a GEMM over half the columns may round
    its f32 sums to bf16 apart from the whole GEMM.  ``attention``: each
    decode step's attention also in the ranks' order
    (``layers.decode_attention_split``'s partial softmax statistics over
    ``n`` blocks of the cache's sequence, combined in rank order), for a
    full-attention cache.  The sharded serve runs unpatched in the ranks'
    processes."""
    import torch

    from repro_torch.models import layers
    from repro_torch.quant.ax import weight_cast

    dense0, attend0 = layers.dense, layers.decode_attention

    def dense(x, p, ax=None, target="", tp=None, role=None):
        if target != "attn_qkv" or tp is not None or (ax is not None and target in ax.targets):
            return dense0(x, p, ax, target, tp, role)
        w = weight_cast(p["w"], x.dtype)
        y = torch.cat([x @ c.contiguous() for c in w.chunk(n, dim=-1)], dim=-1)
        return y + p["b"].to(x.dtype) if "b" in p else y

    def attend(q, k_cache, v_cache, q_pos, kv_len, *, window=0):
        if window or k_cache.shape[1] % n:
            return attend0(q, k_cache, v_cache, q_pos, kv_len, window=window)
        B, _, H, hd = q.shape
        L, KV = k_cache.shape[1] // n, k_cache.shape[2]
        qg = q.reshape(B, KV, H // KV, hd)
        scale = 1.0 / math.sqrt(hd)
        scores, values = [], []
        for r in range(n):
            kb = k_cache[:, r * L:(r + 1) * L].contiguous()
            s = torch.einsum("bkgh,bckh->bkgc", qg, kb).to(torch.float32) * scale
            idx = r * L + torch.arange(L, device=q.device)[None, :]
            valid = (idx < kv_len[:, None]) & (idx <= q_pos[:, None])
            scores.append(torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30)))
            values.append(v_cache[:, r * L:(r + 1) * L].contiguous())
        m = scores[0].amax(dim=-1, keepdim=True)
        for s in scores[1:]:
            m = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        es = [torch.exp(s - m) for s in scores]
        lsum = es[0].sum(dim=-1, keepdim=True)
        for e in es[1:]:
            lsum = lsum + e.sum(dim=-1, keepdim=True)
        out = None
        for e, vb in zip(es, values):
            p = (e / lsum).to(vb.dtype).to(torch.float32)
            o = torch.einsum("bkgc,bckh->bkgh", p, vb.to(torch.float32))
            out = o if out is None else out + o
        return out.to(v_cache.dtype).reshape(B, 1, H, hd).to(q.dtype)

    layers.dense = dense
    if attention:
        layers.decode_attention = attend
    try:
        yield
    finally:
        layers.dense, layers.decode_attention = dense0, attend0


def _tps_configs():
    """qwen2-72b and deepseek-moe-16b at their published widths, depth 2,
    ``mxu``, bf16 compute; deepseek at capacity 16, so that neither its
    per-rank capacity nor one card's drops a choice."""
    from repro_torch.configs import ARCHS, qwen2_72b
    from repro_torch.configs.base import AxPolicy

    ax = AxPolicy(backend="mxu")
    return [dataclasses.replace(qwen2_72b, n_layers=L, ax=ax),
            dataclasses.replace(ARCHS["deepseek-moe-16b"], n_layers=L, ax=ax,
                                moe_capacity=16.0)]


def _tps_exact(cfg):
    """The forward check's config: f32 compute on exact projections."""
    return dataclasses.replace(cfg, compute_dtype="float32", ax=None)


def _tps_loop(params, cfg, prompts, teacher, par=None):
    """The first prefill and T - 1 decode steps fed ``teacher``'s tokens, on
    the host: ([the prefill's logits (B, S, V), then each step's (B, V)],
    cache), in f32 (a bf16 value converts exactly)."""
    import torch

    from repro_torch.models import decode_step, prefill

    with torch.inference_mode():
        lg, cache = prefill(params, {"tokens": prompts}, cfg, par, max_cache_len=TPS_LEN)
        steps = [lg]
        for i in range(T - 1):
            sl, cache = decode_step(params, cache, teacher[:, i:i + 1], S + i, cfg, par)
            steps.append(sl[:, -1])
    return ([x.float().cpu() for x in steps],
            [{k: v.float().cpu() for k, v in c.items()} for c in cache])


def _tps_np(res):
    """A ``_tps_loop`` result as numpy (a spawned rank's travels pickled)."""
    return ([x.numpy() for x in res[0]], [{k: v.numpy() for k, v in c.items()} for c in res[1]])


def _tps_gaps(got, want):
    """(max |diff| of the prefill's and each step's logits, the largest
    reference logit of each) between a rank's ``_tps_np`` result and one
    card's ``_tps_loop`` result."""
    import torch

    pairs = [(torch.from_numpy(a), b) for a, b in zip(got[0], want[0])]
    return ([float((a - b).abs().max()) for a, b in pairs],
            [float(b.abs().max()) for _, b in pairs])


def tp_serve_rank(rank, _fleet, ref_path):
    """One of the two ``gloo`` ranks of the tp serve phase: per config the
    rank's blocks of the seeded weights (``serve_params``); under
    ``set_mesh_ctx`` the teacher-forced loop and two ``generate(par=)``
    serves (the second with its collectives timed) in bf16 through
    ``mxu``, and the loop again in f32 on exact projections, fed the
    one-card tokens of ``ref_path``.  The loops' logits and cache blocks,
    the tokens and the numbers come back (numpy)."""
    import torch

    from repro_torch.configs import ParallelConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.parallel import serve_params
    from repro_torch.launch.sharding import set_mesh_ctx
    from repro_torch.models import init_params
    from repro_torch.serve import ServeConfig, generate

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device()) if _fleet.device_type == "cuda"
           else torch.device("cpu"))
    nvcc0 = _build.NVCC_RUNS["count"]
    refs = torch.load(ref_path)
    mesh = make_mesh((1, TPS_RANKS), ("data", "model"), device=dev.type, backend="gloo")
    par = ParallelConfig(fsdp=True, seq_shard=True, ep=True)     # JAX's default layout
    out = {}
    for cfg in _tps_configs():
        ref = refs[cfg.name]
        whole = init_params(cfg, seed=0, device=dev)
        params = serve_params(whole, mesh, par)
        del whole
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        prompts, teacher = ref["prompts"].to(dev), ref["tokens"].to(dev)
        row = {}
        with set_mesh_ctx(mesh, par), kernel_shapes() as seen:
            reset_launches()
            row["bf16"] = _tps_np(_tps_loop(params, cfg, prompts, teacher, par))
            row["loop_launches"] = dict(LAUNCHES)
            serve_cfg = ServeConfig(max_new_tokens=T, cuda_graphs=False)
            stats = {}
            reset_launches()
            toks = generate(params, {"tokens": prompts}, cfg, serve_cfg, par=par,
                            max_cache_len=TPS_LEN, stats=stats)
            row["serve_launches"] = dict(LAUNCHES)
            row["tokens"] = toks.cpu().numpy()
            row["stats"] = stats
            torch.cuda.synchronize()
            t = time.perf_counter()
            with _collective_timer() as coll:
                again = generate(params, {"tokens": prompts}, cfg, serve_cfg, par=par,
                                 max_cache_len=TPS_LEN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            row.update(coll_s=coll["s"], coll_calls=coll["calls"], timed_s=wall,
                       again_equal=bool(torch.equal(again.cpu(), toks.cpu())))
            row["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            row["f32"] = _tps_np(_tps_loop(params, _tps_exact(cfg), prompts, teacher, par))
        row["params_gb"] = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
        row["shapes"] = {k: sorted(v) for k, v in seen.items()}
        out[cfg.name] = row
        del params, toks, again
        torch.cuda.empty_cache()
    out["nvcc"] = _build.NVCC_RUNS["count"] - nvcc0
    return out


def _tps_cache_gaps(per, ref_cache, key, problems, name):
    """[(layer, leaf, max |diff|, largest)] of the cache gathered on its
    sequence from the ranks (``per[r][key][1]``) against one card's."""
    import torch

    gaps = []
    for layer, c_one in enumerate(ref_cache):
        for k, v in c_one.items():
            got = torch.cat([torch.from_numpy(row[key][1][layer][k]) for row in per], dim=1)
            if got.shape != v.shape:
                problems.append(f"{name}: cache layer {layer} {k} gathered "
                                f"{tuple(got.shape)} vs {tuple(v.shape)}")
                continue
            gaps.append((layer, k, float((got - v).abs().max()), float(v.abs().max())))
    return gaps


def _tps_worst(gaps, largest):
    return max(g / m for g, m in zip(gaps, largest))


def tp_serve_phase(dev, card: str, clock: float):
    """Phase 4e (module note): each config served on one card in this
    process, plainly and with the ranks' q/k/v GEMMs (``tps_witness``), then
    the two ``gloo`` ranks spawned on the card while this process holds no
    model.  Returns (rows, ``ax_matmul`` shape rows, launches by path)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch.mesh import spawn
    from repro_torch.models import init_params, transformer
    from repro_torch.serve import ServeConfig, generate

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    refs = {}
    serve_cfg = ServeConfig(max_new_tokens=T, cuda_graphs=False)
    for cfg in _tps_configs():
        params = init_params(cfg, seed=0, device=dev)
        prompts = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
        batch = {"tokens": prompts}
        toks = generate(params, batch, cfg, serve_cfg, max_cache_len=TPS_LEN)
        ref = dict(prompts=prompts, tokens=toks.cpu(),
                   one=_tps_loop(params, cfg, prompts.to(dev), toks),
                   f32=_tps_loop(params, _tps_exact(cfg), prompts.to(dev), toks))
        with tps_witness(TPS_RANKS):
            ref["witness"] = _tps_loop(params, cfg, prompts.to(dev), toks)
            ref["witness_tokens"] = generate(params, batch, cfg, serve_cfg,
                                             max_cache_len=TPS_LEN).cpu()
        refs[cfg.name] = ref
        del params, toks
        gc.collect()
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_serve_") as tmp:
        path = os.path.join(tmp, "ref.pt")
        torch.save({k: dict(prompts=v["prompts"], tokens=v["tokens"]) for k, v in refs.items()},
                   path)
        res = spawn(tp_serve_rank, TPS_RANKS, args=(path,), device=dev.type, backend="gloo",
                    timeout_s=600)
    ranks_s = time.perf_counter() - t1
    problems, rows, shape_list, paths = [], {}, [], {}
    for rank, r in enumerate(res):
        if r["nvcc"]:
            problems.append(f"rank {rank}: {r['nvcc']} nvcc runs")
    for cfg in _tps_configs():
        name = cfg.name
        ref = refs[name]
        witness = ref["witness"]
        per = [r[name] for r in res]
        r0 = per[0]
        n_ax = len(transformer.ax_projections(cfg))
        want = {"ax_matmul": n_ax * T, "ax_matmul_grid": 0}
        for rank, row in enumerate(per):
            for k in ("loop_launches", "serve_launches"):
                if row[k] != want:
                    problems.append(f"{name} rank {rank}: {k} {row[k]} (want {want})")
            f32_gaps, f32_largest = _tps_gaps(row["f32"], ref["f32"])
            if _tps_worst(f32_gaps, f32_largest) > TOL_TPS_F32:
                problems.append(f"{name} rank {rank}: f32 exact logits vs one card {f32_gaps} "
                                f"of largest {f32_largest} (tol {TOL_TPS_F32})")
            gaps, largest = _tps_gaps(row["bf16"], witness)
            if not all(math.isfinite(g) for g in gaps) or \
                    any(g > TOL_TPS_WITNESS * m for g, m in zip(gaps, largest)):
                problems.append(f"{name} rank {rank}: bf16 logits vs one card with the ranks' "
                                f"q/k/v {gaps} of largest {largest} (tol {TOL_TPS_WITNESS})")
            if not row["again_equal"]:
                problems.append(f"{name} rank {rank}: a second serve's tokens differ")
            if not np.array_equal(row["tokens"], ref["witness_tokens"].numpy()):
                problems.append(f"{name} rank {rank}: tokens {row['tokens'].tolist()} vs one "
                                f"card's with the ranks' q/k/v "
                                f"{ref['witness_tokens'].tolist()}")
            if not np.array_equal(row["tokens"], r0["tokens"]) or any(
                    not np.array_equal(a, b) for a, b in zip(row["bf16"][0], r0["bf16"][0])):
                problems.append(f"{name} rank {rank}: tokens or logits differ from rank 0's")
        f32_cache = _tps_cache_gaps(per, ref["f32"][1], "f32", problems, name)
        if any(g > TOL_TPS_F32 * m for _, _, g, m in f32_cache):
            problems.append(f"{name}: gathered f32 cache vs one card {f32_cache} (tol "
                            f"{TOL_TPS_F32})")
        w_cache = _tps_cache_gaps(per, witness[1], "bf16", problems, name)
        if any(g > TOL_TPS_WITNESS * m for _, _, g, m in w_cache):
            problems.append(f"{name}: gathered bf16 cache vs one card with the ranks' q/k/v "
                            f"{w_cache} (tol {TOL_TPS_WITNESS})")
        # the plain one card: reported
        gaps, largest = _tps_gaps(r0["bf16"], ref["one"])
        plain_cache = _tps_cache_gaps(per, ref["one"][1], "bf16", problems, name)
        # every launched shape: reckoned from the config and its split
        reck = {}
        for M in (B * S, B):
            reck.update(_tm_tp_shapes(cfg, M, TPS_RANKS, f"{name} tp serve"))
        for rank, row in enumerate(per):
            seen = {k: set(map(tuple, v)) for k, v in row["shapes"].items()}
            if seen["ax_matmul"] != set(reck) or seen["ax_matmul_grid"]:
                problems.append(f"{name} rank {rank}: kernel shapes {seen}, reckoned "
                                f"{sorted(reck)}")
        shape_list += [(label,) + k for k, label in sorted(reck.items())]
        st = r0["stats"]
        f32_gaps, f32_largest = _tps_gaps(r0["f32"], ref["f32"])
        rows[name] = dict(
            f32_worst=_tps_worst(f32_gaps, f32_largest),
            f32_cache=max(g / m for _, _, g, m in f32_cache),
            plain=_tps_worst(gaps, largest), plain_largest=max(largest),
            plain_cache=[(ly, k, g / m) for ly, k, g, m in plain_cache],
            tokens_equal_plain=bool(np.array_equal(r0["tokens"], ref["tokens"].numpy())),
            prefill_ms=1e3 * st["prefill_s"], decode_ms=1e3 * st["decode_s"] / (T - 1),
            coll_share=[row["coll_s"] / row["timed_s"] for row in per],
            coll_calls=r0["coll_calls"], peak_gb=[row["peak_gb"] for row in per],
            params_gb=[row["params_gb"] for row in per], launches=n_ax * T)
        paths[f"tp serve {name} (rank 0)"] = r0["serve_launches"]["ax_matmul"]
    for name, row in rows.items():
        cache = ", ".join(f"{ly}{k} {g:.3g}" for ly, k, g in row["plain_cache"])
        print(f"tp serve {name} x{L} on two gloo ranks (('data', 'model') = (1, "
              f"{TPS_RANKS}), fsdp + seq_shard + ep, B={B} x {S}, {T} tokens, cache "
              f"{TPS_LEN} rows split on its sequence): f32 exact forward vs one card, "
              f"prefill and {T - 1} decode steps, worst {row['f32_worst']:.3g} of the largest "
              f"logit (tol {TOL_TPS_F32}), gathered cache within {row['f32_cache']:.3g}; bf16 "
              f"mxu serve: logits, cache and tokens held to one card whose q/k/v GEMMs are "
              f"the ranks' column blocks (tol {TOL_TPS_WITNESS}); against the plain one card "
              f"(reported): logits within {row['plain']:.3g} of the largest "
              f"({row['plain_largest']:.4g}), cache leaves {cache} of theirs, tokens equal "
              f"{row['tokens_equal_plain']}; ax_matmul {row['launches']} a rank (loop and "
              f"serve); prefill {row['prefill_ms']:.1f} ms, decode {row['decode_ms']:.1f} "
              f"ms/step; collectives {row['coll_calls']} a serve, "
              f"{', '.join(f'{100 * c:.1f}%' for c in row['coll_share'])} of its wall (a "
              f"synchronise around each); weights "
              f"{', '.join(f'{x:.2f}' for x in row['params_gb'])} GB, peak allocated "
              f"{', '.join(f'{x:.2f}' for x in row['peak_gb'])} GB a rank [{card}]",
              flush=True)
    if problems:
        fail("tp serve: " + "; ".join(problems))
    shape_rows = main_shape_checks(dev, card, clock, grid_kernel=False, shapes=shape_list)
    print(f"tp serve: the one-card references {ref_s:.1f} s, the ranks {ranks_s:.1f} s with "
          f"the spawn [{card}]", flush=True)
    rows.update(ref_s=ref_s, ranks_s=ranks_s)
    return rows, shape_rows, paths


TPA_T = 12                               # tokens of each adaptive serve
TPA_LEN = 46                             # S + T + 1 = 45 rows, even for the 2-row split
TPA_DRIFT = (3, 0.05)                    # drift_hook(step, scale)
TPA_CTRL = dict(min_observe_steps=2, cooldown_steps=2, drift_threshold=0.01)
TPA_TILES = 2                            # tile mode's row tiles
TPA_SLOTS, TPA_BUCKET, TPA_NEW, TPA_REQS = 4, 32, 11, 8   # the batcher: a 44-row cache


def _tpa_controller(cfg, tile_rows: int, dev):
    """An adaptive controller whose observed host records are kept."""
    import numpy as np

    import repro_torch.runtime as TR

    ctrl = TR.AdaptiveController(TR.SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                 TR.AdaptiveConfig(tile_rows=tile_rows, **TPA_CTRL),
                                 device=dev)
    seen = []
    observe = ctrl.observe

    def recording(records):
        seen.append({t: {k: np.array(v) for k, v in r.items()} for t, r in records.items()})
        return observe(records)

    ctrl.observe = recording
    return ctrl, seen


def _tpa_result(ctrl, seen, tokens) -> dict:
    """Tokens, every observed record, the re-tunes (step, target, old and
    new triples), the tile re-tunes (step, target, grid) and the policy."""
    import numpy as np

    short = (lambda c: None if c is None else c.short())
    return dict(tokens=np.asarray(tokens), records=seen,
                retunes=[(e.step, e.target, short(e.old), short(e.new)) for e in ctrl.retunes],
                tile_retunes=[(e.step, e.target, np.asarray(e.grid).tolist())
                              for e in ctrl.tile_retunes],
                policy=ctrl.policy.to_json())


def _tpa_requests(cfg):
    """The batcher's seeded requests: (prompt, budget) pairs."""
    import numpy as np

    rng = np.random.default_rng(5)
    return [(rng.integers(0, cfg.vocab, int(rng.integers(8, TPA_BUCKET + 1))).astype(np.int32),
             int(rng.integers(2, TPA_NEW + 1))) for _ in range(TPA_REQS)]


def _tpa_serves(params, cfg, prompts, dev, par=None, timing=None):
    """The adaptive drift serves (scalar and tile mode) and two token-mode
    batcher drains with one controller, the second of the drift hook's
    drifted weights, under whatever mesh context is installed; every decode
    step eager.  ``timing`` (a dict): each serve's ``stats`` kept there."""
    import torch

    from repro_torch.fleet import BatcherConfig, ContinuousBatcher, Request
    from repro_torch.launch.serve import drift_hook
    from repro_torch.serve import ServeConfig, generate

    out = {}
    scfg = ServeConfig(max_new_tokens=TPA_T, cuda_graphs=False)
    for tr in (0, TPA_TILES):
        ctrl, seen = _tpa_controller(cfg, tr, dev)
        stats = {}
        toks = generate(params, {"tokens": prompts}, cfg, scfg, par=par, adaptive=ctrl,
                        param_hook=drift_hook(*TPA_DRIFT), max_cache_len=TPA_LEN, stats=stats)
        out[f"gen{tr}"] = _tpa_result(ctrl, seen, toks.cpu())
        if timing is not None:
            timing[f"gen{tr}"] = stats
    ctrl, seen = _tpa_controller(cfg, 0, dev)
    tokens, steps = {}, 0
    for j, p in enumerate((params, drift_hook(0, TPA_DRIFT[1])(0, params))):
        bat = ContinuousBatcher(p, cfg, BatcherConfig(
            n_slots=TPA_SLOTS, prompt_buckets=(TPA_BUCKET,), new_token_bucket=TPA_NEW,
            token_granular=True), adaptive=ctrl, par=par)
        for i, (prompt, budget) in enumerate(_tpa_requests(cfg)):
            bat.submit(Request(100 * j + i, prompt.copy(), budget))
        tokens.update({c.rid: [int(t) for t in c.tokens] for c in bat.run()})
        steps += bat.stats["decode_steps"]
    torch.cuda.synchronize()
    out["batcher"] = dict(_tpa_result(ctrl, seen, []), tokens=tokens, steps=steps)
    return out


def tp_adapt_rank(rank, _fleet, ref_path):
    """One of the two ``gloo`` ranks of the tp adapt phase: per config the
    rank's blocks of the seeded weights under ``set_mesh_ctx``, the serves
    and drains of ``_tpa_serves``, with their launches, launched shapes and
    graph captures; then the drift serve again with its collectives and
    its records' gathers timed.  Results as numpy and plain values."""
    import torch

    from repro_torch.configs import ParallelConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.parallel import serve_params
    from repro_torch.launch.sharding import set_mesh_ctx
    from repro_torch.models import init_params
    from repro_torch.serve import graph as G

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device()) if _fleet.device_type == "cuda"
           else torch.device("cpu"))
    nvcc0 = _build.NVCC_RUNS["count"]
    refs = torch.load(ref_path)
    mesh = make_mesh((1, TPS_RANKS), ("data", "model"), device=dev.type, backend="gloo")
    par = ParallelConfig(fsdp=True, seq_shard=True, ep=True)     # JAX's default layout
    out = {}
    for cfg in _tps_configs():
        whole = init_params(cfg, seed=0, device=dev)
        params = serve_params(whole, mesh, par)
        del whole
        torch.cuda.empty_cache()
        prompts = refs[cfg.name].to(dev)
        captures = sum(G.captures_by_kind().values())
        timing = {}
        with set_mesh_ctx(mesh, par), kernel_shapes() as seen:
            reset_launches()
            row = _tpa_serves(params, cfg, prompts, dev, par, timing)
            row["launches"] = dict(LAUNCHES)
        row["captures"] = sum(G.captures_by_kind().values()) - captures
        row["shapes"] = {k: sorted(v) for k, v in seen.items()}
        row["timing"] = {k: dict(v) for k, v in timing.items()}
        # the tile-mode drift serve again, warm: plain (its step times), then
        # with the collectives, then with the records' gathers
        # (``runtime.telemetry.tp_operands``) each between synchronises
        from repro_torch.launch.serve import drift_hook
        from repro_torch.runtime import telemetry
        from repro_torch.serve import ServeConfig, generate

        def again(timer):
            ctrl, _ = _tpa_controller(cfg, TPA_TILES, dev)
            stats = {}
            torch.cuda.synchronize()
            t = time.perf_counter()
            with set_mesh_ctx(mesh, par), timer as acc:
                generate(params, {"tokens": prompts}, cfg,
                         ServeConfig(max_new_tokens=TPA_T, cuda_graphs=False), par=par,
                         adaptive=ctrl, param_hook=drift_hook(*TPA_DRIFT),
                         max_cache_len=TPA_LEN, stats=stats)
            torch.cuda.synchronize()
            return time.perf_counter() - t, acc, stats

        row["timing"]["warm"] = again(contextlib.nullcontext({}))[2]
        wall, coll, _ = again(_collective_timer())
        row.update(coll_s=coll["s"], coll_calls=coll["calls"], timed_s=wall)
        wall, gath, _ = again(_timed_call(telemetry, "tp_operands"))
        row.update(gather_s=gath["s"], gather_calls=gath["calls"], gather_timed_s=wall)
        out[cfg.name] = row
        del params
        torch.cuda.empty_cache()
    out["nvcc"] = _build.NVCC_RUNS["count"] - nvcc0
    return out


@contextlib.contextmanager
def _timed_call(module, name: str):
    """Host wall of each call of ``module.name``, the card synchronised
    before and after it."""
    import torch

    acc = {"s": 0.0, "calls": 0}
    real = getattr(module, name)

    def call(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real(*a, **kw)
        torch.cuda.synchronize()
        acc["s"] += time.perf_counter() - t
        acc["calls"] += 1
        return res

    setattr(module, name, call)
    try:
        yield acc
    finally:
        setattr(module, name, real)


def _tpa_same(a: dict, b: dict) -> list:
    """The ways two ``_tpa_result``s differ: tokens, each record (field by
    field, shapes and dtypes included), re-tunes, tile grids, policy."""
    import numpy as np

    out = []
    ta, tb = a["tokens"], b["tokens"]
    if not (ta == tb if isinstance(ta, dict) else np.array_equal(ta, tb)):
        out.append("tokens")
    if len(a["records"]) != len(b["records"]):
        out.append(f"{len(a['records'])} vs {len(b['records'])} records")
    for i, (ra, rb) in enumerate(zip(a["records"], b["records"])):
        for t in sorted(set(ra) | set(rb)):
            fa, fb = ra.get(t, {}), rb.get(t, {})
            bad = [k for k in sorted(set(fa) | set(fb))
                   if k not in fa or k not in fb or fa[k].shape != fb[k].shape
                   or fa[k].dtype != fb[k].dtype or not np.array_equal(fa[k], fb[k])]
            if bad:
                out.append(f"record {i} {t} {bad}")
    for key in ("retunes", "tile_retunes", "policy"):
        if a[key] != b[key]:
            out.append(key)
    return out


def tp_adapt_phase(dev, card: str, clock: float, held=()):
    """Phase 4f (module note): each config's adaptive serves and drains on
    one card in this process, plainly and with the ranks' q/k/v GEMMs
    (``tps_witness``), then the two ``gloo`` ranks spawned on the card.
    ``held``: the (M, K, N) of ``ax_matmul`` already held to the plain
    version in this run (the tp serve phase's), not timed again.  Returns
    (rows, ``ax_matmul`` shape rows, ``ax_matmul_grid`` shape rows,
    launches by path, grid launches by path)."""
    import os
    import tempfile

    import torch

    from repro_torch.launch.mesh import spawn
    from repro_torch.models import init_params, transformer
    from repro_torch.serve import engine

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    refs, prompts = {}, {}
    for cfg in _tps_configs():
        params = init_params(cfg, seed=0, device=dev)
        prompts[cfg.name] = torch.randint(0, cfg.vocab, (B, S),
                                          generator=torch.Generator().manual_seed(2))
        use = engine._use_graphs
        engine._use_graphs = lambda device, enabled: False     # the drains eager, as the ranks'
        try:
            plain = _tpa_serves(params, cfg, prompts[cfg.name].to(dev), dev)
            with tps_witness(TPS_RANKS, attention=True):
                witness = _tpa_serves(params, cfg, prompts[cfg.name].to(dev), dev)
        finally:
            engine._use_graphs = use
        refs[cfg.name] = dict(plain=plain, witness=witness)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_adapt_") as tmp:
        path = os.path.join(tmp, "prompts.pt")
        torch.save(prompts, path)
        res = spawn(tp_adapt_rank, TPS_RANKS, args=(path,), device=dev.type, backend="gloo",
                    timeout_s=600)
    ranks_s = time.perf_counter() - t1
    problems, rows, shape_list, grid_list, paths, grid_paths = [], {}, [], [], {}, {}
    for rank, r in enumerate(res):
        if r["nvcc"]:
            problems.append(f"rank {rank}: {r['nvcc']} nvcc runs")
    for cfg in _tps_configs():
        name = cfg.name
        witness, plain = refs[name]["witness"], refs[name]["plain"]
        per = [r[name] for r in res]
        n_ax = len(transformer.ax_projections(cfg))
        steps = per[0]["batcher"]["steps"]
        admissions = 2 * TPA_REQS
        want = {"ax_matmul": n_ax * (2 + admissions),
                "ax_matmul_grid": n_ax * (2 * (TPA_T - 1) + steps)}
        for rank, row in enumerate(per):
            if row["launches"] != want:
                problems.append(f"{name} rank {rank}: launches {row['launches']} (want {want}: "
                                f"{n_ax} projections x (2 prefills + {admissions} admissions), "
                                f"x (2 x {TPA_T - 1} + {steps} steps))")
            if row["captures"]:
                problems.append(f"{name} rank {rank}: {row['captures']} graph captures")
            for key in ("gen0", f"gen{TPA_TILES}", "batcher"):
                diff = _tpa_same(row[key], witness[key])
                if diff:
                    problems.append(f"{name} rank {rank} {key}: differs from one card with the "
                                    f"ranks' q/k/v in {diff[:6]}")
                if _tpa_same(row[key], per[0][key]):
                    problems.append(f"{name} rank {rank} {key}: differs from rank 0's")
        if not per[0]["gen0"]["retunes"]:
            problems.append(f"{name}: the drift serve re-tuned nothing")
        # every launched shape: reckoned from the config and its split
        reck = _tm_tp_shapes(cfg, B * S, TPS_RANKS, f"{name} tp adapt prefill")
        reck_grid = _tm_tp_shapes(cfg, B, TPS_RANKS, f"{name} tp adapt decode")
        for _, proj, K, N in transformer.ax_projections(cfg):
            K, N = (K // TPS_RANKS, N) if proj.endswith(" out") else (K, N // TPS_RANKS)
            reck_grid.setdefault((B, _padded(K), N), f"{name} tp adapt decode tiles {proj}")
        for rank, row in enumerate(per):
            seen = {k: set(map(tuple, v)) for k, v in row["shapes"].items()}
            if seen["ax_matmul"] != set(reck) or seen["ax_matmul_grid"] != set(reck_grid):
                problems.append(f"{name} rank {rank}: kernel shapes {seen}, reckoned "
                                f"{sorted(reck)} and {sorted(reck_grid)}")
        shape_list += [(label,) + k for k, label in sorted(reck.items())]
        grid_list += [(label,) + k for k, label in sorted(reck_grid.items())]
        r0 = per[0]
        st = r0["timing"]
        rows[name] = dict(
            plain_equal={k: not _tpa_same(r0[k], plain[k]) for k in r0 if k in plain},
            plain_diff={k: _tpa_same(r0[k], plain[k])[:3] for k in r0 if k in plain},
            retunes=len(r0["gen0"]["retunes"]),
            tile_retunes=len(r0[f"gen{TPA_TILES}"]["tile_retunes"]),
            batcher_retunes=len(r0["batcher"]["retunes"]), steps=steps,
            prefill_ms=1e3 * st["warm"]["prefill_s"],
            decode_ms={k: 1e3 * v["decode_s"] / (TPA_T - 1) for k, v in st.items()},
            coll_share=[row["coll_s"] / row["timed_s"] for row in per],
            coll_calls=r0["coll_calls"],
            gather_ms=[1e3 * row["gather_s"] for row in per],
            gather_share=[row["gather_s"] / row["gather_timed_s"] for row in per],
            gather_calls=r0["gather_calls"], launches=want)
        paths[f"tp adapt {name} (rank 0)"] = r0["launches"]["ax_matmul"]
        grid_paths[f"tp adapt {name} (rank 0)"] = r0["launches"]["ax_matmul_grid"]
    for name, row in rows.items():
        print(f"tp adapt {name} x{L} on two gloo ranks (('data', 'model') = (1, {TPS_RANKS}), "
              f"fsdp + seq_shard + ep, bf16 mxu, B={B} x {S}, {TPA_T} tokens, drift_hook"
              f"{TPA_DRIFT}, cache {TPA_LEN} rows): the drift serve in scalar and tile mode "
              f"({TPA_TILES} row tiles) and two token-mode drains ({TPA_REQS} requests each on "
              f"{TPA_SLOTS} slots, {row['steps']} steps, the second of the drifted weights) "
              f"bit-equal to one card with the ranks' q/k/v GEMMs: tokens, every observed "
              f"record, re-tunes ({row['retunes']} scalar, {row['tile_retunes']} tile, "
              f"{row['batcher_retunes']} in the drains), policy; the ranks agreeing; "
              f"launches a rank {row['launches']}; 0 graph captures, 0 nvcc; against the plain "
              f"one card (reported): equal {row['plain_equal']} {row['plain_diff']}; the "
              f"warm tile serve: prefill {row['prefill_ms']:.1f} ms, decode ms/step "
              f"{ {k: round(v, 1) for k, v in row['decode_ms'].items()} } (gen: the first "
              f"serves); collectives "
              f"{row['coll_calls']} a tile serve, "
              f"{', '.join(f'{100 * c:.1f}%' for c in row['coll_share'])} of its wall; the "
              f"records' gathers {row['gather_calls']} calls, "
              f"{', '.join(f'{g:.1f} ms' for g in row['gather_ms'])} "
              f"({', '.join(f'{100 * g:.1f}%' for g in row['gather_share'])} of the wall; a "
              f"synchronise around each) [{card}]", flush=True)
    if problems:
        fail("tp adapt: " + "; ".join(problems))
    held = set(held)
    new = [sh for sh in shape_list if tuple(sh[1:]) not in held]
    print(f"tp adapt: {len(shape_list) - len(new)} of {len(shape_list)} ax_matmul shapes held to "
          f"the plain version in the tp serve phase of this run", flush=True)
    shape_rows = main_shape_checks(dev, card, clock, grid_kernel=False, shapes=new)
    grid_rows = main_shape_checks(dev, card, clock, grid_kernel=True, shapes=grid_list)
    print(f"tp adapt: the one-card references {ref_s:.1f} s, the ranks {ranks_s:.1f} s with "
          f"the spawn [{card}]", flush=True)
    rows.update(ref_s=ref_s, ranks_s=ranks_s)
    return rows, shape_rows, grid_rows, paths, grid_paths


def _update_gap_np(new, ref, start) -> float:
    """``_update_gap`` over numpy parameter dicts keyed alike."""
    import numpy as np

    gaps = []
    for p, b in ref.items():
        da, db = new[p] - start[p], b - start[p]
        gaps.append(float(np.linalg.norm(da - db) / max(np.linalg.norm(db), 1e-30)))
    return max(gaps)


def profile_serve(run, label: str, card: str):
    """One more serve (or tuning run) under torch.profiler: device time by
    kernel and the device's busy share of the wall (``--profile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel rows only: operator rows repeat their kernels' device time
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0)
    busy = sum(dev_us(e) for e in kernels) / 1e6
    sweep_events = [e for e in prof.events() if "tuning_sweep" in e.name]
    if sweep_events:
        print(f"profile: {len(sweep_events)} trace events name the sweep kernel, device "
              f"types {sorted({str(e.device_type) for e in sweep_events})}, "
              f"{sum(dev_us(e) for e in sweep_events) / 1e3:.2f} ms of device time", flush=True)
    if busy <= 0:
        print("profile: the trace holds no device kernels", flush=True)
        return
    print(f"profile: one {label}, wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
          f"({100 * busy / wall:.1f}% of the wall) [{card}]", flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:14]:
        print(f"  {dev_us(e) / 1e3:10.2f} ms {100 * dev_us(e) / 1e6 / busy:5.1f}%  "
              f"{e.count:5d} calls  {e.key[:90]}", flush=True)


def _to_device(t, dev):
    if isinstance(t, dict):
        return {k: _to_device(v, dev) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_device(v, dev) for v in t]
    return t.to(dev)


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    elif isinstance(t, list):
        for v in t:
            yield from _leaves(v)
    else:
        yield t


def main(argv):
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no src/repro_torch)")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    clock = float(smi("clocks.max.sm").split()[0])
    print(f"device: {kind}; count {torch.cuda.device_count()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(card, flush=True)

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} source(s) "
          f"into {_build.build_dir()}", flush=True)
    for name, b in built.items():
        print(f"--- {name}: nvcc {b.seconds:.1f} s, -Xptxas -v:\n{b.report.strip()}", flush=True)

    nvcc_runs = _build.NVCC_RUNS["count"]

    phase_t = time.perf_counter()

    def phase_done(name):
        nonlocal phase_t
        now = time.perf_counter()
        print(f"[phase {name}: {now - phase_t:.1f} s]", flush=True)
        phase_t = now

    small_checks(dev)
    rows = main_shape_checks(dev, card, clock, grid_kernel=False)
    grid_rows = main_shape_checks(dev, card, clock, grid_kernel=True)
    for r, gr in zip(rows[:3], grid_rows[:3]):
        print(f"decode {r['shape']}: ax_matmul_grid (tile mode, bm = M/2) / ax_matmul = "
              f"{gr['ms'] / r['ms']:.3f} [{card}]", flush=True)
    c_rows = main_shape_checks(dev, card, clock, grid_kernel=False,
                               mult_name="mul8s_drum3_4", shapes=MAIN_SHAPES[:3])
    c_grid_rows = main_shape_checks(dev, card, clock, grid_kernel=True,
                                    mult_name="mul8s_drum3_4", shapes=MAIN_SHAPES[:3])
    equal_blocks_timing(dev, card)
    sync_free_grid_launch(dev)
    sweep_errs = [sweep_small_checks(dev)]
    sweep_rows = sweep_full_size(dev, card, clock)
    phase_done("kernel")
    ref_checks = reference_check(dev)
    phase_done("ref")
    # whisper and training run before the serve phase, whose 2-layer qwen2
    # (17 GB of f32 weights, their codes and graphs) stays on the card to
    # the end: deepseek's 13 GB train state and its update need the room
    whisper_row, whisper_shape_rows, w_paths = whisper_phase(dev, card, clock)
    phase_done("whisper")
    train_rows, train_shape_rows, train_grid_rows, t_paths, t_grid_paths = \
        train_phase(dev, card, clock)
    phase_done("train")
    # the mesh phase spawns two ranks that each hold the serve's model
    m_paths, m_grid_paths, mesh_info = mesh_phase(dev, card)
    phase_done("mesh")
    tm_rows, tm_shape_rows, tm_grid_rows, tp_shape_rows, tp_grid_rows, tm_paths, \
        tm_grid_paths = train_mesh_phase(dev, card, clock)
    phase_done("train mesh")
    tps_rows, tps_shape_rows, tps_paths = tp_serve_phase(dev, card, clock)
    phase_done("tp serve")
    tpa_rows, tpa_shape_rows, tpa_grid_rows, tpa_paths, tpa_grid_paths = tp_adapt_phase(
        dev, card, clock, held=[(r["M"], r["K"], r["N"]) for r in tps_shape_rows])
    phase_done("tp adapt")
    profile = "--profile" in argv
    cfg, params, prompts, tokens, paths, stats = serve(dev, card, profile)
    paths.update(w_paths)
    paths.update(t_paths)
    paths.update(m_paths)
    paths.update(tm_paths)
    paths.update(tps_paths)
    paths.update(tpa_paths)
    phase_done("serve")
    autotune_rows = autotune_phase(dev, card, cfg, params, prompts, tokens)
    phase_done("autotune")
    grid_paths = adaptive_serve(cfg, params, prompts, tokens, stats, card, profile)
    grid_paths.update(t_grid_paths)
    grid_paths.update(m_grid_paths)
    grid_paths.update(tm_grid_paths)
    grid_paths.update(tpa_grid_paths)
    phase_done("adapt")
    paths["per-slot graph"] = slot_serve(cfg, params, card)
    paths["token-granular graph"] = token_serve(cfg, params, card)
    phase_done("slot and token")
    f_paths, f_grid_paths = fleet_serve(cfg, params, card)
    paths.update(f_paths)
    grid_paths.update(f_grid_paths)
    phase_done("fleet")
    a_paths, g_paths, device_trace_serve = rollout_serve(cfg, params, prompts, card)
    paths.update(a_paths)
    grid_paths.update(g_paths)
    phase_done("rollout")
    family_rows, family_shape_rows, family_grid_rows, f_paths, f_grid_paths = \
        families(dev, card, clock)
    paths.update(f_paths)
    grid_paths.update(f_grid_paths)
    phase_done("families")
    for name, by_path in (("ax_matmul", paths), ("ax_matmul_grid", grid_paths)):
        if not all(v > 0 for v in by_path.values()):
            fail(f"{name} was not launched on every serving path: {by_path}")
    launches, grid_launches = paths["static eager"], grid_paths["drift (stepwise, eager)"]
    tune_rows, sweep_launches, err = tune_table(dev, card, profile)
    sweep_errs.append(err[:2])
    phase_done("tune")
    _, _, err = app_table(dev, card, profile)
    sweep_errs.append(err[:2])
    phase_done("apps")
    device_trace_serve()
    from repro_torch.serve import graph as G

    G.clear_programs()
    del params, device_trace_serve
    torch.cuda.empty_cache()
    sweep_errs += [(r["max_abs_err"], r["max_rel_err_f32"]) for r in sweep_rows]
    if _build.NVCC_RUNS["count"] != nvcc_runs or len(_build._LOADED) != len(built):
        fail(f"kernels were rebuilt after the build phase: nvcc runs "
             f"{_build.NVCC_RUNS['count'] - nvcc_runs}, libraries {len(_build._LOADED)}")
    print(f"no nvcc run and no new library after the build phase "
          f"({len(_build._LOADED)} libraries loaded)", flush=True)

    def entry(name, replaces, launches, by_path, rows, c_rows):
        top = rows[0]
        return {"name": name, "route": "cuda", "kernel_route": top["route"],
                "source": "src/repro_torch/kernels/csrc/ax_matmul.cu",
                "replaces": replaces, "launches": launches, "launches_by_path": by_path,
                "max_abs_err": max(r["max_abs_err"] for r in rows + c_rows),
                "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
                "bound_by": top["bound_by"], "library_ms": top["library_ms"],
                "shape": f"{top['shape']} M={top['M']} K={top['K']} N={top['N']}",
                "shapes": rows, "route_c_shapes": c_rows, "card": card}

    top = sweep_rows[0]
    sweep = {"name": "tuning_sweep", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/tuning_sweep.cu",
             "replaces": "src/repro/kernels/tuning_sweep.py:90", "launches": sweep_launches,
             "max_abs_err": max(e[0] for e in sweep_errs),
             "max_rel_err_f32": max(e[1] for e in sweep_errs),
             "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
             "bound_by": top["bound_by"], "library_ms": None,
             "library_note": "no single PyTorch call computes these row statistics",
             "shape": f"{top['mult']} exhaustive N={top['N']}; plain on 1024 rows",
             "shapes": sweep_rows, "table_i": tune_rows, "card": card}
    ax_entry = entry("ax_matmul", "src/repro/kernels/ax_matmul.py:168", launches, paths,
                     rows, c_rows)
    grid_entry = entry("ax_matmul_grid", "src/repro/kernels/ax_matmul.py:253", grid_launches,
                       grid_paths, grid_rows, c_grid_rows)
    for e, fam_rows, w_rows, t_rows, tm_rows_, tp_rows_, tps_rows_, tpa_rows_ in (
            (ax_entry, family_shape_rows, whisper_shape_rows, train_shape_rows, tm_shape_rows,
             tp_shape_rows, tps_shape_rows, tpa_shape_rows),
            (grid_entry, family_grid_rows, [], train_grid_rows, tm_grid_rows, tp_grid_rows,
             [], tpa_grid_rows)):
        e["family_shapes"] = fam_rows
        e["whisper_shapes"] = w_rows
        e["train_shapes"] = t_rows
        e["train_mesh_shapes"] = tm_rows_
        e["train_tp_shapes"] = tp_rows_
        e["tp_serve_shapes"] = tps_rows_
        e["tp_adapt_shapes"] = tpa_rows_
        e["max_abs_err"] = max([e["max_abs_err"]] + [
            r["max_abs_err"] for r in fam_rows + w_rows + t_rows + tm_rows_ + tp_rows_
            + tps_rows_ + tpa_rows_])
    ax_entry["whisper"] = {k: whisper_row[k] for k in (
        "name", "layers", "enc_layers", "params_g", "ax_per_forward", "ax_per_decode",
        "launches", "decode_vs_full_rel", "graph_decode_ms_per_step")}
    ax_entry["train"] = train_rows
    ax_entry["autotune"] = autotune_rows
    ax_entry["mesh"] = mesh_info
    ax_entry["train_mesh"] = tm_rows
    ax_entry["tp_serve"] = tps_rows
    ax_entry["tp_adapt"] = tpa_rows
    ax_entry["families"] = [{k: r[k] for k in ("name", "layers", "params_g", "ax_per_forward",
                                               "launches")} for r in family_rows]
    ax_entry["reduced_card_vs_cpu"] = {
        n: {"max_abs_diff": e, "tokens_equal": q, "moe_flips": f}
        for n, (e, q, f) in ref_checks.items()}
    summary = {"kernels": [ax_entry, grid_entry, sweep]}
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
