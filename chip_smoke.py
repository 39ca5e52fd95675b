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
            (every REGISTRY multiplier whose product table fits; three swap
            configs, or a seeded grid mixing NoSwap, A-side and B-side
            triples; ``tile_hist`` on and off; ragged M/N; padded K; both
            grid orders) and at the main path's shapes, with CUDA-event
            times beside the bound and ``torch._int_mm`` on the K-stacked
            limbs as the library yardstick; both kernels timed in turns at
            equal blocks; one grid launch runs under
            ``torch.cuda.set_sync_debug_mode("error")``.  ``tuning_sweep``
            against its plain version on the card: all 90 REGISTRY
            multipliers at N = 256 (8-bit exhaustive, 12- and 16-bit
            sampled at 8 bits), a LUT multiplier and a ragged N; integer
            stats ``torch.equal``, float32 sums within 1e-6 relative; then
            exhaustive 16-bit sweeps (N = 65536, 2^32 pairs) of Table I's
            16-bit rows, held to the plain version on 1024 seeded rows,
            with CUDA-event times beside the bound (operations counted from
            each family's definition: per pair what depends on both
            operands, per value what depends on one; integer ops over the
            int32 lanes, float ops over the float32 lanes) and the plain
            version's time; every check goes through the ``tuning_sweep``
            wrapper;
4. ref    — a reduced qwen2 served on the card agrees with the same model
            served on the CPU through the plain versions, static and
            adaptive (tokens and re-tunes);
5. serve  — qwen2-72b at its published widths, depth cut to 2 layers,
            random weights from a seed, SWAPPER ``backend="kernel"``: B=4
            prompts of 32 tokens, 8 greedy tokens, twice; the tokens must be
            deterministic and the kernel's launch count must be exactly
            2 layers x 4 projections x 8 forwards = 64;
6. adapt  — the same model served with an ``AdaptiveController``: with a
            threshold that never fires the tokens equal the static serve's
            (8 ``ax_matmul`` launches in prefill, 56 ``ax_matmul_grid`` in
            decode); with weight drift injected at step 3 in tile mode, 12
            tokens, twice with fresh controllers: at least one re-tune,
            the same tokens, 8 + 88 launches each.  No nvcc runs after
            phase 2.  With ``--profile`` one static, one no-drift and one
            drift serve run under ``torch.profiler`` and the device time by
            kernel and the device's busy share are printed (and, in phases
            7 and 8, one 16-bit Table I row and one app run).
7. tune   — Table I (``benchmarks/component_table.py``'s multipliers) on
            the card through ``component_sweep`` and the sweep kernel: 8,
            12 and 16 bits exhaustive (the JAX table samples 16 bits at
            2^10); one launch per sweep; the 8-bit rows and a 16-bit row at
            ``sample_bits=10`` equal the same sweeps on the CPU (integer
            fields and ``best("mae")``); each of the 25 sweeps, launched
            again, equals the plain version (every row up to N = 4096, 1024
            seeded rows at N = 65536);
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

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
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
                                               product_table)
    from repro_torch.quant.ax import _pad_to_multiple

    g = torch.Generator().manual_seed(7)
    # (M, K logical, N, (bm, bn, bk), grid order): ragged M/N edges, K
    # zero-padded to a multiple of bk, both grid orders, decode-sized M
    cases = [(37, 50, 45, (16, 32, 32), "mn"),
             (64, 128, 96, (32, 64, 64), "nm"),
             (4, 256, 200, (4, 128, 128), "mn")]
    n_ok, n_grid, skipped = 0, 0, []
    for name, mult in REGISTRY.items():
        dtype = torch.int8 if mult.signed else torch.uint8
        try:
            product_table(mult, dtype, dev)
        except ValueError:
            skipped.append(name)
            continue
        lo, hi = (-128, 128) if mult.signed else (0, 256)
        for M, K, N, (bm, bn, bk), order in cases:
            a = torch.randint(lo, hi, (M, K), generator=g).to(dtype)
            b = torch.randint(lo, hi, (K, N), generator=g).to(dtype)
            a = _pad_to_multiple(a, bk, 1).contiguous().to(dev)
            b = _pad_to_multiple(b, bk, 0).contiguous().to(dev)
            for swap in (None, SwapConfig("A", 3, 1), SwapConfig("B", 6, 0)):
                for hist in (False, True):
                    got = ax_matmul_cuda(a, b, mult, swap, bm=bm, bn=bn, bk=bk,
                                         grid_order=order, tile_hist=hist)
                    want = ax_matmul_plain(a, b, mult, swap, bm=bm, bn=bn,
                                           tile_hist=hist)
                    torch.cuda.synchronize()
                    pairs = zip(got, want) if hist else [(got, want)]
                    for x, y in pairs:
                        if not torch.equal(x, y):
                            fail(f"ax_matmul != plain: {name} {(M, K, N)} "
                                 f"blocks {(bm, bn, bk)} {order} swap {swap} "
                                 f"hist {hist}: max |diff| "
                                 f"{(x.long() - y.long()).abs().max().item()}")
                    n_ok += 1
            grid = mixed_grid(-(-M // bm), -(-b.shape[1] // bn), g, mult.bits).to(dev)
            for hist in (False, True):
                got = ax_matmul_grid_cuda(a, b, mult, grid, bm=bm, bn=bn, bk=bk,
                                          grid_order=order, tile_hist=hist)
                want = ax_matmul_grid_plain(a, b, mult, grid, bm=bm, bn=bn, tile_hist=hist)
                torch.cuda.synchronize()
                for x, y in (zip(got, want) if hist else [(got, want)]):
                    if not torch.equal(x, y):
                        fail(f"ax_matmul_grid != plain: {name} {(M, K, N)} blocks "
                             f"{(bm, bn, bk)} {order} hist {hist}: max |diff| "
                             f"{(x.long() - y.long()).abs().max().item()}")
                n_grid += 1
    fits = len(REGISTRY) - len(skipped)
    print(f"kernel ax_matmul == plain (torch.equal) on {n_ok} small cases, "
          f"ax_matmul_grid == plain on {n_grid} ({fits} multipliers; table does not "
          f"fit, skipped: {', '.join(skipped) or 'none'})", flush=True)


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


def main_shape_checks(dev, card: str, clock_mhz: float, grid_kernel: bool):
    """One kernel at the main path's shapes: held against its plain version,
    timed beside its bound, its plain version and ``torch._int_mm`` on the
    K-stacked limbs (the library yardstick; the port never calls it).

    ``ax_matmul``: default 128/128/128 blocks, swap A[3]==0.  ``ax_matmul_grid``:
    the blocks of tile mode with 2 row tiles (bm = M/2: 2 at decode, 64 at
    prefill) and a 2-row-tile A-side grid (A[3]==0, A[5]==1)."""
    import torch

    from repro_torch.core.multipliers import get
    from repro_torch.core.swapper import SwapConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ax_matmul_grid_blocks_ref, ax_matmul_ref
    from repro_torch.kernels.schedule import KernelSchedule
    from repro_torch.quant.ax import separable_transforms

    mult = get("mul8s_trunc0_4")
    f, gfn = separable_transforms(mult.name)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int32_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    gen = torch.Generator(device=dev).manual_seed(11)
    name = "ax_matmul_grid" if grid_kernel else "ax_matmul"
    rows = []
    for label, M, K, N in MAIN_SHAPES:
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        cols = N if M <= 4 else 256             # bound the plain version's time
        bs = b[:, :cols].contiguous()
        if grid_kernel:
            bm, bn = M // 2, 128
            triples = torch.tensor([[1, 3, 0], [1, 5, 1]], dtype=torch.int32, device=dev)
            grid = triples[:, None, :].expand(2, -(-N // bn), 3).contiguous()
            sched = KernelSchedule(bm, bn, 128)
            run = lambda: ops.ax_matmul_grid(a, b, mult, grid, schedule=sched)
            gs = grid[:, :-(-cols // bn)].contiguous()
            plain = lambda: ax_matmul_grid_blocks_ref(a, bs, mult, gs, bm, bn)
            row_trip = triples.repeat_interleave(bm, dim=0)            # (M, 3)
            grid_bytes = grid.numel() * 4
        else:
            swap = SwapConfig("A", 3, 0)
            run = lambda: ops.ax_matmul(a, b, mult, swap)
            plain = lambda: ax_matmul_ref(a, bs, mult, swap)
            row_trip = torch.tensor([[1, 3, 0]], dtype=torch.int32, device=dev).expand(M, 3)
            grid_bytes = 0
        out = run()
        want = plain()
        torch.cuda.synchronize()
        err = (out[:, :cols].long() - want.long()).abs().max().item()
        if err != 0:
            fail(f"{name} != plain at {label} {(M, K, N)}: max |diff| {err}")
        ms = cuda_ms(run, iters=5 if M > 4 else 20)
        plain_ms = cuda_ms(plain, iters=1, warmup=0)

        # library yardstick: the same function for this separable family and
        # an A-side decision per row, as one int8 GEMM over the K-stacked
        # limbs (M padded to 32 rows)
        ai, bi = a.to(torch.int32), b.to(torch.int32)
        s_ = (((ai >> row_trip[:, 1:2]) & 1) == row_trip[:, 2:3]).to(torch.int32)
        x = torch.cat([s_ * gfn(ai), (1 - s_) * f(ai)], dim=1).to(torch.int8)
        y = torch.cat([f(bi), gfn(bi)], dim=0).to(torch.int8).contiguous()
        mp = max(32, -(-M // 8) * 8)
        xp = torch.zeros((mp, 2 * K), dtype=torch.int8, device=dev)
        xp[:M] = x
        lib_equal = bool(torch.equal(torch._int_mm(xp, y)[:M], out))
        library_ms = cuda_ms(lambda: torch._int_mm(xp, y), iters=20)
        del ai, bi, s_, x, y, xp

        nbytes = M * K + K * N + 4 * M * N + TABLE_BYTES + grid_bytes
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = M * K * N / int32_rate * 1e3
        row = dict(shape=label, M=M, K=K, N=N, ms=ms, plain_ms=plain_ms,
                   plain_cols=cols, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=library_ms, library_equal=lib_equal, max_abs_err=err)
        rows.append(row)
        print(f"{name} {label} (M={M}, K={K}, N={N}): {ms:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); plain "
              f"{plain_ms:.2f} ms on {cols} cols; torch._int_mm limbs "
              f"{library_ms:.4f} ms (equal: {lib_equal}); max |diff| {err}; "
              f"[{card}]", flush=True)
        del a, b, bs, out, want
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
    sums, the number of sweeps)."""
    import torch

    from repro_torch.core.tuning import operand_values
    from repro_torch.kernels.tuning_sweep import tuning_sweep, tuning_sweep_plain

    g = torch.Generator().manual_seed(14)
    int_err, rel_err = 0, 0.0
    for m, sample_bits in specs:
        vals = torch.from_numpy(operand_values(m.bits, m.signed, sample_bits)).to(dev)
        n = vals.numel()
        rows = None if n <= 4096 else torch.randperm(n, generator=g)[:1024].to(dev)
        got = tuning_sweep(m, vals)
        want = tuning_sweep_plain(m, vals, rows=rows)
        i, r = sweep_compare(got, want, f"{label}: {m.name} N={n}", rows)
        int_err, rel_err = max(int_err, i), max(rel_err, r)
    return int_err, rel_err, len(specs)


def sweep_small_checks(dev):
    """``tuning_sweep`` == plain on every REGISTRY multiplier at N = 256, a
    LUT multiplier and a ragged N; a multiplier without a kernel descriptor
    raises on the card."""
    import torch

    from repro_torch.core.multipliers import REGISTRY, get, lut_mult, make_lut
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
          f"multipliers at N=256, a LUT, a ragged N=300): integer stats max |diff| "
          f"{int_err}, sq/rel max relative diff {worst:.3g} (tol {SWEEP_RTOL}); a "
          f"multiplier without a descriptor raises", flush=True)
    return int_err, worst


def sweep_full_size(dev, card: str, clock_mhz: float):
    """Exhaustive 16-bit sweeps of Table I's 16-bit rows: the kernel's time
    beside its bound and the plain version's time on 1024 seeded rows,
    which the kernel's rows must equal.  The bound is the larger of the
    integer operations over the int32 lanes and the float ones over the
    float32 lanes (:func:`pair_ops`: N^2 pairs, and N values for the work
    on one operand), and the bytes."""
    import torch

    from repro_torch.core.multipliers import get
    from repro_torch.core.tuning import operand_values
    from repro_torch.kernels.tuning_sweep import pair_ops, tuning_sweep, tuning_sweep_plain

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int32_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    fp32_rate = sms * FP32_LANES_PER_SM * clock_mhz * 1e6
    g = torch.Generator().manual_seed(13)
    rows_out = []
    for name in MULTS_16:
        m = get(name)
        vals = torch.from_numpy(operand_values(16, m.signed)).to(dev)
        n = vals.numel()
        out = {}
        ms = cuda_ms(lambda: out.update(s=tuning_sweep(m, vals)), iters=1)
        rows = torch.randperm(n, generator=g)[:1024].to(dev)
        plain = {}
        plain_ms = cuda_ms(lambda: plain.update(s=tuning_sweep_plain(m, vals, rows=rows)),
                           iters=1)
        err, rel = sweep_compare(out["s"], plain["s"], f"{name} N={n} (1024 rows)", rows)
        ints, floats, operand = pair_ops(m)
        t_int = (n * n * ints + n * operand) / int32_rate * 1e3
        t_float = n * n * floats / fp32_rate * 1e3
        t_ops = max(t_int, t_float)
        t_bytes = (4 * n + 72 * n) / HBM_BYTES_PER_S * 1e3
        row = dict(mult=name, N=n, ms=ms, plain_ms=plain_ms, plain_rows=1024,
                   bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes
                   else "bytes", bound_int_ms=t_int, bound_float_ms=t_float,
                   pair_int_ops=ints, pair_float_ops=floats, operand_int_ops=operand,
                   max_abs_err=err, max_rel_err_f32=rel)
        rows_out.append(row)
        print(f"tuning_sweep {name} exhaustive N={n} ({n * n} pairs): {ms:.2f} ms; bound "
              f"{row['bound_ms']:.2f} ms ({row['bound_by']}: {ints} integer ops per pair + "
              f"{operand} per value over int32 lanes, {t_int:.2f} ms; {floats} float ops per "
              f"pair over float32 lanes, {t_float:.2f} ms); kernel/bound "
              f"{ms / row['bound_ms']:.2f}; plain {plain_ms:.2f} ms on 1024 rows (integer "
              f"stats max |diff| {err}, sums within {rel:.3g}); library: none [{card}]",
              flush=True)
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

def reference_check(dev):
    import torch

    from repro_torch.configs import qwen2_72b, reduced
    from repro_torch.configs.base import AxPolicy
    from repro_torch.launch.serve import drift_hook
    from repro_torch.models import init_params, prefill
    from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy
    from repro_torch.serve import ServeConfig, generate

    # f32 compute isolates the kernel from bf16 rounding; int8 rounding
    # flips from last-bit f32 differences move a logit by ~1e-2 at most
    tol = 5e-2
    cfg = dataclasses.replace(reduced(qwen2_72b), n_layers=2, compute_dtype="float32",
                              ax=AxPolicy(backend="kernel"))
    p_cpu = init_params(cfg, seed=3, device="cpu")
    p_gpu = _to_device(p_cpu, dev)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        lc, _ = prefill(p_cpu, {"tokens": toks}, cfg, max_cache_len=16)
        lg, _ = prefill(p_gpu, {"tokens": toks.to(dev)}, cfg, max_cache_len=16)
    err = (lc - lg.cpu()).abs().max().item()
    if not err <= tol:
        fail(f"reduced qwen2 prefill logits, card vs CPU: max |diff| {err} > {tol}")
    tc = generate(p_cpu, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=6))
    tg = generate(p_gpu, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=6)).cpu()
    print(f"reduced qwen2 (2 layers, f32) card vs CPU: prefill logits max |diff| "
          f"{err:.3g} (tol {tol}); greedy tokens equal: {bool(torch.equal(tc, tg))}",
          flush=True)
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


# ---------------------------------------------------------------------------
# phase 5: the full-width serve
# ---------------------------------------------------------------------------

B, S, T, L = 4, 32, 8, 2          # the serve: prompts, prompt length, tokens, layers
T_DRIFT, DRIFT_AT, DRIFT_SCALE = 12, 3, 0.05


def serve(dev, card: str, profile: bool = False):
    """Phase 5: the static serve.  Returns (cfg, params, prompts, tokens,
    launches, stats)."""
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
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        logits, _ = prefill(params, {"tokens": prompts.to(dev)}, cfg,
                            max_cache_len=S + T + 1)
    if tuple(logits.shape) != (B, S, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    del logits

    expect = L * 4 * T
    runs = []
    for _ in range(2):
        stats = {}
        reset_launches()
        toks = generate(params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=T),
                        stats=stats)
        launches = dict(LAUNCHES)
        if launches != {"ax_matmul": expect, "ax_matmul_grid": 0}:
            fail(f"launches in one static serve: {launches}, expected {expect} ax_matmul")
        runs.append((toks.cpu(), stats))
    (t1, _), (t2, stats) = runs
    if not torch.equal(t1, t2):
        fail(f"greedy tokens differ between two runs:\n{t1}\n{t2}")
    if tuple(t1.shape) != (B, T) or int(t1.min()) < 0 or int(t1.max()) >= cfg.vocab:
        fail(f"tokens out of range or misshapen: {tuple(t1.shape)}")
    print(f"serve qwen2-72b (2 layers, kernel backend) B={B} S={S} new={T}: tokens "
          f"deterministic over 2 runs; ax_matmul launches {expect} (= {L}x4x{T}); "
          f"{_speed(stats, T)} [{card}]", flush=True)
    print(f"tokens: {t1.tolist()}", flush=True)
    if profile:
        profile_serve(lambda: generate(params, {"tokens": prompts}, cfg,
                                       ServeConfig(max_new_tokens=T)), "static serve", card)
    return cfg, params, prompts, t1, expect, stats


def _speed(stats, steps: int) -> str:
    wall = stats["prefill_s"] + stats["decode_s"]
    return (f"prefill {stats['prefill_s'] * 1e3:.1f} ms; decode "
            f"{stats['decode_s'] * 1e3 / (steps - 1):.1f} ms/step; "
            f"{B * steps / wall:.2f} tokens/s")


def adaptive_serve(cfg, params, prompts, static_tokens, static_stats, card: str,
                   profile: bool = False):
    """Phase 6: adaptive serving of the same model.  Returns the drift
    serve's ax_matmul_grid launches."""
    import torch

    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
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
    toks = generate(params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=T),
                    adaptive=ctrl, stats=stats).cpu()
    launches = dict(LAUNCHES)
    want = {"ax_matmul": L * 4, "ax_matmul_grid": L * 4 * (T - 1)}
    if launches != want:
        fail(f"launches in the no-drift adaptive serve: {launches}, expected {want}")
    if not torch.equal(toks, static_tokens) or ctrl.retunes or ctrl.step != T - 1:
        fail(f"no-drift adaptive serve: tokens equal {torch.equal(toks, static_tokens)}, "
             f"re-tunes {len(ctrl.retunes)}, observed steps {ctrl.step}")
    print(f"adaptive serve, no drift (scalar mode): tokens equal the static serve's; "
          f"launches {launches}; {_speed(stats, T)} (static: {_speed(static_stats, T)}) "
          f"[{card}]", flush=True)
    if profile:
        profile_serve(lambda: generate(
            params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=T),
            adaptive=controller(drift_threshold=1e9)), "no-drift adaptive serve", card)

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
    return launches["ax_matmul_grid"]


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
    print(f"ax_matmul dynamic shared memory per block: {TABLE_BYTES} (product table) "
          f"+ bm*bk + bk*bn bytes = {TABLE_BYTES + 2 * 128 * 128} at 128/128/128", flush=True)

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
    equal_blocks_timing(dev, card)
    sync_free_grid_launch(dev)
    sweep_errs = [sweep_small_checks(dev)]
    sweep_rows = sweep_full_size(dev, card, clock)
    phase_done("kernel")
    reference_check(dev)
    phase_done("ref")
    profile = "--profile" in argv
    cfg, params, prompts, tokens, launches, stats = serve(dev, card, profile)
    grid_launches = adaptive_serve(cfg, params, prompts, tokens, stats, card, profile)
    del params
    torch.cuda.empty_cache()
    phase_done("serve and adapt")
    tune_rows, sweep_launches, err = tune_table(dev, card, profile)
    sweep_errs.append(err[:2])
    phase_done("tune")
    _, _, err = app_table(dev, card, profile)
    sweep_errs.append(err[:2])
    phase_done("apps")
    sweep_errs += [(r["max_abs_err"], r["max_rel_err_f32"]) for r in sweep_rows]
    if _build.NVCC_RUNS["count"] != nvcc_runs or len(_build._LOADED) != len(built):
        fail(f"kernels were rebuilt after the build phase: nvcc runs "
             f"{_build.NVCC_RUNS['count'] - nvcc_runs}, libraries {len(_build._LOADED)}")
    print(f"no nvcc run and no new library after the build phase "
          f"({len(_build._LOADED)} libraries loaded)", flush=True)

    def entry(name, replaces, launches, rows):
        top = rows[0]
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/ax_matmul.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
                "bound_by": top["bound_by"], "library_ms": top["library_ms"],
                "shape": f"{top['shape']} M={top['M']} K={top['K']} N={top['N']}",
                "shapes": rows, "card": card}

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
    summary = {"kernels": [
        entry("ax_matmul", "src/repro/kernels/ax_matmul.py:168", launches, rows),
        entry("ax_matmul_grid", "src/repro/kernels/ax_matmul.py:253", grid_launches,
              grid_rows),
        sweep]}
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
