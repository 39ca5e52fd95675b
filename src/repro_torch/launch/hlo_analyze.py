"""Profiling aid of a dry-run cell (``repro.launch.hlo_analyze``): its
largest ops by output bytes.

JAX reads them from the compiled cell's post-SPMD HLO.  The port has no
HLO: this runs the cell's step on a fake world as ``launch/dryrun.py``
does, at full depth, and lists what its op recorder kept: per-op-kind
totals of output bytes (the collectives under JAX's kinds), then the
largest single ops, with JAX's flags (``--top``, ``--collectives-only``).
An op here is one ATen or ``c10d`` call, unfused, where an HLO op is often
a fusion of several.

    PYTHONPATH=src python -m repro_torch.launch.hlo_analyze --arch mamba2-370m \\
        --shape train_4k [--fsdp 0] [--top 25]
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import ParallelConfig
from repro_torch.configs.base import AxPolicy

from .dryrun import run_cell
from .roofline import COLLECTIVES

__all__ = ["report", "main"]


def report(rec, top: int = 25, collectives_only: bool = False, out=None) -> None:
    """Print a recorder's tables (module note) to ``out`` (stdout)."""
    out = out or sys.stdout
    print("== per-op-kind totals (output bytes, count) ==", file=out)
    for op, (b, c) in sorted(rec.kinds.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {op:28s} {b / 1e9:10.3f} GB  x{c}", file=out)
    print("\n== largest individual ops ==", file=out)
    shown = 0
    for b, op, shape in rec.largest():
        if collectives_only and op not in COLLECTIVES:
            continue
        print(f"  {b / 1e9:9.3f} GB {op:24s} {shape[:90]}", file=out)
        shown += 1
        if shown >= top:
            break


def _parser() -> argparse.ArgumentParser:
    """The CLI's flags: JAX's (no device: the cell runs on fake tensors)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--seq-shard", type=int, default=1)
    ap.add_argument("--remat", default="layer")
    ap.add_argument("--ax", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--collectives-only", action="store_true")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    par = ParallelConfig(fsdp=bool(args.fsdp), seq_shard=bool(args.seq_shard), ep=True,
                         remat=args.remat)
    ax = AxPolicy(backend="mxu") if args.ax else None
    row = run_cell(args.arch, args.shape, args.multi_pod, par, ax, verbose=False,
                   extrapolate=False, keep_recorder=True)
    if row["status"] != "ok":
        print(f"{args.arch} {args.shape}: {row['status']} ({row.get('reason')})")
        return 0
    report(row["recorder"], args.top, args.collectives_only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
