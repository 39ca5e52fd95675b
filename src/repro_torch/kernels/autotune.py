"""Kernel-schedule autotuner of the port (``repro.kernels.autotune``): a
timed sweep over the launch shapes of the CUDA matmuls, and tables shared
through the policy store's file protocol.

* :func:`candidate_schedules` lists the schedules swept for one dispatch
  signature.  Candidate 0 is always the default, ``plan()``'s own launch
  shape, so a winner is never slower than what shipped in the same timed
  loop.  Then route T's m16 tiles per block (route C's rows per thread)
  up to plan's, x the split of K over a ladder bounded by the K steps, x
  the grid order; the full sweep adds cap variants at 32 and 64 for the
  static ops (as the JAX package's full mode does) and route C's slot
  counts.  Candidates that launch what an earlier one launches are
  dropped.  ``quick`` roughly halves the set.  Every candidate gives the
  default's bits (``ax_matmul.plan``).
* :func:`sweep` times candidates interleaved round-robin, best of
  ``reps``, after ``warmup`` calls, through a ``timer``.  On the card a
  candidate is the kernel alone: a CUDA graph of ``R`` back-to-back
  dispatches, replayed between CUDA events (events around one wrapper call
  read the host's dispatch below K x N = 1e7).  On the CPU the host clock
  times the plain versions, whose walls say nothing about the card.
* :func:`tune_signature` / :func:`tune_table` run the sweep on the
  production dispatch (``quant.ax``) over int8 operands from
  ``numpy.random.default_rng(seed)`` and collect winners into a
  :class:`~repro_torch.kernels.schedule.ScheduleTable` whose
  ``meta["device"]`` names the card.
* :class:`ScheduleStore` / :class:`ScheduleReader` keep tables with the
  JAX package's protocol (``schedules_v%06d.json``, ``CURRENT``,
  ``HEARTBEAT`` with ``mtime_ns == version``, one writer, a
  ``schedule_publish`` audit event, degraded reads), so either package's
  reader adopts the other's tables.  An adoption installs the table: no
  nvcc run, no graph re-capture.

CLI::

    python -m repro_torch.kernels.autotune --quick --shapes 4x8192x29568 \\
        --backends kernel,mxu [--out table.json] [--store DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import re
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.tiling import largest_divisor_leq

from .ax_matmul import BLOCK_N, K_STEP, _whole_steps, plan, route_of
from .schedule import MAX_BLOCK, KernelSchedule, ScheduleTable, install_table, sig_key

__all__ = ["candidate_schedules", "sweep", "tune_signature", "tune_table", "ScheduleStore",
           "ScheduleReader", "DEFAULT_OPS", "dispatch_fn", "operands", "main"]

_REG = obs.default_registry()
_TUNER_WALL = _REG.gauge(
    "repro_sched_tuner_wall_s", "wall seconds of the last autotune sweep")
_TUNER_CANDIDATES = _REG.counter(
    "repro_sched_tuner_candidates_total", "candidate schedules measured")
_TUNER_SIGNATURES = _REG.counter(
    "repro_sched_tuner_signatures_total", "dispatch signatures tuned")
_STORE_PUBLISHED = _REG.gauge(
    "repro_sched_store_published_version", "last published schedule-table version")
_STORE_PUBLISHES = _REG.counter(
    "repro_sched_store_publishes_total", "schedule-table publishes")
_READER_POLLS = _REG.counter(
    "repro_sched_reader_polls_total",
    "schedule reader polls by path (heartbeat = one-stat fast path)")
_READER_ADOPTIONS = _REG.counter(
    "repro_sched_reader_adoptions_total", "schedule-table adoptions by readers")
_READ_ERRORS = _REG.counter(
    "repro_sched_store_read_errors_total", "degraded schedule-table reads")

_READ_ERRS = (OSError, ValueError, KeyError, TypeError)

# ops tuned per backend by default (the JAX package's signature ops)
DEFAULT_OPS = {
    "kernel": ("matmul", "matmul_grid"),
    "mxu": ("int_static", "int_dyn"),
}
STATIC_OPS = ("matmul", "int_static")
GRAPH_REPS = {True: 10, False: 3}     # dispatches per timed graph: M <= 16, M > 16


# ---------------------------------------------------------------------------
# candidate generation
# ---------------------------------------------------------------------------

def _padded(v: int, cap: int) -> int:
    """``v`` rounded up to a multiple of ``min(cap, v)``, as the quant layer
    pads an operand dim."""
    c = min(cap, v)
    return -(-v // c) * c


def _launch_key(s: KernelSchedule, route: str, M: int, K: int, N: int, sms: int):
    """What a dispatch under ``s`` launches: its caps, grid order and plan."""
    caps = (min(s.bm, M), min(s.bn, N), min(s.bk, K))
    shape = (_padded(M, s.bm), _padded(N, s.bn), _padded(K, s.bk))
    return caps, s.grid_order, plan(route, *shape, sms, **s.knobs())


def candidate_schedules(backend: str, M: int, K: int, N: int, op: str = "matmul",
                        quick: bool = False, route: str = "T",
                        sms: int = 132) -> List[KernelSchedule]:
    """The schedule space swept for one dispatch signature (module note).
    ``route`` is the kernel route the signature's multiplier takes (``mxu``
    is always route T); ``sms`` the card's SM count, which sets plan's
    choice and so which candidates repeat it."""
    if backend not in ("kernel", "mxu"):
        raise ValueError(f"backend {backend!r} has no launch shape to tune")
    if backend == "mxu":
        route = "T"
    default = KernelSchedule(backend=backend)
    d = plan(route, _padded(M, MAX_BLOCK), BLOCK_N, K_STEP, sms)
    shapes = [(t, None) for t in (1, 2, 4, 8) if t <= d.tile]
    if route == "C" and not quick:
        shapes += [(None, s) for s in (1, 2, 4, 8) if s != d.slots]
    steps = -(-_padded(K, MAX_BLOCK) // K_STEP)
    base = 4 if quick else 2
    ladder, v = [None], 1
    while v <= steps:
        ladder.append(_whole_steps(steps, v))
        v *= base
    out = [default]
    for tile, slots in shapes:
        for splits in dict.fromkeys(ladder):
            for go in ("mn", "nm"):
                out.append(KernelSchedule(grid_order=go, backend=backend, tile=tile,
                                          slots=slots, splits=splits))
    if not quick and op in STATIC_OPS:
        for cap in (32, 64):
            bm, bn = largest_divisor_leq(M, cap), largest_divisor_leq(N, cap)
            if (bm, bn) != (min(MAX_BLOCK, M), min(MAX_BLOCK, N)):
                out.append(KernelSchedule(bm=bm, bn=bn, backend=backend))
    seen, kept = set(), []
    for s in out:
        key = _launch_key(s, route, M, K, N, sms)
        if key not in seen:
            seen.add(key)
            kept.append(s)
    return kept


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _host_timer(f: Callable[[], object]) -> float:
    t0 = time.perf_counter()
    f()
    return (time.perf_counter() - t0) * 1e6


def sweep(fns: Sequence[Callable[[], object]], reps: int = 5, warmup: int = 1,
          timer: Optional[Callable[[Callable[[], object]], float]] = None
          ) -> Tuple[int, List[float]]:
    """Best-of-``reps`` times (us) of each zero-arg callable, measured
    INTERLEAVED round-robin so drift hits every candidate equally, each
    called ``warmup`` times first.  ``timer(f)`` runs ``f`` once and returns
    its time in us (default: the host clock around a blocking call).
    Returns ``(best_index, walls_us)``."""
    timer = timer or _host_timer
    for f in fns:
        for _ in range(warmup):
            f()
    walls = [float("inf")] * len(fns)
    for _ in range(max(1, reps)):
        for i, f in enumerate(fns):
            walls[i] = min(walls[i], timer(f))
    _TUNER_CANDIDATES.inc(len(fns))
    return min(range(len(fns)), key=lambda i: walls[i]), walls


def operands(M: int, K: int, N: int, seed: int = 0, device="cpu"):
    """Uniform int8 (M, K) and (K, N) operands from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, (M, K), dtype=np.int8)
    b = rng.integers(-128, 128, (K, N), dtype=np.int8)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def dispatch_fn(op: str, a, b, mult_name: str, sched: KernelSchedule):
    """A zero-arg production dispatch of signature op ``op`` under
    ``sched`` (``quant.ax``, the path a served projection takes), with the
    policy's default swap ``A[3] == 0``, also the triple of the grid ops: all
    four ops compute one function."""
    from repro_torch.configs.base import AxPolicy
    from repro_torch.quant import ax as qax

    backend = "kernel" if op in DEFAULT_OPS["kernel"] else "mxu"
    policy = AxPolicy(mult_name=mult_name, backend=backend)
    if op in STATIC_OPS:
        return lambda: qax.ax_matmul_int(a, b, policy, schedule=sched)
    if op not in ("matmul_grid", "int_dyn"):
        raise ValueError(f"unknown signature op {op!r}")
    dyn = torch.tensor((1, policy.swap_bit, policy.swap_value), dtype=torch.int32,
                       device=a.device)
    return lambda: qax.ax_matmul_int_dyn(a, b, policy, dyn, schedule=sched)


class _GraphTimer:
    """On the card: each candidate becomes a CUDA graph of ``reps``
    back-to-back dispatches (captured after one eager call that fills the
    device tables); the timer replays it between CUDA events and returns
    us per dispatch."""

    def __init__(self, reps: int):
        self.reps = reps
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.graphs: List[torch.cuda.CUDAGraph] = []

    def wrap(self, fn: Callable[[], object]) -> Callable[[], None]:
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(self.reps):
                fn()
        self.graphs.append(g)
        return g.replay

    def __call__(self, replay: Callable[[], None]) -> float:
        self.start.record()
        replay()
        self.end.record()
        self.end.synchronize()
        return self.start.elapsed_time(self.end) * 1e3 / self.reps


def _sms(device: torch.device) -> int:
    if device.type != "cuda":
        return 132
    return torch.cuda.get_device_properties(device).multi_processor_count


def tune_signature(M: int, K: int, N: int, backend: str, mult_name: str,
                   op: str = "matmul", quick: bool = True, reps: Optional[int] = None,
                   seed: int = 0, device="cuda", ab=None) -> Tuple[KernelSchedule, dict]:
    """The timed search over :func:`candidate_schedules` for one dispatch
    signature on ``device``.  Returns ``(winner, report)``: the report
    carries each candidate's best time (us) keyed by
    ``KernelSchedule.short()``, the winner's and the default's, and how
    they were timed.  ``ab``: the operands, when the caller has them."""
    from repro_torch.core.multipliers import get

    device = torch.device(device)
    route = "T" if backend == "mxu" else route_of(get(mult_name), torch.int8)
    cands = candidate_schedules(backend, M, K, N, op=op, quick=quick, route=route,
                                sms=_sms(device))
    a, b = ab if ab is not None else operands(M, K, N, seed, device)
    fns = [dispatch_fn(op, a, b, mult_name, s) for s in cands]
    timer, how = None, "host clock around a plain-version call"
    if device.type == "cuda":
        timer = _GraphTimer(GRAPH_REPS[M <= 16])
        fns = [timer.wrap(f) for f in fns]
        how = f"CUDA graph of {timer.reps} dispatches, CUDA events"
    t0 = time.perf_counter()
    best, walls = sweep(fns, reps=(3 if quick else 8) if reps is None else reps,
                        timer=timer)
    _TUNER_WALL.set(time.perf_counter() - t0)
    _TUNER_SIGNATURES.inc(1)
    report = {"sig": sig_key(M, K, N, backend, mult_name, op), "winner": cands[best].short(),
              "best_us": walls[best], "default_us": walls[0], "route": route,
              "timer": how, "candidates": len(cands),
              "walls_us": {s.short(): w for s, w in zip(cands, walls)}}
    return cands[best], report


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def tune_table(shapes: Sequence[Tuple[int, int, int]], mult_name: str,
               backends: Sequence[str] = ("kernel", "mxu"),
               ops_by_backend: Optional[Dict[str, Sequence[str]]] = None,
               quick: bool = True, seed: int = 0,
               device="cuda") -> Tuple[ScheduleTable, list]:
    """Tune every ``(shape, backend, op)`` signature and collect the winners
    in a :class:`ScheduleTable` (version 0: the store numbers it at
    publish).  Returns ``(table, reports)``."""
    ops_by_backend = dict(ops_by_backend or DEFAULT_OPS)
    device = torch.device(device)
    t0 = time.perf_counter()
    table = ScheduleTable()
    reports = []
    for (M, K, N) in shapes:
        ab = operands(M, K, N, seed, device)
        for backend in backends:
            for op in ops_by_backend.get(backend, ()):
                win, rep = tune_signature(M, K, N, backend, mult_name, op=op, quick=quick,
                                          seed=seed, device=device, ab=ab)
                table.set(M, K, N, backend, mult_name, win, op=op)
                reports.append(rep)
        del ab
    table.meta = {"mode": "quick" if quick else "full", "mult": mult_name,
                  "signatures": len(reports), "device": _device_name(device),
                  "tuner_wall_s": round(time.perf_counter() - t0, 3)}
    return table, reports


# ---------------------------------------------------------------------------
# fleet persistence: the PolicyStore file protocol for schedule tables
# ---------------------------------------------------------------------------

_CURRENT = "CURRENT"
_HEARTBEAT = "HEARTBEAT"
_FMT = "schedules_v{:06d}.json"
_RX = re.compile(r"^schedules_v(\d{6})\.json$")


class ScheduleStore:
    """Directory-backed versioned schedule tables, the crash-atomic
    single-writer protocol of ``fleet.PolicyStore`` (fsync'd temp+rename
    version files, an atomic CURRENT pointer, HEARTBEAT ``mtime_ns ==
    version`` so reader polls take one ``stat()``).  A publish appends a
    ``schedule_publish`` event to the store's ``audit.jsonl``.

    Layout::

        <root>/CURRENT                  # text: current version number
        <root>/HEARTBEAT                # empty; mtime_ns == version
        <root>/schedules_v000001.json   # immutable once written
        <root>/audit.jsonl
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._last_published: Optional[int] = None

    def _path(self, version: int) -> str:
        return os.path.join(self.root, _FMT.format(version))

    def versions(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_RX.match, os.listdir(self.root)) if m)

    def current_version(self) -> Optional[int]:
        try:
            with open(os.path.join(self.root, _CURRENT)) as f:
                return int(f.read().strip())
        except (FileNotFoundError, ValueError):
            vs = self.versions()
            return vs[-1] if vs else None

    # -- reader side ---------------------------------------------------
    def load(self, version: int) -> ScheduleTable:
        return ScheduleTable.load(self._path(version))

    def load_current(self) -> Optional[Tuple[int, ScheduleTable]]:
        for _ in range(2):
            v = self.current_version()
            if v is None:
                return None
            try:
                return v, self.load(v)
            except FileNotFoundError:
                continue
        return None

    def load_newest_loadable(self) -> Optional[Tuple[int, ScheduleTable]]:
        """Newest version that parses; never raises (the reader's defence
        when CURRENT is torn or the newest file is corrupt)."""
        for v in reversed(self.versions()):
            try:
                return v, self.load(v)
            except _READ_ERRS as e:
                _READ_ERRORS.inc(1, error=type(e).__name__)
        return None

    # -- writer side ---------------------------------------------------
    def _fsync_dir(self) -> None:
        try:
            fd = os.open(self.root, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def _write_atomic(self, name: str, text: str) -> None:
        path = os.path.join(self.root, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._fsync_dir()

    def _touch_heartbeat(self, version: int) -> None:
        # mtime_ns == version (not wall time): readers compare by equality
        path = os.path.join(self.root, _HEARTBEAT)
        if not os.path.exists(path):
            with open(path, "w"):
                pass
        os.utime(path, ns=(version, version))

    def heartbeat_ns(self) -> Optional[int]:
        try:
            return os.stat(os.path.join(self.root, _HEARTBEAT)).st_mtime_ns
        except FileNotFoundError:
            return None

    def publish(self, table: ScheduleTable) -> int:
        """Persist ``table`` as the next version and swing CURRENT (the
        heartbeat is touched before the pointer: a crash between the two
        degrades readers to full polls and never hides the publish).  A
        second writer raises ``RuntimeError``."""
        cur = self.current_version()
        if (self._last_published is not None and cur is not None
                and cur > self._last_published):
            raise RuntimeError(
                f"ScheduleStore single-writer violation: on-disk {cur} > "
                f"last published {self._last_published}")
        version = max([cur or 0] + self.versions()) + 1
        table.version = version
        self._write_atomic(_FMT.format(version), table.to_json())
        self._touch_heartbeat(version)
        self._write_atomic(_CURRENT, str(version))
        self._last_published = version
        _STORE_PUBLISHED.set(version)
        _STORE_PUBLISHES.inc(1)
        audit = obs.audit_for_store(self)
        if audit is not None:
            audit.append("schedule_publish", store_version=version, entries=len(table),
                         meta=dict(table.meta))
        return version

    def prune(self, keep_last: int = 8) -> List[int]:
        vs = self.versions()
        cur = self.current_version()
        drop = [v for v in vs[:-keep_last] if v != cur] if keep_last else []
        for v in drop:
            os.remove(self._path(v))
        return drop


class ScheduleReader:
    """A replica's view of a :class:`ScheduleStore`: ``poll()`` adopts a
    newer table and installs it (``schedule.install_table``: graphs
    captured before keep their launches, nothing is built).  The degraded
    ladder of ``fleet.PolicyReader``: an unchanged heartbeat costs one
    ``stat()``; a torn or corrupt file falls back to the newest loadable
    version; on total damage the replica keeps its table."""

    def __init__(self, store: ScheduleStore, name: str = "replica", install: bool = True):
        self.store = store
        self.name = name
        self.install = install
        self.version: int = -1
        self.table: Optional[ScheduleTable] = None
        self._hb_seen: Optional[int] = None
        self.poll()

    def poll(self) -> bool:
        """Adopt the current table if newer; True when it changed."""
        hb = self.store.heartbeat_ns()
        if hb is not None and hb == self._hb_seen:
            _READER_POLLS.inc(1, path="heartbeat")
            return False
        _READER_POLLS.inc(1, path="full")
        v = self.store.current_version()
        caught_up = hb is not None and v is not None and v >= hb
        if v is None or v == self.version:
            self._hb_seen = hb if caught_up else None
            return False
        got = self._load_degrading(v)
        if got is None or got[0] == self.version:
            return False
        self.version, self.table = got
        self._hb_seen = hb if caught_up else None
        if self.install:
            install_table(self.table)
        _READER_ADOPTIONS.inc(1, replica=self.name)
        return True

    def _load_degrading(self, v: Optional[int]):
        for _ in range(2):
            if v is None:
                break
            try:
                return v, self.store.load(v)
            except _READ_ERRS as e:
                _READ_ERRORS.inc(1, error=type(e).__name__)
                v = self.store.current_version()
        return self.store.load_newest_loadable()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parse_shapes(text: str) -> List[Tuple[int, int, int]]:
    out = []
    for part in text.split(","):
        m, k, n = (int(v) for v in part.lower().split("x"))
        out.append((m, k, n))
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kernels.autotune",
                                 description="Timed kernel-schedule autotuner")
    ap.add_argument("--shapes", default="128x128x128",
                    help="comma-separated MxKxN signatures to tune")
    ap.add_argument("--mult", default="mul8s_trunc0_4")
    ap.add_argument("--backends", default="kernel,mxu")
    ap.add_argument("--quick", action="store_true",
                    help="about half the candidate space, 3 reps")
    ap.add_argument("--out", default=None, help="write the tuned table JSON here")
    ap.add_argument("--store", default=None,
                    help="publish the table to this ScheduleStore directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels, timed as CUDA graphs) or cpu "
                         "(the plain versions: a dry run, its walls are not the card's)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass --device cpu)")
    backends = tuple(b for b in args.backends.split(",") if b)
    table, reports = tune_table(_parse_shapes(args.shapes), args.mult, backends=backends,
                                quick=args.quick, device=device)
    for rep in reports:
        print(f"{rep['sig']}: {rep['winner']}  "
              f"best={rep['best_us']:.1f}us default={rep['default_us']:.1f}us")
    print(f"device: {table.meta['device']}; timer: {reports[0]['timer'] if reports else '-'}")
    if args.out:
        table.save(args.out)
        print(f"wrote {args.out} ({len(table)} entries)")
    if args.store:
        v = ScheduleStore(args.store).publish(table)
        print(f"published v{v} to {args.store}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
