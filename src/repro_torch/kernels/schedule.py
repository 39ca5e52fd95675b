"""KernelSchedule: the dispatch currency of the port's kernel layer
(``repro.kernels.schedule``).

A :class:`KernelSchedule` is a frozen, hashable value naming one
approximate-matmul dispatch:

* ``backend`` — the dispatch family it tunes, with the JAX package's names
  (``kernel``, ``mxu``, ``emul``; on the card ``mxu`` is route T of the
  CUDA kernels);
* ``bm``/``bn``/``bk`` — the logical tile and K-step caps (clamped to the
  operand dims by the caller, as the JAX package does).  They set the
  grid triples' tiles and the ``tile_hist`` layout, never the CUDA block;
* ``grid_order`` — which tile axis the CUDA grid walks first ("mn":
  M-major, "nm": N-major).  It changes which blocks run together, never
  the bits;
* ``tile``/``slots``/``splits`` — the launch shape of
  ``kernels/ax_matmul.py::plan``: route T's m16 tiles per block (or route
  C's rows per thread), route C's row slots, and the blocks that share
  each output tile's K.  ``None`` is plan's choice.  They are run-time
  ints of one build, so a schedule never runs ``nvcc``.

:class:`ScheduleTable` maps dispatch signatures (:func:`sig_key`: the
logical shape before padding, backend, multiplier, op) to schedules, with
the JAX package's JSON layout; ``from_dict`` drops keys it does not know,
so a table written by either package loads in the other (JAX's
``k_slab``/``limbs``/``noswap_fast`` have no counterpart here and are
dropped; the JAX package drops ``tile``/``slots``/``splits``).  Every
dispatch site resolves through :func:`resolve`: explicit schedule >
installed table entry > defaults.  Resolution runs on the host at dispatch,
so a CUDA graph captured before an install keeps its launch shapes, and
graphs captured after it use the table (``kernels/autotune.py`` sweeps and
publishes tables).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, Optional, Tuple

from repro_torch import obs

__all__ = ["KernelSchedule", "ScheduleTable", "sig_key", "default_schedule",
           "from_legacy_kwargs", "install_table", "installed_table", "clear_table",
           "resolve", "resolve_for", "GRID_ORDERS", "BACKENDS", "MAX_BLOCK"]

GRID_ORDERS = ("mn", "nm")
BACKENDS = ("kernel", "mxu", "emul")
MAX_BLOCK = 128

_REG = obs.default_registry()
_LOOKUPS = _REG.counter(
    "repro_sched_lookups_total",
    "KernelSchedule resolutions by result (hit = installed-table entry, "
    "miss = zero-recompile default fallback, explicit = caller-supplied)")
_TABLE_ENTRIES = _REG.gauge(
    "repro_sched_table_entries",
    "entries in the process-installed schedule table (0 = defaults only)")


def _pow2_le8(v) -> bool:
    return v in (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class KernelSchedule:
    """One approximate-matmul dispatch configuration (module note).  Bad
    values raise ``ValueError``: caps in 1..128, ``tile`` and ``slots``
    powers of two up to 8, ``splits`` at least 1 (``plan`` checks it
    against the K steps).  The fields come in the port's earlier
    positional order (caps, grid order) and then the JAX package's
    ``backend``; files carry names, so the order is no part of the
    format."""

    bm: int = 128
    bn: int = 128
    bk: int = 128
    grid_order: str = "mn"
    backend: str = "kernel"
    tile: Optional[int] = None
    slots: Optional[int] = None
    splits: Optional[int] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}: {self}")
        for v in (self.bm, self.bn, self.bk):
            if not 0 < v <= MAX_BLOCK:
                raise ValueError(f"block caps must lie in 1..{MAX_BLOCK}: {self}")
        if self.grid_order not in GRID_ORDERS:
            raise ValueError(f"grid_order must be one of {GRID_ORDERS}: {self}")
        for name in ("tile", "slots"):
            v = getattr(self, name)
            if v is not None and not _pow2_le8(v):
                raise ValueError(f"{name} must be 1, 2, 4 or 8 (None: plan's choice): {self}")
        if self.splits is not None and self.splits < 1:
            raise ValueError(f"splits must be at least 1 (None: plan's choice): {self}")

    def knobs(self) -> dict:
        """The launch overrides of ``plan`` (``tile``, ``slots``, ``splits``)."""
        return {"tile": self.tile, "slots": self.slots, "splits": self.splits}

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelSchedule":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def short(self) -> str:
        """Compact label for tables and logs: ``t`` tile, ``s`` slots, ``k``
        splits of K; ``*`` is plan's choice."""
        knob = "/".join(f"{tag}{'*' if v is None else v}"
                        for tag, v in zip("tsk", (self.tile, self.slots, self.splits)))
        return f"{self.backend}:{self.bm}x{self.bn}x{self.bk}/{self.grid_order}/{knob}"


def default_schedule(backend: str = "kernel") -> KernelSchedule:
    """128-cap tiles, M-major grid, plan's launch shape: what every dispatch
    did before the table, so a missing entry changes nothing."""
    return KernelSchedule(backend=backend)


def from_legacy_kwargs(backend: str, block_m: Optional[int], block_n: Optional[int],
                       block_k: Optional[int], k_slab: Optional[int]) -> KernelSchedule:
    """Map the deprecated ``block_*`` keywords onto a schedule (missing ones
    take 128).  ``k_slab`` has no counterpart on the card and is dropped."""
    del k_slab
    return KernelSchedule(
        backend=backend,
        bm=128 if block_m is None else int(block_m),
        bn=128 if block_n is None else int(block_n),
        bk=128 if block_k is None else int(block_k))


# ---------------------------------------------------------------------------
# signature keys + table
# ---------------------------------------------------------------------------

def sig_key(M: int, K: int, N: int, backend: str, mult_name: str,
            op: str = "matmul") -> str:
    """Dispatch-signature key, the JAX package's string: the logical
    (pre-padding) shape, backend, multiplier and op ("matmul" static,
    "matmul_grid" the grid kernel, "int_static"/"int_dyn" the quant
    layer's ``mxu`` forms)."""
    return f"{int(M)}x{int(K)}x{int(N)}/{backend}/{mult_name}/{op}"


class ScheduleTable:
    """A versioned ``sig_key -> KernelSchedule`` mapping, the autotuner's
    artifact.  ``meta`` carries provenance (the card, the sweep, walls) and
    takes no part in equality."""

    def __init__(self, entries: Optional[Dict[str, KernelSchedule]] = None,
                 version: int = 0, meta: Optional[dict] = None):
        self.entries: Dict[str, KernelSchedule] = dict(entries or {})
        self.version = int(version)
        self.meta = dict(meta or {})

    def set(self, M: int, K: int, N: int, backend: str, mult_name: str,
            schedule: KernelSchedule, op: str = "matmul") -> None:
        self.entries[sig_key(M, K, N, backend, mult_name, op)] = schedule

    def lookup(self, M: int, K: int, N: int, backend: str, mult_name: str,
               op: str = "matmul") -> Optional[KernelSchedule]:
        return self.entries.get(sig_key(M, K, N, backend, mult_name, op))

    def __len__(self) -> int:
        return len(self.entries)

    def __eq__(self, other) -> bool:
        return (isinstance(other, ScheduleTable) and self.entries == other.entries
                and self.version == other.version)

    def to_dict(self) -> dict:
        return {"kind": "schedule_table", "version": self.version, "meta": self.meta,
                "entries": {k: s.to_dict() for k, s in sorted(self.entries.items())}}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_dict(cls, d: dict) -> "ScheduleTable":
        if d.get("kind") != "schedule_table":
            raise ValueError(f"not a schedule table: kind {d.get('kind')!r}")
        return cls(entries={k: KernelSchedule.from_dict(v)
                            for k, v in d.get("entries", {}).items()},
                   version=int(d.get("version", 0)), meta=d.get("meta", {}))

    @classmethod
    def from_json(cls, text: str) -> "ScheduleTable":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> str:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as fh:
            fh.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "ScheduleTable":
        with open(path) as fh:
            return cls.from_json(fh.read())


# ---------------------------------------------------------------------------
# process-installed table + resolution
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_ACTIVE: Optional[ScheduleTable] = None


def install_table(table: Optional[ScheduleTable]) -> Optional[ScheduleTable]:
    """Install ``table`` as the schedule source of every dispatch site in
    the process (None uninstalls); returns the table it replaces.  It
    re-captures no CUDA graph and builds nothing: a captured graph keeps
    the launches it recorded, and dispatches after the install resolve
    through the table."""
    global _ACTIVE
    with _LOCK:
        prev, _ACTIVE = _ACTIVE, table
    _TABLE_ENTRIES.set(0 if table is None else len(table))
    return prev


def installed_table() -> Optional[ScheduleTable]:
    return _ACTIVE


def clear_table() -> None:
    install_table(None)


def resolve(M: int, K: int, N: int, backend: str, mult_name: str, op: str = "matmul",
            override: Optional[KernelSchedule] = None) -> KernelSchedule:
    """The one resolution order of every dispatch site: explicit schedule >
    installed table entry > the backend's defaults."""
    if override is not None:
        _LOOKUPS.inc(1, result="explicit")
        return override
    table = _ACTIVE
    if table is not None:
        hit = table.lookup(M, K, N, backend, mult_name, op)
        if hit is not None:
            _LOOKUPS.inc(1, result="hit")
            return hit
    _LOOKUPS.inc(1, result="miss")
    return default_schedule(backend)


def resolve_for(a_shape: Tuple[int, ...], b_shape: Tuple[int, ...], backend: str,
                mult_name: str, op: str = "matmul",
                override: Optional[KernelSchedule] = None) -> KernelSchedule:
    """:func:`resolve` from operand shapes ``(..., K) @ (K, N)``, the
    leading dims flattened into the logical M."""
    m = 1
    for d in a_shape[:-1]:
        m *= int(d)
    return resolve(m, int(a_shape[-1]), int(b_shape[-1]), backend, mult_name, op,
                   override=override)
