"""Retune audit trail (``repro.obs.audit``): an append-only structured
event log next to the PolicyStore, in the JAX package's format.

Every policy mutation the :class:`~repro_torch.runtime.AdaptiveController`
makes appends one JSON line — trigger target, drift score, winning triple (or
tile-grid digest), predicted gain, and the store version the change was
published as — so "why did this replica retune?" is answerable after the
fact and the policy history is **replayable**: walking ``read()`` in order
reproduces the exact sequence of ``policy_v{N}.json`` versions the fleet
served (each event's ``store_version`` points at the immutable JSON the
store kept).

The log is plain JSONL with O_APPEND single-writer semantics — the same
single-writer guarantee the PolicyStore already enforces covers it, and a
crash mid-write loses at most the final partial line (``read`` skips it,
and the next writer resumes ``seq`` from the last *complete* event).
Appends fsync before returning, so an acknowledged event survives a
process kill (the same durability contract ``PolicyStore.publish`` makes).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import List, Optional

__all__ = ["AUDIT_FILENAME", "AuditLog", "audit_for_store", "grid_digest"]

AUDIT_FILENAME = "audit.jsonl"


def grid_digest(grid) -> str:
    """Short stable digest of a tile grid (or any int array): the audit
    event stays one line while still identifying the exact published grid."""
    import numpy as np

    arr = np.ascontiguousarray(np.asarray(grid, np.int32))
    return hashlib.sha256(arr.tobytes() + str(arr.shape).encode()).hexdigest()[:12]


class AuditLog:
    """Append-only JSONL event log (see module docstring)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._seq = self._last_seq() + 1

    def _last_seq(self) -> int:
        last = -1
        for ev in self.read():
            last = max(last, int(ev.get("seq", -1)))
        return last

    def append(self, kind: str, **fields) -> dict:
        """Append one event; returns the record written (with its assigned
        monotonic ``seq`` and wall-clock ``unix_time``)."""
        ev = dict(seq=self._seq, kind=kind, unix_time=time.time(), **fields)
        self._seq += 1
        line = json.dumps(ev, sort_keys=True, default=_jsonable)
        with open(self.path, "a") as f:
            # a crash mid-append can leave a torn line with no terminator;
            # start clean so the new event is not glued onto the wreckage
            if f.tell() and not self._ends_with_newline():
                f.write("\n")
            f.write(line)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        return ev

    def _ends_with_newline(self) -> bool:
        with open(self.path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            return f.read(1) == b"\n"

    def read(self) -> List[dict]:
        """Every complete event in append order (a torn final line from a
        crash mid-append is skipped)."""
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue               # torn tail write
        return out

    def __len__(self) -> int:
        return len(self.read())


def _jsonable(v):
    import numpy as np

    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return repr(v)


def audit_for_store(store) -> Optional["AuditLog"]:
    """The audit log that lives next to a ``fleet.PolicyStore`` (``None``
    for a store-less controller unless one is passed explicitly)."""
    root = getattr(store, "root", None)
    if root is None:
        return None
    return AuditLog(os.path.join(root, AUDIT_FILENAME))
