"""Versioned SWAPPER policy store (``repro.fleet.store``): the fleet's
single source of policy truth, with the JAX package's on-disk protocol, so
either package reads the other's stores.

A :class:`PolicyStore` persists :class:`~repro_torch.runtime.policy.SwapPolicy`
JSON under monotonically increasing versions with a **single-writer /
many-reader** protocol:

* the writer (the fleet's :class:`~repro_torch.runtime.AdaptiveController`)
  publishes each re-tuned policy as ``policy_v{N:06d}.json`` followed by an
  atomic ``CURRENT`` pointer swap — a reader never sees a torn write, and a
  crash mid-publish leaves the previous version current;
* readers (:class:`PolicyReader`, serve replicas) poll ``CURRENT`` through a
  ``HEARTBEAT`` fast path and reload only when the version advanced, so
  steady-state polling is one ``stat()``, and adopting a new policy changes
  int32 values only: on the card they are copied into a captured decode
  graph's buffers, and nothing is re-captured.

The guarded rollout adds ``.cand`` candidates (invisible to readers),
``promote``, ``.rejected`` and ``rollback``.  Published policies carry the
whole granularity hierarchy (global / per-target / per-layer configs and
per-row-tile ``tile_grids``) in one JSON document.
"""
from __future__ import annotations

import os
import re
import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.runtime.policy import SwapPolicy

from . import chaos

__all__ = ["PolicyStore", "PolicyReader"]

_CURRENT = "CURRENT"
_HEARTBEAT = "HEARTBEAT"
_FMT = "policy_v{:06d}.json"
_RX = re.compile(r"^policy_v(\d{6})\.json$")
_CAND_SUFFIX = ".cand"
_RX_CAND = re.compile(r"^policy_v(\d{6})\.json\.cand$")
_RX_DEAD = re.compile(r"^policy_v(\d{6})\.json\.cand\.rejected$")

# reader-side load failures a replica must degrade through, never crash on:
# pruned/missing files, torn JSON, schema-mangled documents
_READ_ERRS = (OSError, ValueError, KeyError, TypeError)

# host-side observability (obs).  The published-version gauge plus the
# per-replica staleness gauge together disambiguate the two zero-lag cases:
# published == 0 means nothing was ever published (staleness 0 is vacuous);
# published > 0 with staleness k > 0 means that replica is k versions behind.
_REG = obs.default_registry()
_PUBLISHED = _REG.gauge(
    "repro_policy_store_published",
    "current PolicyStore version (0 = nothing published yet)")
_PUBLISHES = _REG.counter(
    "repro_policy_publishes_total", "policies published by this process")
_STALENESS = _REG.gauge(
    "repro_replica_staleness",
    "store versions this replica's adopted policy is behind CURRENT")
_ADOPTIONS = _REG.counter(
    "repro_policy_adoptions_total",
    "newer store policies adopted by this replica's poll()")
_POLL_FAST = _REG.counter(
    "repro_policy_poll_total",
    "PolicyReader.poll calls by path (heartbeat fast-path vs full read)")
_READ_ERRORS = _REG.counter(
    "repro_store_read_errors",
    "reader-side policy load failures degraded through (pruned/corrupt "
    "CURRENT or policy JSON), by exception type")
_ROLLBACKS_STORE = _REG.counter(
    "repro_store_rollbacks_total",
    "CURRENT re-points to an older (last-good) version")
_RECOVERED_TMP = _REG.counter(
    "repro_store_recovered_tmp_total",
    "orphaned publish temp files swept at store open (crash mid-publish)")


class PolicyStore:
    """Directory-backed versioned policy storage (see module docstring).

    Layout::

        <root>/CURRENT              # text file: current version number
        <root>/policy_v000001.json  # immutable once written
        <root>/policy_v000002.json
    """

    def __init__(self, root: str, recover_stale_s: float = 60.0):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._last_published: Optional[int] = None
        self._recover(recover_stale_s)

    def _recover(self, stale_s: float) -> None:
        """Crash-recovery sweep at open: remove ``*.tmp`` orphans left by a
        writer killed between temp write and rename.  Only *stale* orphans
        (older than ``stale_s``) are swept — a fresh tmp may belong to a
        publish in flight in another process, and removing it would turn a
        reader's open into a writer crash."""
        now = time.time()
        for fn in os.listdir(self.root):
            if not fn.endswith(".tmp"):
                continue
            path = os.path.join(self.root, fn)
            try:
                if now - os.stat(path).st_mtime >= stale_s:
                    os.remove(path)
                    _RECOVERED_TMP.inc(1)
            except OSError:
                continue                     # raced with another sweeper

    # -- paths ---------------------------------------------------------
    def _path(self, version: int) -> str:
        return os.path.join(self.root, _FMT.format(version))

    def _cand_path(self, version: int) -> str:
        return self._path(version) + _CAND_SUFFIX

    def versions(self) -> List[int]:
        out = []
        for fn in os.listdir(self.root):
            m = _RX.match(fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _all_allocated(self) -> List[int]:
        """Every version number with a file on disk — promoted AND pending
        candidates — so allocation never reuses (and overwrites) a number
        after a rollback or a rejected candidate."""
        out = set(self.versions())
        for fn in os.listdir(self.root):
            m = _RX_CAND.match(fn) or _RX_DEAD.match(fn)
            if m:
                out.add(int(m.group(1)))
        return sorted(out)

    # -- reader side ---------------------------------------------------
    def current_version(self) -> Optional[int]:
        """The published version per the ``CURRENT`` pointer (falls back to
        the newest on-disk version if the pointer is missing)."""
        try:
            with open(os.path.join(self.root, _CURRENT)) as f:
                return int(f.read().strip())
        except (FileNotFoundError, ValueError):
            vs = self.versions()
            return vs[-1] if vs else None

    def load(self, version: int) -> SwapPolicy:
        return SwapPolicy.load(self._path(version))

    def load_current(self) -> Optional[Tuple[int, SwapPolicy]]:
        """(version, policy) of the current pointer, or None when empty.
        Retries once if the pointed-at file was pruned mid-read."""
        for _ in range(2):
            v = self.current_version()
            if v is None:
                return None
            try:
                return v, self.load(v)
            except FileNotFoundError:
                continue
        return None

    def load_newest_loadable(self) -> Optional[Tuple[int, SwapPolicy]]:
        """(version, policy) of the newest version that actually parses —
        the reader's last line of defense when CURRENT is torn/pruned and
        the newest file is corrupt.  Never raises; None for an empty (or
        fully corrupt) store."""
        for v in reversed(self.versions()):
            try:
                return v, self.load(v)
            except _READ_ERRS as e:
                _READ_ERRORS.inc(1, error=type(e).__name__)
                continue
        return None

    # -- writer side ---------------------------------------------------
    def _fsync_dir(self) -> None:
        """fsync the store directory so a just-committed rename survives a
        host crash, not only a process kill."""
        try:
            fd = os.open(self.root, os.O_RDONLY)
        except OSError:
            return                            # platform without dir-fsync
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def _write_atomic(self, name: str, text: str) -> None:
        """fsync'd temp + rename: a reader sees the old bytes or the new
        bytes, never a torn file, and a committed write survives power loss."""
        path = os.path.join(self.root, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._fsync_dir()

    def _check_single_writer(self, cur: Optional[int]) -> None:
        if (self._last_published is not None and cur is not None
                and cur > self._last_published):
            raise RuntimeError(
                f"PolicyStore single-writer violation: on-disk version {cur} "
                f"> last published {self._last_published} (second writer?)")

    def _next_version(self) -> int:
        """Next unused version number.  ``max(allocated) + 1`` rather than
        ``CURRENT + 1``: after a rollback CURRENT points *behind* existing
        immutable files, and candidate files also hold numbers — neither may
        ever be overwritten."""
        allocated = self._all_allocated()
        cur = self.current_version() or 0
        return max(allocated[-1] if allocated else 0, cur) + 1

    def publish(self, policy: SwapPolicy) -> int:
        """Persist ``policy`` as the next version and swing ``CURRENT``.

        Crash-atomic: the version file and the CURRENT pointer are both
        fsync'd temp+rename writes, so a kill at ANY point leaves either the
        previous version current (version file may exist uncommitted — the
        next publish allocates past it) or the new version fully committed.
        Chaos site ``store.publish`` injects exactly those kills.

        Single-writer: raises if another writer advanced the store past this
        instance's last publish (split-brain guard — a fleet has exactly one
        re-tuning controller).  The policy's own ``version`` is rewritten to
        the store version so readers compare a single counter.
        """
        faults = {f.kind for f in chaos.fire("store.publish")}
        cur = self.current_version()
        self._check_single_writer(cur)
        version = self._next_version()
        policy.version = version
        path = self._path(version)
        if "kill_mid_write" in faults:
            body = policy.to_json()
            with open(path + ".tmp", "w") as f:
                f.write(body[: len(body) // 2])   # torn temp, never renamed
            raise chaos.InjectedFault("store.publish: killed mid temp write")
        self._write_atomic(_FMT.format(version), policy.to_json())
        # heartbeat BEFORE the CURRENT swap: a crash between the two leaves
        # hb > CURRENT, which readers treat as "never cache, take the full
        # path" — degraded to pre-heartbeat polling, never a missed publish
        # (the reverse order could hide a committed version from fast-path
        # readers forever)
        self._touch_heartbeat(version)
        if "kill_before_current" in faults:
            raise chaos.InjectedFault(
                "store.publish: killed between heartbeat and CURRENT swap")
        if "torn_current" in faults:
            # tear the pointer the non-atomic way a buggy writer would (the
            # production path above never does this): garbage bytes, then die
            with open(os.path.join(self.root, _CURRENT), "w") as f:
                f.write("torn\x00")
            raise chaos.InjectedFault("store.publish: CURRENT torn mid-swap")
        self._write_atomic(_CURRENT, str(version))
        self._last_published = version
        _PUBLISHED.set(version)
        _PUBLISHES.inc(1)
        for f in chaos.fire("store.after_publish", version=version):
            if f.kind == "corrupt_policy":
                with open(path, "w") as fh:
                    fh.write('{"mult_name": "mu')   # truncated JSON
        return version

    # -- candidate / promote / rollback (guarded rollout) --------------
    def publish_candidate(self, policy: SwapPolicy) -> int:
        """Persist ``policy`` as ``policy_v{N}.json.cand`` WITHOUT touching
        CURRENT or the heartbeat: readers never adopt a candidate (the
        ``.cand`` suffix keeps it out of :meth:`versions`), but the retune
        attempt is durably recorded before the canary runs.  Returns the
        reserved version number."""
        version = self._next_version()
        policy.version = version
        self._write_atomic(_FMT.format(version) + _CAND_SUFFIX,
                           policy.to_json())
        return version

    def candidate_version(self) -> Optional[int]:
        """Newest pending candidate version (None when none pending)."""
        out = [int(m.group(1)) for fn in os.listdir(self.root)
               if (m := _RX_CAND.match(fn))]
        return max(out) if out else None

    def promote(self, version: int) -> int:
        """Graduate a candidate to a full version: rename ``.cand`` into the
        immutable version file, then heartbeat + CURRENT swap exactly like
        :meth:`publish` (same crash window semantics)."""
        cand = self._cand_path(version)
        cur = self.current_version()
        self._check_single_writer(cur)
        if os.path.exists(cand):
            os.replace(cand, self._path(version))
            self._fsync_dir()
        elif not os.path.exists(self._path(version)):
            raise FileNotFoundError(f"no candidate or version {version}")
        self._touch_heartbeat(version)
        self._write_atomic(_CURRENT, str(version))
        self._last_published = version
        _PUBLISHED.set(version)
        _PUBLISHES.inc(1)
        return version

    def reject_candidate(self, version: int) -> None:
        """Drop a canary-rejected candidate.  The file is renamed (not
        removed) to ``.cand.rejected`` so its number stays allocated — the
        audit trail references it and :meth:`_next_version` must never hand
        the same number to a different policy — but it can no longer be
        promoted or adopted."""
        try:
            os.replace(self._cand_path(version),
                       self._cand_path(version) + ".rejected")
        except FileNotFoundError:
            pass

    def rollback(self, version: int) -> int:
        """Re-point CURRENT at an existing (last-good) version.  The
        heartbeat is touched with the rollback target, which is safe because
        readers compare heartbeats by *equality*, not order — a reader whose
        cached heartbeat doesn't match takes the full path and adopts the
        rolled-back version like any other publish."""
        if not os.path.exists(self._path(version)):
            raise FileNotFoundError(f"rollback target v{version} not on disk")
        self._touch_heartbeat(version)
        self._write_atomic(_CURRENT, str(version))
        # keep the single-writer guard watermark at the HIGHEST version this
        # writer ever committed: after rollback CURRENT < watermark is
        # expected, and only a *third-party* advance past the watermark
        # still trips the guard
        self._last_published = max(self._last_published or 0, version)
        _PUBLISHED.set(version)
        _ROLLBACKS_STORE.inc(1)
        return version

    def _touch_heartbeat(self, version: int) -> None:
        """Touch ``HEARTBEAT`` with ``mtime_ns == version``: readers
        fast-path their poll on one ``stat()`` of this file.  Setting the
        mtime to the version (instead of wall time) makes the signal immune
        to filesystem mtime granularity — two publishes inside one clock
        quantum still produce two distinct heartbeat values.  Readers
        compare heartbeats by EQUALITY (``hb == last seen``), never order:
        a :meth:`rollback` legitimately moves the value backwards."""
        path = os.path.join(self.root, _HEARTBEAT)
        if not os.path.exists(path):
            with open(path, "w"):
                pass
        os.utime(path, ns=(version, version))

    def heartbeat_ns(self) -> Optional[int]:
        """``HEARTBEAT`` mtime_ns (== last published version), or None when
        the store predates heartbeats / has never published."""
        try:
            return os.stat(os.path.join(self.root, _HEARTBEAT)).st_mtime_ns
        except FileNotFoundError:
            return None

    def prune(self, keep_last: int = 8) -> List[int]:
        """Drop all but the newest ``keep_last`` versions (never the current
        one).  Returns the versions removed."""
        vs = self.versions()
        cur = self.current_version()
        drop = [v for v in vs[:-keep_last] if v != cur] if keep_last else []
        for v in drop:
            os.remove(self._path(v))
        return drop


class PolicyReader:
    """A serve replica's view of the store: polls ``CURRENT``, adopts newer
    policies, and exposes the same ``dyn_tree()`` / ``observe()`` /
    ``tile_rows`` surface the engine expects from an adaptive controller —
    so a replica runs the same decode program as the re-tuning host
    (including per-row-tile config grids when ``tile_rows > 0``).  On the
    card that program is a captured CUDA graph, and an adopted policy
    reaches it as values copied into its buffers: no re-capture.  Records
    are discarded (the writer owns the fleet aggregate).

    ``device`` — where :meth:`dyn_tree`'s int32 tensors live: the card
    unless the caller asks for the CPU.

    :meth:`staleness` is the replica's lag metric — how many store versions
    CURRENT has advanced past the one this replica serves.  It reads only
    the (small) CURRENT pointer, so fleet monitors can sample it cheaply
    without forcing an adoption."""

    def __init__(self, store: PolicyStore, targets: Sequence[str],
                 tile_rows: int = 0, name: str = "replica",
                 retries: int = 3, backoff_s: float = 0.005,
                 backoff_cap_s: float = 0.1, device="cuda"):
        self.store = store
        self.targets = tuple(targets)
        self.tile_rows = int(tile_rows)
        self.name = name
        self.device = torch.device(device)
        self.version: int = -1
        self.policy: Optional[SwapPolicy] = None
        self._dyn_cache = None
        self._hb_seen: Optional[int] = None    # heartbeat ns at last full poll
        self.retries = int(retries)            # capped-backoff load attempts
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.read_errors = 0                   # degraded loads this replica saw
        self.poll()

    def poll(self) -> bool:
        """Adopt the store's current policy if newer; True when it changed.

        Fast path: the writer touches ``HEARTBEAT`` with ``mtime_ns ==
        version`` on every publish, so an unchanged heartbeat proves no
        publish happened since the last full poll and the whole check is one
        ``stat()`` — no ``CURRENT`` read, no JSON load.  Stores without a
        heartbeat (pre-heartbeat layouts, manual edits) always take the full
        path.

        Never crashes the replica on store damage: a load hitting a pruned,
        torn or corrupt file retries with capped exponential backoff
        (re-reading CURRENT each attempt — the writer may repair it between
        retries), then falls back to the newest *loadable* version, and as a
        last resort keeps serving the already-adopted policy.  Every
        degraded load increments ``repro_store_read_errors``."""
        for f in chaos.fire("reader.poll", replica=self.name):
            if f.kind == "delay_poll":
                time.sleep(0.02 if f.arg is None else float(f.arg))
            elif f.kind == "crash_replica":
                raise chaos.InjectedFault(
                    f"reader.poll: replica {self.name} killed")
        hb = self.store.heartbeat_ns()
        if hb is not None and hb == self._hb_seen:
            _POLL_FAST.inc(1, path="heartbeat")
            self._set_staleness(0 if self.version == hb else None)
            return False
        _POLL_FAST.inc(1, path="full")
        v = self.store.current_version()
        # cache the heartbeat only once CURRENT caught up to it: hb >
        # CURRENT happens in the instant (or crash window) between the
        # writer's heartbeat touch and pointer swap, and caching there
        # would fast-path right past the commit
        caught_up = hb is not None and v is not None and v >= hb
        if v is None or v == self.version:
            self._hb_seen = hb if caught_up else None
            self._set_staleness(None)
            return False
        got = self._load_degrading(v)
        if got is None or got[0] == self.version:
            self._set_staleness(None)
            return False
        self.version, self.policy = got
        self._dyn_cache = None
        self._hb_seen = hb if caught_up else None
        _ADOPTIONS.inc(1, replica=self.name)
        self._set_staleness(None)
        return True

    def pin(self, version: int) -> None:
        """Serve exactly ``version``: the ranks of a mesh-sharded batcher
        agree on one version after each poll (``fleet/scheduler.py``)."""
        if version == self.version:
            return
        self.policy = self.store.load(version)
        self.version = version
        self._dyn_cache = None
        self._set_staleness(None)

    def _load_degrading(self, v: Optional[int]):
        """Load version ``v`` with retries + backoff, then fall back to the
        newest loadable version.  Returns (version, policy) or None; never
        raises (the replica keeps serving what it has)."""
        for attempt in range(max(self.retries, 1)):
            if v is None:
                break
            try:
                return v, self.store.load(v)
            except _READ_ERRS as e:
                self.read_errors += 1
                _READ_ERRORS.inc(1, error=type(e).__name__)
                obs.instant("store_read_error", cat="store",
                            replica=self.name, version=v,
                            error=type(e).__name__, attempt=attempt)
                if attempt + 1 < max(self.retries, 1):
                    time.sleep(min(self.backoff_s * (2 ** attempt),
                                   self.backoff_cap_s))
                v = self.store.current_version()   # writer may have repaired
        return self.store.load_newest_loadable()

    def _set_staleness(self, known: Optional[int]) -> None:
        _STALENESS.set(self.staleness() if known is None else known,
                       replica=self.name)

    def staleness(self) -> int:
        """Store versions this replica is behind ``CURRENT`` (0 = serving
        the newest policy; one cheap pointer read, adopts nothing).  A
        replica that has never adopted anything (spun up against an empty
        store) counts as behind *every* published version — maximal lag,
        not zero."""
        v = self.store.current_version()
        if v is None:
            return 0
        return max(0, v - max(self.version, 0))

    # -- engine-facing surface (duck-typed AdaptiveController subset) --
    def dyn_tree(self):
        if self.policy is None:
            raise RuntimeError("PolicyReader: store is empty (no published policy)")
        if self._dyn_cache is None:
            self._dyn_cache = self.policy.dyn_tree(self.targets, self.tile_rows,
                                                   device=self.device)
        return self._dyn_cache

    def observe(self, records) -> list:
        """Replicas do not own the fleet aggregate: records are dropped."""
        return []
