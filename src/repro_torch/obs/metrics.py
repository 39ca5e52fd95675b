"""Metrics registry (``repro.obs.metrics``): counters, gauges and
histograms with label sets.

The substrate every subsystem of the port reports into: the serving engine
counts graph captures and dispatch walls, the drift detector exports
per-target drift scores, the controller its re-tunes, canaries and
rollbacks, and the policy store its published version and each replica's
lag.  Everything here is host-side only (a metric update is a dict write
under a lock, never a device operation), so instrumenting a path cannot
change tokens, telemetry or a captured CUDA graph.

Design (prometheus-client-shaped, stdlib-only):

* a :class:`MetricsRegistry` owns named metrics; :func:`default_registry`
  is the process-wide instance.  Metric creation is get-or-create (two
  modules may declare the same metric), but re-declaring with a different
  type or help string raises.
* every metric holds a family of **series** keyed by its label set
  (``counter.inc(1, mode="wave")``); label order never matters.
* :class:`Histogram` uses explicit cumulative ``le`` bucket edges (values
  land in every bucket whose edge is >= the value, Prometheus semantics)
  plus ``sum``/``count``, and exposes :meth:`Histogram.percentile`.

Exposition lives in :mod:`repro_torch.obs.export`.
"""
from __future__ import annotations

import bisect
import threading
import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LATENCY_BUCKETS",
    "TTFT_BUCKETS",
    "E2E_BUCKETS",
    "DISPATCH_BUCKETS",
    "QOR_MAE_BUCKETS",
    "bucket_percentile",
    "default_registry",
    "reset_default_registry",
]

# default Histogram edges: serving latencies from 50us (a cached token step)
# to 2 minutes (a cold-compile wave), roughly log-spaced
LATENCY_BUCKETS = (
    0.00005, 0.0002, 0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 120.0,
)

# Serving-latency bucket families, the JAX package's edges unchanged (a
# shared dashboard reads both packages' series): they cluster resolution
# between a few-ms token step and a cold start of several seconds, and
# top out near twice the slowest serving wall the JAX package recorded.
# The +Inf-coverage check below flags a family that no longer covers the
# live distribution.
TTFT_BUCKETS = (
    0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.0, 3.0, 4.5, 6.0, 8.0, 12.0, 18.0,
)
E2E_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.0, 3.0, 4.5, 6.0, 8.0, 10.0, 13.0, 18.0, 27.0,
)
# dispatch walls (prefill / decode loop / one token step): ~0.2 ms cached
# steps up to the multi-second cold-compile first dispatch
DISPATCH_BUCKETS = (
    0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.02, 0.04,
    0.08, 0.15, 0.3, 0.6, 1.2, 2.5, 5.0, 10.0,
)
# per-request QoR attribution: mean absolute error of an 8-bit approximate
# multiplier in product units — geometric edges spanning near-exact (<1)
# through the worst trunc-family configs (~10^5)
QOR_MAE_BUCKETS = (
    1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0,
    16384.0, 65536.0, 262144.0,
)

_INF = float("inf")

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    """Canonical (sorted) label tuple — label order never matters."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared label-series bookkeeping for the three metric types."""

    kind = "untyped"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, object] = {}
        self._lock = threading.Lock()

    def _zero(self):
        raise NotImplementedError

    def _get(self, labels: Dict[str, str]):
        key = _label_key(labels)
        with self._lock:
            if key not in self._series:
                self._series[key] = self._zero()
            return key

    def series(self) -> Dict[LabelKey, object]:
        """Snapshot of {label-key: value} for every series."""
        with self._lock:
            return dict(self._series)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    """Monotonically increasing count (e.g. retraces, splices, retunes)."""

    kind = "counter"

    def _zero(self):
        return 0.0

    def inc(self, amount: float = 1.0, **labels) -> None:
        assert amount >= 0, f"counter {self.name}: negative inc {amount}"
        key = self._get(labels)
        with self._lock:
            self._series[key] += amount

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))

    def total(self) -> float:
        """Sum over every label set (the process-wide count)."""
        with self._lock:
            return float(sum(self._series.values()))


class Gauge(_Metric):
    """Point-in-time value (occupancy, queue depth, drift score, lag)."""

    kind = "gauge"

    def _zero(self):
        return 0.0

    def set(self, value: float, **labels) -> None:
        key = self._get(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._get(labels)
        with self._lock:
            self._series[key] += amount

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # trailing +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Cumulative-bucket histogram with explicit ``le`` edges.

    ``observe(v)`` increments the first bucket whose edge satisfies
    ``v <= le`` plus every bucket after it at exposition time (Prometheus
    cumulative semantics; internally counts are per-bucket and cumulated on
    read, so ``observe`` stays O(log buckets))."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, help)
        edges = tuple(sorted(float(b) for b in buckets))
        assert edges and all(
            b < a for b, a in zip(edges, edges[1:]) or [(0, 1)]
        ) or len(set(edges)) == len(edges), f"duplicate bucket edges {edges}"
        self.buckets = edges

    def _zero(self):
        return _HistSeries(len(self.buckets))

    def observe(self, value: float, **labels) -> None:
        key = self._get(labels)
        idx = bisect.bisect_left(self.buckets, float(value))
        with self._lock:
            s: _HistSeries = self._series[key]
            s.counts[idx] += 1          # idx == len(buckets) -> +Inf bucket
            s.sum += float(value)
            s.count += 1

    def cumulative(self, **labels) -> List[Tuple[float, int]]:
        """[(le_edge, cumulative_count), ..., (inf, total)] for one series."""
        s = self._series.get(_label_key(labels))
        if s is None:
            return [(b, 0) for b in self.buckets] + [(_INF, 0)]
        out, acc = [], 0
        for edge, c in zip(list(self.buckets) + [_INF], s.counts):
            acc += c
            out.append((edge, acc))
        return out

    def snapshot(self, **labels) -> dict:
        s = self._series.get(_label_key(labels))
        if s is None:
            return dict(sum=0.0, count=0,
                        buckets=self.cumulative(**labels))
        return dict(sum=s.sum, count=s.count, buckets=self.cumulative(**labels))

    def percentile(self, q: float, interpolate: bool = False,
                   **labels) -> Optional[float]:
        """Bucket-resolution quantile (q in [0, 1]).

        ``interpolate=False`` (the historical default) returns the smallest
        bucket edge whose cumulative count covers q of the observations —
        a bucket-*ceiling* value.  ``interpolate=True`` linearly
        interpolates inside the covering bucket (Prometheus
        ``histogram_quantile`` semantics, lower bound 0 for the first
        bucket), which is what should be compared against exact sample
        percentiles; the residual uncertainty is the covering bucket's
        width (:meth:`percentile_resolution`).  None when the series is
        empty; quantiles landing in the +Inf bucket report the largest
        finite edge either way (resolution is unbounded there)."""
        cum = self.cumulative(**labels)
        total = cum[-1][1]
        if total == 0:
            return None
        need = q * total
        prev_edge, prev_acc = 0.0, 0
        for edge, acc in cum:
            if acc >= need:
                if edge == _INF:
                    return self.buckets[-1]
                if not interpolate:
                    return edge
                if acc == prev_acc:      # need == 0 edge case
                    return prev_edge
                frac = (need - prev_acc) / (acc - prev_acc)
                return prev_edge + frac * (edge - prev_edge)
            prev_edge, prev_acc = edge, acc
        return self.buckets[-1]

    def percentile_resolution(self, q: float, **labels) -> Optional[float]:
        """Width of the bucket the q-quantile lands in — the explicit
        resolution an interpolated percentile read carries (inf when the
        quantile sits in the +Inf bucket, None when the series is empty)."""
        cum = self.cumulative(**labels)
        total = cum[-1][1]
        if total == 0:
            return None
        need = q * total
        prev_edge = 0.0
        for edge, acc in cum:
            if acc >= need:
                return _INF if edge == _INF else edge - prev_edge
            prev_edge = edge
        return _INF


def bucket_percentile(samples: Sequence[float], edges: Sequence[float],
                      q: float) -> Tuple[Optional[float], Optional[float]]:
    """(interpolated quantile, bucket resolution) of ``samples`` as a
    histogram with the given finite ``edges`` would report them — the
    offline twin of :meth:`Histogram.percentile` for per-batch sample
    lists (e.g. a scheduler's ``request_log``), so exact order statistics
    and histogram reads can be compared at a stated resolution instead of
    exact-vs-bucket-floor."""
    samples = [float(s) for s in samples]
    if not samples:
        return None, None
    edges = tuple(sorted(float(e) for e in edges))
    counts = [0] * (len(edges) + 1)
    for s in samples:
        counts[bisect.bisect_left(edges, s)] += 1
    total = len(samples)
    need = q * total
    prev_edge, acc = 0.0, 0
    for edge, c in zip(edges, counts):
        prev_acc, acc = acc, acc + c
        if acc >= need:
            width = edge - prev_edge
            if acc == prev_acc:
                return prev_edge, width
            frac = (need - prev_acc) / (acc - prev_acc)
            return prev_edge + frac * width, width
        prev_edge = edge
    return edges[-1], _INF          # quantile in the +Inf bucket


class MetricsRegistry:
    """Named metric collection with get-or-create declaration semantics."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _declare(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                assert isinstance(m, cls), (
                    f"metric {name!r} already declared as {m.kind}, "
                    f"not {cls.kind}")
                assert m.help == help, (
                    f"metric {name!r} re-declared with different help: "
                    f"{m.help!r} vs {help!r}")
                if kw.get("buckets") is not None:
                    assert tuple(sorted(map(float, kw["buckets"]))) == m.buckets, (
                        f"histogram {name!r} re-declared with different buckets")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str) -> Counter:
        return self._declare(Counter, name, help)

    def gauge(self, name: str, help: str) -> Gauge:
        return self._declare(Gauge, name, help)

    def histogram(self, name: str, help: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def metrics(self) -> Iterable[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def clear_values(self) -> None:
        """Reset every series (metric declarations stay) — test isolation."""
        for m in self.metrics():
            m.clear()

    def bucket_coverage(self, threshold: float = 0.05,
                        min_count: int = 20) -> List[dict]:
        """Histogram series whose +Inf bucket holds more than ``threshold``
        of their observations — the signal that a bucket family no longer
        covers the live distribution and needs re-tuning (how the
        families above were tuned).  Series with fewer
        than ``min_count`` observations are skipped (one cold-compile
        outlier is not a coverage problem)."""
        findings = []
        for m in self.metrics():
            if not isinstance(m, Histogram):
                continue
            for key in sorted(m.series()):
                snap = m.snapshot(**dict(key))
                count = snap["count"]
                if count < min_count:
                    continue
                inf_hits = count - snap["buckets"][-2][1]
                frac = inf_hits / count
                if frac > threshold:
                    findings.append(dict(
                        name=m.name, labels=dict(key), count=count,
                        inf_fraction=frac, top_edge=m.buckets[-1]))
        return findings

    def check_bucket_coverage(self, threshold: float = 0.05,
                              min_count: int = 20,
                              warn: bool = True) -> List[dict]:
        """:meth:`bucket_coverage` + a ``UserWarning`` per finding, so an
        out-of-range bucket family is loud instead of silently truncating
        every percentile read."""
        findings = self.bucket_coverage(threshold, min_count)
        if warn:
            for f in findings:
                warnings.warn(
                    f"histogram {f['name']}{f['labels'] or ''}: "
                    f"{f['inf_fraction']:.0%} of {f['count']} observations "
                    f"above the top bucket edge {f['top_edge']} — bucket "
                    f"family needs re-tuning", stacklevel=2)
        return findings


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the instrumented subsystems report into."""
    return _DEFAULT


def reset_default_registry() -> None:
    """Zero every series in the default registry (declarations persist, so
    module-level metric handles stay valid) — used by tests to isolate
    counter deltas."""
    _DEFAULT.clear_values()
