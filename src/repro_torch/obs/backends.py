"""Push exporter backends (``repro.obs.backends``): StatsD line protocol
and OTLP-JSON.

The Prometheus path (:mod:`.export`) is pull-shaped; fleets behind a
StatsD agent or an OpenTelemetry collector want the registry pushed
instead.  Both backends implement one interface, ``exporter.push(registry)
-> int`` (payload units emitted) and ``close()``, over the same registry
reads as the pull path, stdlib-only:

* :class:`StatsdExporter` — StatsD line protocol over UDP with DogStatsD
  ``|#tag:value`` labels; counters as ``|c``, gauges as ``|g``, histograms
  flattened to ``.sum``/``.count`` and interpolated ``.p50``/``.p99``
  gauge reads (UDP agents cannot ingest bucket vectors).  Lines pack into
  <= ``mtu``-byte datagrams; an optional ``mirror`` file receives every
  line (UDP is fire-and-forget by design).
* :class:`OtlpJsonExporter` — OTLP/JSON ``resourceMetrics`` payloads,
  appended to a ``.jsonl`` file or POSTed to an HTTP endpoint
  (``http(s)://.../v1/metrics``).  Histograms keep full bucket vectors
  (non-cumulative ``bucketCounts`` + ``explicitBounds``, per the OTLP
  data model).

Rendering (:func:`statsd_lines`, :func:`otlp_json`) is pure and
deterministic (metrics sorted by name, series by label key, timestamps
injected by the caller) and gives the JAX package's bytes: the
instrumentation scope stays ``repro.obs``, so one collector reads both.
"""
from __future__ import annotations

import json
import socket
import time
import urllib.error
import urllib.request
from typing import List, Optional, Sequence

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, _INF,
                      default_registry)

__all__ = [
    "statsd_lines",
    "StatsdExporter",
    "otlp_json",
    "OtlpJsonExporter",
    "push_all",
]

_REG = default_registry()
_PUSHES = _REG.counter(
    "repro_obs_pushes_total",
    "registry pushes through an exporter backend, by backend")


def _tags(key) -> str:
    if not key:
        return ""
    return "|#" + ",".join(f"{k}:{v}" for k, v in key)


def statsd_lines(registry: Optional[MetricsRegistry] = None,
                 prefix: str = "") -> List[str]:
    """Render the registry as StatsD/DogStatsD lines (deterministic
    ordering; histogram percentiles interpolated at stated bucket
    resolution, see ``Histogram.percentile``)."""
    registry = registry or default_registry()
    lines: List[str] = []
    for m in registry.metrics():
        name = prefix + m.name
        if isinstance(m, Counter):
            for key in sorted(m.series()):
                lines.append(f"{name}:{m.series()[key]:g}|c{_tags(key)}")
        elif isinstance(m, Gauge):
            for key in sorted(m.series()):
                lines.append(f"{name}:{m.series()[key]:g}|g{_tags(key)}")
        elif isinstance(m, Histogram):
            for key in sorted(m.series()):
                labels = dict(key)
                snap = m.snapshot(**labels)
                lines.append(f"{name}.sum:{snap['sum']:g}|g{_tags(key)}")
                lines.append(f"{name}.count:{snap['count']:g}|g{_tags(key)}")
                for q in (0.5, 0.99):
                    v = m.percentile(q, interpolate=True, **labels)
                    if v is not None:
                        lines.append(f"{name}.p{int(q * 100)}:{v:g}|g"
                                     f"{_tags(key)}")
    return lines


class StatsdExporter:
    """StatsD push over UDP (optionally mirrored to a file)."""

    backend = "statsd"

    def __init__(self, host: str = "127.0.0.1", port: int = 8125,
                 prefix: str = "", mtu: int = 1400,
                 mirror: Optional[str] = None):
        self.addr = (host, int(port))
        self.prefix = prefix
        self.mtu = int(mtu)
        self.mirror = mirror
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.lines_sent = 0
        self.packets_sent = 0

    @classmethod
    def from_spec(cls, spec: str, **kw) -> "StatsdExporter":
        """``HOST:PORT``."""
        host, _, port = spec.rpartition(":")
        return cls(host=host or "127.0.0.1", port=int(port), **kw)

    def push(self, registry: Optional[MetricsRegistry] = None) -> int:
        lines = statsd_lines(registry, prefix=self.prefix)
        packet: List[str] = []
        size = 0
        for line in lines:
            n = len(line) + 1
            if packet and size + n > self.mtu:
                self._send(packet)
                packet, size = [], 0
            packet.append(line)
            size += n
        if packet:
            self._send(packet)
        if self.mirror and lines:
            with open(self.mirror, "a") as f:
                f.write("\n".join(lines) + "\n")
        self.lines_sent += len(lines)
        _PUSHES.inc(1, backend=self.backend)
        return len(lines)

    def _send(self, lines: Sequence[str]) -> None:
        try:
            self.sock.sendto("\n".join(lines).encode(), self.addr)
            self.packets_sent += 1
        except OSError:
            pass                    # fire-and-forget: UDP loss is expected

    def close(self) -> None:
        self.sock.close()


def _attrs(key) -> List[dict]:
    return [dict(key=k, value=dict(stringValue=str(v))) for k, v in key]


def otlp_json(registry: Optional[MetricsRegistry] = None,
              time_unix_nano: int = 0,
              service_name: str = "repro-swapper") -> dict:
    """Render the registry as one OTLP/JSON ``resourceMetrics`` payload.
    ``time_unix_nano`` is caller-injected so payloads are reproducible
    (golden-file tested with 0)."""
    registry = registry or default_registry()
    ts = str(int(time_unix_nano))
    metrics = []
    for m in registry.metrics():
        entry = dict(name=m.name, description=m.help)
        if isinstance(m, Counter):
            entry["sum"] = dict(
                dataPoints=[
                    dict(attributes=_attrs(key), timeUnixNano=ts,
                         asDouble=float(m.series()[key]))
                    for key in sorted(m.series())],
                aggregationTemporality=2,      # CUMULATIVE
                isMonotonic=True)
        elif isinstance(m, Gauge):
            entry["gauge"] = dict(
                dataPoints=[
                    dict(attributes=_attrs(key), timeUnixNano=ts,
                         asDouble=float(m.series()[key]))
                    for key in sorted(m.series())])
        elif isinstance(m, Histogram):
            points = []
            for key in sorted(m.series()):
                snap = m.snapshot(**dict(key))
                cum = snap["buckets"]
                counts, prev = [], 0
                for _, acc in cum:
                    counts.append(acc - prev)
                    prev = acc
                points.append(dict(
                    attributes=_attrs(key), timeUnixNano=ts,
                    count=str(snap["count"]), sum=float(snap["sum"]),
                    bucketCounts=[str(c) for c in counts],
                    explicitBounds=[e for e, _ in cum if e != _INF]))
            entry["histogram"] = dict(dataPoints=points,
                                      aggregationTemporality=2)
        metrics.append(entry)
    return dict(resourceMetrics=[dict(
        resource=dict(attributes=[dict(
            key="service.name",
            value=dict(stringValue=service_name))]),
        scopeMetrics=[dict(
            scope=dict(name="repro.obs"),
            metrics=metrics)])])


class OtlpJsonExporter:
    """OTLP-JSON push to a ``.jsonl`` file or an HTTP collector endpoint."""

    backend = "otlp"

    def __init__(self, target: str, service_name: str = "repro-swapper",
                 timeout_s: float = 2.0):
        self.target = target
        self.service_name = service_name
        self.timeout_s = float(timeout_s)
        self.is_http = target.startswith(("http://", "https://"))
        self.payloads_sent = 0
        self.errors = 0

    def push(self, registry: Optional[MetricsRegistry] = None,
             time_unix_nano: Optional[int] = None) -> int:
        if time_unix_nano is None:
            time_unix_nano = time.time_ns()
        payload = otlp_json(registry, time_unix_nano=time_unix_nano,
                            service_name=self.service_name)
        body = json.dumps(payload, sort_keys=True)
        if self.is_http:
            req = urllib.request.Request(
                self.target, data=body.encode(), method="POST",
                headers={"Content-Type": "application/json"})
            try:
                urllib.request.urlopen(req, timeout=self.timeout_s).close()
            except (urllib.error.URLError, OSError):
                self.errors += 1      # collector down: degrade, don't crash
                return 0
        else:
            with open(self.target, "a") as f:
                f.write(body)
                f.write("\n")
        self.payloads_sent += 1
        _PUSHES.inc(1, backend=self.backend)
        return 1

    def close(self) -> None:
        pass


def push_all(exporters: Sequence, registry=None) -> int:
    """Push the registry through every configured backend; returns total
    payload units emitted."""
    return sum(e.push(registry) for e in exporters)
