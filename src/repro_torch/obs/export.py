"""Metric exposition (``repro.obs.export``): Prometheus text format, an HTTP
scrape endpoint, and JSONL snapshots for offline diffing.

* :func:`prometheus_text` renders a registry in the Prometheus text
  exposition format (HELP/TYPE headers, cumulative ``_bucket{le=...}``
  histogram series), byte for byte as the JAX package does.
* :func:`start_metrics_server` serves it at ``/metrics`` from a stdlib
  ``http.server`` daemon thread: no third-party dependency, scrapeable by
  any Prometheus or curl.
* :func:`write_snapshot` appends one self-contained JSON object per call to
  a ``.jsonl`` file, the offline twin of a scrape, diffable across runs.
"""
from __future__ import annotations

import http.server
import json
import threading
import time
from typing import Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, default_registry

__all__ = [
    "prometheus_text",
    "registry_snapshot",
    "write_snapshot",
    "MetricsServer",
    "start_metrics_server",
]


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(items) -> str:
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(edge: float) -> str:
    return "+Inf" if edge == float("inf") else _fmt_value(edge)


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """The registry in Prometheus text exposition format (deterministic
    ordering: metrics by name, series by label key — golden-file tested)."""
    registry = registry or default_registry()
    lines = []
    for m in registry.metrics():
        lines.append(f"# HELP {m.name} {_escape(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, (Counter, Gauge)):
            for key in sorted(m.series()):
                lines.append(f"{m.name}{_fmt_labels(key)} "
                             f"{_fmt_value(m.series()[key])}")
        elif isinstance(m, Histogram):
            for key in sorted(m.series()):
                labels = dict(key)
                for edge, acc in m.cumulative(**labels):
                    le = _fmt_labels(tuple(key) + (("le", _fmt_le(edge)),))
                    lines.append(f"{m.name}_bucket{le} {acc}")
                snap = m.snapshot(**labels)
                lines.append(f"{m.name}_sum{_fmt_labels(key)} "
                             f"{_fmt_value(snap['sum'])}")
                lines.append(f"{m.name}_count{_fmt_labels(key)} "
                             f"{snap['count']}")
    return "\n".join(lines) + "\n"


def registry_snapshot(registry: Optional[MetricsRegistry] = None) -> dict:
    """JSON-ready dump of every series (the ``write_snapshot`` payload)."""
    registry = registry or default_registry()
    out = {}
    for m in registry.metrics():
        series = {}
        for key in sorted(m.series()):
            label_str = ",".join(f"{k}={v}" for k, v in key) or "_"
            if isinstance(m, Histogram):
                snap = m.snapshot(**dict(key))
                series[label_str] = dict(
                    sum=snap["sum"], count=snap["count"],
                    buckets=[[_fmt_le(e), c] for e, c in snap["buckets"]])
            else:
                series[label_str] = m.series()[key]
        out[m.name] = dict(kind=m.kind, help=m.help, series=series)
    return out


def write_snapshot(path: str,
                   registry: Optional[MetricsRegistry] = None,
                   **meta) -> dict:
    """Append one snapshot object (plus caller metadata, e.g. a run label)
    as a JSON line; returns the object written."""
    obj = dict(unix_time=time.time(), metrics=registry_snapshot(registry),
               **meta)
    with open(path, "a") as f:
        f.write(json.dumps(obj, sort_keys=True))
        f.write("\n")
    return obj


class _Handler(http.server.BaseHTTPRequestHandler):
    registry: MetricsRegistry = None  # set per-server via type()

    def do_GET(self):  # noqa: N802 (stdlib API name)
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_response(404)
            self.end_headers()
            return
        body = prometheus_text(self.registry).encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr spam
        pass


class MetricsServer:
    """`/metrics` scrape endpoint on a daemon thread (stdlib only)."""

    def __init__(self, port: int, registry: Optional[MetricsRegistry] = None,
                 host: str = "0.0.0.0"):
        registry = registry or default_registry()
        handler = type("BoundHandler", (_Handler,), {"registry": registry})
        self.httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]   # resolved when port == 0
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name=f"metrics:{self.port}",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_metrics_server(port: int,
                         registry: Optional[MetricsRegistry] = None,
                         host: str = "0.0.0.0") -> MetricsServer:
    """Start the scrape endpoint (``port=0`` binds an ephemeral port,
    reported as ``server.port``)."""
    return MetricsServer(port, registry, host=host)
