"""Observability of the port (``repro.obs``): one host-side measurement
substrate for the serving and adaptation loop.

  metrics  — counter/gauge/histogram registry with label sets; the
             process-wide :func:`default_registry` every subsystem reports
             into
  trace    — Chrome-trace-format spans (prefill -> decode -> retune ->
             canary -> rollback on one timeline), and :func:`device_trace`,
             a ``torch.profiler`` trace of the card (or the CPU) around a block
  export   — Prometheus text, a stdlib ``http.server`` scrape thread, and
             JSONL snapshots
  audit    — the append-only retune event log next to the policy store
  backends — push exporters: StatsD lines over UDP, OTLP-JSON to a file or
             over HTTP
  slo      — SLO specs with multi-window burn rates; an alerting QoR SLO
             vetoes canary promotion in the controller
  qor      — per-target step MAE from telemetry records, and per-request
             error attribution

Metric names, label keys, help strings and the on-disk formats are the JAX
package's, so dashboards, golden files, audit logs and stores are shared.

**Retrace accounting.**  A compiled-program install of the port is a CUDA
graph capture (``serve/graph.py``): every capture counts into
``repro_retraces_total{kind=}`` with kind ``fused``, ``fused_adaptive`` or
``token_step``.  The port's prefill runs eagerly, so kind ``prefill`` never
counts.  Policy updates and splices change the values in a graph's buffers
and never count.  The JAX package's ``repro_jax_compiles_total`` has no
counterpart: there is no XLA here, and ``kernels/_build.NVCC_RUNS`` counts
the nvcc builds.

Everything here is stdlib and numpy, imports nothing of the runtime, and
runs on the host outside captured code.
"""
from __future__ import annotations

from . import audit, backends, export, metrics, qor, slo, trace
from .audit import AUDIT_FILENAME, AuditLog, audit_for_store, grid_digest
from .backends import (OtlpJsonExporter, StatsdExporter, otlp_json, push_all,
                       statsd_lines)
from .export import (MetricsServer, prometheus_text, registry_snapshot,
                     start_metrics_server, write_snapshot)
from .metrics import (DISPATCH_BUCKETS, E2E_BUCKETS, LATENCY_BUCKETS,
                      QOR_MAE_BUCKETS, TTFT_BUCKETS, Counter, Gauge,
                      Histogram, MetricsRegistry, bucket_percentile,
                      default_registry, reset_default_registry)
from .qor import ErrorAttributor, step_error_summary
from .slo import SLOAlert, SLOEngine, SLOSpec, default_serving_slos
from .trace import (TraceRecorder, async_begin, async_end, current_recorder,
                    device_trace, install_recorder, instant, span)

__all__ = [
    "audit", "backends", "export", "metrics", "qor", "slo", "trace",
    "AUDIT_FILENAME", "AuditLog", "audit_for_store", "grid_digest",
    "OtlpJsonExporter", "StatsdExporter", "otlp_json", "push_all",
    "statsd_lines",
    "MetricsServer", "prometheus_text", "registry_snapshot",
    "start_metrics_server", "write_snapshot",
    "LATENCY_BUCKETS", "TTFT_BUCKETS", "E2E_BUCKETS", "DISPATCH_BUCKETS",
    "QOR_MAE_BUCKETS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "bucket_percentile", "default_registry", "reset_default_registry",
    "ErrorAttributor", "step_error_summary",
    "SLOAlert", "SLOEngine", "SLOSpec", "default_serving_slos",
    "TraceRecorder", "async_begin", "async_end", "current_recorder",
    "device_trace", "install_recorder", "instant", "span",
    "RETRACES", "count_retrace", "retrace_total",
]


# one series per program kind: "token_step", "fused_adaptive", "fused"
# (module note); a retrace is one CUDA graph capture
RETRACES = default_registry().counter(
    "repro_retraces_total",
    "compiled-program installs in the serving engine by program kind "
    "(policy updates and splices change traced values only and never count)")


def count_retrace(kind: str) -> None:
    """Record one compiled-program install (a graph capture) of ``kind``."""
    RETRACES.inc(1, kind=kind)


def retrace_total(kind: str = None) -> float:
    """Current retrace count — one kind, or the process-wide total."""
    if kind is None:
        return RETRACES.total()
    return RETRACES.value(kind=kind)
