"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``) on the same inputs.

* the exporters reproduce the JAX package's golden files byte for byte
  (Prometheus text, StatsD lines, OTLP-JSON) from the registry script the
  JAX golden tests use, and both registries agree on percentiles, bucket
  coverage and snapshots;
* SLO burn rates, alert edges and vetoes are equal on the event streams of
  the JAX SLO tests;
* the audit log resumes ``seq`` after a torn final line, and each package
  reads the other's log;
* ``step_error_summary`` and ``ErrorAttributor`` give JAX's numbers on the
  records of a tiny adaptive serve run by both packages on the same weights
  (f32: the records are equal, so the summaries agree to ``QOR_RTOL``, the
  float64 rounding of the same sums);
* the metric names, types, help strings and label keys the port registers
  after a serve are a subset of JAX's after the same serve.

The default registries are process-global: each test that reads them
resets both first, so nothing depends on the order of xdist workers.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
import repro.runtime as JR
from repro import obs as jobs
from repro.configs import qwen2_72b as j_qwen2, reduced as j_reduced
from repro.configs.base import AxPolicy as JPolicy
from repro.fleet import PolicyReader as JReader, PolicyStore as JStore
from repro.launch.serve import _drift_hook as j_drift_hook
from repro.serve.engine import ServeConfig as JServe, generate as j_generate
from repro_torch import obs as tobs
from repro_torch.configs import qwen2_72b as t_qwen2, reduced as t_reduced
from repro_torch.configs.base import AxPolicy as TPolicy
from repro_torch.convert import params_from_jax
from repro_torch.fleet import PolicyReader as TReader, PolicyStore as TStore
from repro_torch.launch.serve import drift_hook
import repro_torch.runtime as TR
from repro_torch.runtime import telemetry as TT
from repro_torch.serve import ServeConfig, generate

DATA = os.path.join(os.path.dirname(__file__), "data")
QOR_RTOL = 1e-12
B, S, T_NEW = 2, 8, 10


# ---------------------------------------------------------------------------
# registry and exporters
# ---------------------------------------------------------------------------

def _golden_registry(o):
    """The JAX golden tests' registry script, on either package's obs."""
    reg = o.MetricsRegistry()
    c = reg.counter("repro_demo_total", "a counter with labels")
    c.inc(3, mode="wave")
    c.inc(1.5, mode="token")
    g = reg.gauge("repro_demo_occupancy", 'quoted "help" with\nnewline')
    g.set(0.75)
    h = reg.histogram("repro_demo_seconds", "a histogram",
                      buckets=(0.1, 1.0, 10.0))
    h.observe(0.05, path="a")
    h.observe(0.5, path="a")
    h.observe(99.0, path="a")
    return reg


_RENDER = {
    "metrics_golden.prom": lambda o, r: o.prometheus_text(r),
    "metrics_golden.statsd": lambda o, r: "\n".join(o.statsd_lines(r)) + "\n",
    "metrics_golden_otlp.json": lambda o, r: o.otlp_json(r, time_unix_nano=0),
}


@pytest.mark.parametrize("golden", sorted(_RENDER))
def test_exporters_reproduce_the_golden_files(golden):
    got = _RENDER[golden](tobs, _golden_registry(tobs))
    want = _RENDER[golden](jobs, _golden_registry(jobs))
    with open(os.path.join(DATA, golden)) as f:
        text = f.read()
    if golden.endswith(".json"):
        assert got == json.loads(text) == want
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    else:
        assert got == text == want


def _registry_reads(o):
    reg = _golden_registry(o)
    h = reg.get("repro_demo_seconds")
    for v in (0.2, 0.3, 2.0, 5.0, 50.0):
        h.observe(v, path="b")
    snap = o.registry_snapshot(reg)
    return dict(
        p=[h.percentile(q, interpolate=i, path=p) for q in (0.1, 0.5, 0.9, 0.99)
           for i in (False, True) for p in ("a", "b")],
        res=[h.percentile_resolution(q, path="b") for q in (0.1, 0.5, 0.99)],
        offline=o.bucket_percentile([0.2, 0.3, 2.0, 5.0, 50.0], (0.1, 1.0, 10.0), 0.5),
        coverage=reg.bucket_coverage(threshold=0.05, min_count=2),
        snapshot=snap,
        total=reg.get("repro_demo_total").total(),
    )


def test_registry_reads_equal_jax():
    assert _registry_reads(tobs) == _registry_reads(jobs)


def test_snapshot_file_and_scrape_equal_jax(tmp_path):
    import urllib.request

    objs = [o.write_snapshot(str(tmp_path / f"{n}.jsonl"), _golden_registry(o), run="x")
            for n, o in (("t", tobs), ("j", jobs))]
    for ob in objs:
        ob.pop("unix_time")
    assert objs[0] == objs[1]
    with tobs.MetricsServer(0, _golden_registry(tobs), host="127.0.0.1") as srv:
        body = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                      timeout=10).read().decode()
    assert body == jobs.prometheus_text(_golden_registry(jobs))


def test_statsd_push_and_otlp_file_push_equal_jax(tmp_path):
    out = {}
    for n, o in (("t", tobs), ("j", jobs)):
        mirror, otlp = str(tmp_path / f"{n}.statsd"), str(tmp_path / f"{n}.otlp.jsonl")
        sd = o.StatsdExporter("127.0.0.1", 9, mirror=mirror)
        units = o.push_all([sd], _golden_registry(o))
        sd.close()
        ox = o.OtlpJsonExporter(otlp)
        assert ox.push(_golden_registry(o), time_unix_nano=7) == 1
        with open(mirror) as f, open(otlp) as g:
            out[n] = (units, f.read(), g.read())
    assert out["t"] == out["j"]


# ---------------------------------------------------------------------------
# SLO engine: the JAX SLO tests' event streams through both engines
# ---------------------------------------------------------------------------

def _spec(o, **kw):
    base = dict(name="s", kind="latency", source="e2e", threshold=1.0,
                objective=0.1, short_window=4, long_window=8,
                burn_alert=2.0, min_events=4)
    base.update(kw)
    return o.SLOSpec(**base)


def _slo_min_events(o, audit):
    eng = o.SLOEngine([_spec(o)], audit=audit)
    return eng, [("lat", "e2e", 5.0)] * 4


def _slo_both_windows(o, audit):
    eng = o.SLOEngine([_spec(o, short_window=2, long_window=8, min_events=2),
                       _spec(o, name="s3", short_window=2, long_window=8, min_events=2,
                             burn_alert=3.0)], audit=audit)
    return eng, [("lat", "e2e", 0.1)] * 6 + [("lat", "e2e", 5.0)] * 2


def _slo_edges(o, audit):
    eng = o.SLOEngine([_spec(o, short_window=4, long_window=4, min_events=2)], audit=audit)
    return eng, [("lat", "e2e", 5.0)] * 4 + [("lat", "e2e", 0.1)] * 4


def _slo_guard_band(o, audit):
    eng = o.SLOEngine([_spec(o, kind="qor", source="mlp", threshold=1.5, short_window=2,
                             long_window=2, min_events=1)], audit=audit)
    eng.set_reference("mlp", 100.0)
    return eng, [("qor", "mlp", 140.0), ("qor", "mlp", 160.0), ("qor", "other", 1e9)]


def _slo_veto(o, audit):
    eng = o.SLOEngine([
        _spec(o, name="lat", short_window=2, long_window=2, min_events=1),
        _spec(o, name="qor", kind="qor", source="mlp", threshold=0.0, short_window=2,
              long_window=2, min_events=1, veto_promotion=True)], audit=audit)
    return eng, [("lat", "e2e", 9.0)] * 2 + [("qor", "mlp", 1.0)] * 2


def _slo_stock(o, audit):
    eng = o.SLOEngine(o.default_serving_slos(qor_targets=("mlp", "attn_out")), audit=audit)
    eng.set_reference("mlp", 10.0)
    rng = np.random.default_rng(3)
    ev = [("lat", "ttft", float(x)) for x in rng.uniform(0, 12, 40)]
    ev += [("qor", "mlp", float(x)) for x in rng.uniform(5, 25, 70)]
    ev += [("qor", "attn_out", float(x)) for x in rng.uniform(0, 3, 20)]
    return eng, ev


@pytest.mark.parametrize("case", [_slo_min_events, _slo_both_windows, _slo_edges,
                                  _slo_guard_band, _slo_veto, _slo_stock])
def test_slo_engine_equals_jax(case, tmp_path):
    """Per event: burn rates, alerting set and veto; then the audit edges
    and the burn-rate gauges."""
    traces, audits = [], []
    for n, o in (("t", tobs), ("j", jobs)):
        o.reset_default_registry()
        audit = o.AuditLog(str(tmp_path / n / "audit.jsonl"))
        eng, events = case(o, audit)
        names = [st.spec.name for st in eng._states.values()]
        trace = []
        for kind, src, v in events:
            (eng.observe_latency if kind == "lat" else eng.observe_qor)(src, v)
            trace.append(([eng.burn_rate(nm) for nm in names],
                          [dataclasses.astuple(a) for a in eng.alerting()],
                          eng.vetoes_promotion(), [eng.events(nm) for nm in names]))
        trace.append(eng.describe())
        trace.append(o.registry_snapshot()["repro_slo_burn_rate"])
        traces.append(trace)
        audits.append([{k: v for k, v in e.items() if k != "unix_time"}
                       for e in audit.read()])
    assert traces[0] == traces[1]
    assert audits[0] == audits[1]


def test_slo_spec_validation_equals_jax():
    for o in (tobs, jobs):
        for kw in (dict(kind="nope"), dict(objective=0.0), dict(short_window=9)):
            with pytest.raises(ValueError):
                _spec(o, **kw)
        with pytest.raises(ValueError):
            o.SLOEngine([_spec(o), _spec(o)])


# ---------------------------------------------------------------------------
# audit log
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(tobs, tobs), (tobs, jobs), (jobs, tobs)])
def test_audit_seq_resumes_after_a_torn_final_line(tmp_path, writer, reader):
    path = str(tmp_path / "audit.jsonl")
    log = writer.AuditLog(path)
    for i in range(3):
        log.append("retune", idx=i, grid=np.arange(3, dtype=np.int32),
                   score=np.float64(0.5))
    with open(path, "rb") as f:
        body = f.read()
    with open(path, "wb") as f:               # a kill mid-append: torn tail
        f.write(body[:-7])
    log2 = reader.AuditLog(path)
    assert [e["seq"] for e in log2.read()] == [0, 1]
    ev = log2.append("retune", idx=99)
    assert ev["seq"] == 2
    events = writer.AuditLog(path).read()
    assert [e["seq"] for e in events] == [0, 1, 2] and events[-1]["idx"] == 99
    assert events[0]["grid"] == [0, 1, 2] and events[0]["score"] == 0.5


def test_grid_digest_equals_jax():
    for g in (np.arange(12).reshape(4, 1, 3), np.zeros((2, 1, 3)), [[[1, 3, 0]]]):
        assert tobs.grid_digest(g) == jobs.grid_digest(g)


def test_tile_key_suffix_equals_the_ports_runtime():
    assert tobs.qor.TILE_KEY_SUFFIX == TT.TILE_KEY_SUFFIX == jobs.qor.TILE_KEY_SUFFIX
    assert TT.tile_key("mlp") == "mlp" + tobs.qor.TILE_KEY_SUFFIX
    assert {"err_lo", "err_hi", "n", "tile_err_lo", "tile_err_hi", "tile_n"} <= \
        set(TT.SUM_FIELDS)


def test_trace_recorder_events_equal_jax(tmp_path):
    """The same span/instant/async script gives the same event skeleton
    (names, phases, categories, args) in both packages."""
    skel = []
    for o in (tobs, jobs):
        rec = o.TraceRecorder()
        prev = o.install_recorder(rec)
        try:
            with o.span("decode", cat="engine", path="fused", batch=2):
                o.instant("canary", cat="adapt", target="mlp", confirmed=True)
            o.async_begin("request", 7)
            o.async_end("request", 7, done=np.int32(3))
        finally:
            o.install_recorder(prev)
        path = rec.save(str(tmp_path / f"{o.__name__}.json"))
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
        skel.append([(e["name"], e["ph"], e["cat"], e["args"], e.get("id"), e.get("s"))
                     for e in evs])
    assert skel[0] == skel[1]


def test_device_trace_on_the_cpu(tmp_path):
    with tobs.device_trace(str(tmp_path / "dt"), device="cpu") as path:
        torch.ones(8).add_(1)
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            with tobs.device_trace(str(tmp_path / "dt2")):
                pass


# ---------------------------------------------------------------------------
# a tiny adaptive serve through both packages: QoR and the metric catalogue
# ---------------------------------------------------------------------------

def _catalogue(registry):
    """{name: (kind, help, set of label-key tuples)} of a registry."""
    return {m.name: (m.kind, m.help, {tuple(k for k, _ in key) for key in m.series()})
            for m in registry.metrics()}


def _record_observe(ctrl, sink):
    orig = ctrl.observe

    def observe(records):
        sink.append({t: {k: np.array(v) for k, v in r.items()} for t, r in records.items()})
        return orig(records)

    ctrl.observe = observe


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The reduced qwen2 (2 layers, f32, ``kernel`` backend) served by both
    packages on the JAX package's seeded weights: a static serve, then a
    drift serve (stepwise) whose controller writes a store with the canary
    on and an SLO engine attached, then a replica poll.  Returns the
    observed records and each package's registry snapshot."""
    root = tmp_path_factory.mktemp("served")
    jc = dataclasses.replace(j_reduced(j_qwen2), n_layers=2, compute_dtype="float32",
                             ax=JPolicy(backend="kernel"))
    tc = dataclasses.replace(t_reduced(t_qwen2), n_layers=2, compute_dtype="float32",
                             ax=TPolicy(backend="kernel"))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.device_get(jp), tc, device="cpu")
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S)).astype(np.int32)
    cfg = dict(min_observe_steps=2, cooldown_steps=2, drift_threshold=0.03, canary=True)
    out = {}
    for n, o in (("t", tobs), ("j", jobs)):
        o.reset_default_registry()
        store = (TStore if n == "t" else JStore)(str(root / n))
        if n == "t":
            ctrl = TR.AdaptiveController(TR.SwapPolicy.from_ax_policy(tc.ax), tc.ax.targets,
                                         cfg=TR.AdaptiveConfig(**cfg), store=store,
                                         device="cpu")
        else:
            ctrl = JR.AdaptiveController(JR.SwapPolicy.from_ax_policy(jc.ax), jc.ax.targets,
                                         cfg=JR.AdaptiveConfig(**cfg), store=store)
        ctrl.resume_from_store()
        ctrl.attach_slo(o.SLOEngine(o.default_serving_slos(qor_targets=tc.ax.targets),
                                    audit=ctrl.audit))
        records = []
        _record_observe(ctrl, records)
        if n == "t":
            static = generate(tp, {"tokens": torch.from_numpy(toks)}, tc,
                              ServeConfig(max_new_tokens=4)).numpy()
            adaptive = generate(tp, {"tokens": torch.from_numpy(toks)}, tc,
                                ServeConfig(max_new_tokens=T_NEW), adaptive=ctrl,
                                param_hook=drift_hook(3, 0.05)).numpy()
            reader = TReader(store, tc.ax.targets, device="cpu")
        else:
            static = np.asarray(j_generate(jp, {"tokens": jnp.asarray(toks)}, jc,
                                           JServe(max_new_tokens=4)))
            adaptive = np.asarray(j_generate(jp, {"tokens": jnp.asarray(toks)}, jc,
                                             JServe(max_new_tokens=T_NEW), adaptive=ctrl,
                                             param_hook=j_drift_hook(3, 0.05)))
            reader = JReader(store, jc.ax.targets)
        reader.poll()
        paths = {dict(k)["path"] for k in o.default_registry().get(
            "repro_decode_dispatch_seconds").series()}
        out[n] = dict(records=records, static=static, adaptive=adaptive,
                      catalogue=_catalogue(o.default_registry()), paths=paths,
                      audit=ctrl.audit.read(), retunes=len(ctrl.retunes))
    return out


def test_served_tokens_and_audit_equal_jax(served):
    t, j = served["t"], served["j"]
    np.testing.assert_array_equal(t["static"], j["static"])
    np.testing.assert_array_equal(t["adaptive"], j["adaptive"])
    assert t["retunes"] >= 1 and t["retunes"] == j["retunes"]
    keys = ("kind", "step", "target", "old", "new", "store_version", "candidate_version")
    assert [tuple(e.get(k) for k in keys) for e in t["audit"]] == \
        [tuple(e.get(k) for k in keys) for e in j["audit"]]


def test_step_error_summary_on_serve_records_equals_jax(served):
    t, j = served["t"]["records"], served["j"]["records"]
    assert len(t) == len(j) == T_NEW - 1
    for rt, rj in zip(t, j):
        st, tt = tobs.step_error_summary(rt)
        sj, tj = jobs.step_error_summary(rj)
        assert sorted(st) == sorted(sj) == ["attn_out", "mlp"]
        for k in st:
            assert st[k] == pytest.approx(sj[k], rel=QOR_RTOL)
        assert tt == tj == {}


def test_error_attributor_on_serve_records_equals_jax(served):
    """Two requests over the serve's steps: one live throughout, one for
    the second half, and one that never sees a step (fleet basis)."""
    t, j = served["t"]["records"], served["j"]["records"]
    outs = []
    for o, recs in ((tobs, t), (jobs, j)):
        o.reset_default_registry()
        at = o.ErrorAttributor(top_k=2)
        at.begin("0#0", 0)
        for i, r in enumerate(recs):
            if i == len(recs) // 2:
                at.begin("1#1", 1)
            at.observe_step(r, live=["0#0", "1#1"] if i >= len(recs) // 2 else ["0#0"])
        at.begin("2#2", 2)
        outs.append(([at.finish(c) for c in ("0#0", "1#1", "2#2")], at.fleet_share(),
                      o.registry_snapshot()["repro_qor_request_mae"]))
    (qt, ft, ht), (qj, fj, hj) = outs
    assert [q["basis"] for q in qt] == ["request", "request", "fleet"]
    for a, b in zip(qt, qj):
        assert {k: a[k] for k in ("corr", "rid", "steps", "basis", "tiles", "weighting")} == \
            {k: b[k] for k in ("corr", "rid", "steps", "basis", "tiles", "weighting")}
        for k in ("ew_mae", "share"):
            assert a[k] == pytest.approx(b[k], rel=QOR_RTOL)
        assert [e["where"] for e in a["top"]] == [e["where"] for e in b["top"]]
    assert ft == pytest.approx(fj, rel=QOR_RTOL)
    assert sorted(ht["series"]) == sorted(hj["series"])


def test_port_metrics_are_a_subset_of_jax_with_equal_help(served):
    t, j = served["t"]["catalogue"], served["j"]["catalogue"]
    live = {n for n, (_, _, keys) in t.items() if keys}
    assert {"repro_retunes_total", "repro_canary_total", "repro_decode_tokens_total",
            "repro_decode_dispatch_seconds", "repro_prefill_dispatch_seconds",
            "repro_drift_score", "repro_policy_store_published",
            "repro_policy_adoptions_total", "repro_slo_burn_rate"} <= live
    for name, (kind, help_, keys) in t.items():
        assert name in j, name
        assert (kind, help_) == j[name][:2], name
        assert keys <= j[name][2] or not j[name][2], (name, keys, j[name][2])
    # the decode paths carry JAX's path labels
    assert served["t"]["paths"] == served["j"]["paths"] == {"fused", "stepwise"}
