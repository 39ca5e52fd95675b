"""The guarded rollout of the port's controller (canary, SLO veto,
auto-rollback, quarantine through the chaos sites) against the JAX
package's, and a writer and a replica serving over one store on the CPU.

Both controllers take the same seeded operand streams; their audit-event
sequences must be equal with the wall clock (``unix_time``) left out, the
scores to ``SCORE_RTOL`` (the port's exact integer means against JAX's f32
means).  A scenario whose winners the two scorings order differently
would have to be named here as a tie; none of these is.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as C
import repro.runtime as JR
from repro import obs as jobs
from repro.fleet import PolicyStore as JStore, chaos as jchaos
import repro_torch.core as TC
import repro_torch.runtime as TR
from repro_torch import obs as tobs
from repro_torch.configs import qwen2_72b, reduced
from repro_torch.configs.base import AxPolicy
from repro_torch.fleet import PolicyReader, PolicyStore as TStore, chaos as tchaos
from repro_torch.launch.serve import drift_hook
from repro_torch.models import init_params
from repro_torch.serve import ServeConfig, generate

SCORE_RTOL = 1e-6
SCORES = ("old_score", "new_score", "predicted_gain", "observed_mae", "baseline_mae")


def _pair(tmp_path, start, mname="mul8u_trunc0_4", store=True, **kw):
    """A JAX and a port controller, each writing its own store."""
    cfg = dict(decay=0.4, drift_threshold=0.05, min_observe_steps=2, cooldown_steps=2,
               buffer_size=1024)
    cfg.update(kw)
    js = JStore(str(tmp_path / "j")) if store else None
    ts = TStore(str(tmp_path / "t")) if store else None
    j = JR.AdaptiveController(
        JR.SwapPolicy(mname, configs={"*": None if start is None else C.SwapConfig(*start)}),
        targets=("stream",), cfg=JR.AdaptiveConfig(**cfg), store=js)
    t = TR.AdaptiveController(
        TR.SwapPolicy(mname, configs={"*": None if start is None else TC.SwapConfig(*start)}),
        targets=("stream",), cfg=TR.AdaptiveConfig(**cfg), store=ts, device="cpu")
    for c in (j, t):
        c.warmup()
        c.resume_from_store()
    return j, t


def _feed(j, t, a, b):
    assert t.observe_operands("stream", a, b) == j.observe_operands("stream", a, b)


def _events(ctrl):
    return [{k: v for k, v in e.items() if k != "unix_time"} for e in ctrl.audit.read()]


def _assert_same_audit(j, t):
    ej, et = _events(j), _events(t)
    assert [e["kind"] for e in et] == [e["kind"] for e in ej]
    for a, b in zip(et, ej):
        assert sorted(a) == sorted(b)
        for k in a:
            if k in SCORES:
                assert a[k] == pytest.approx(b[k], rel=SCORE_RTOL, abs=1e-9), k
            elif k == "canary":
                assert a[k]["margin"] == b[k]["margin"]
                for s in ("incumbent", "winner"):
                    assert a[k][s] == pytest.approx(b[k][s], rel=SCORE_RTOL), k
            else:
                assert a[k] == b[k], k
    assert t.policy.to_json() == j.policy.to_json()
    assert t.store.versions() == j.store.versions()
    assert t.store.current_version() == j.store.current_version()
    assert t.store.candidate_version() == j.store.candidate_version()
    return et


def test_canary_rejection_keeps_incumbent(tmp_path):
    j, t = _pair(tmp_path, None, canary=True, canary_margin=1.0, min_observe_steps=1,
                 cooldown_steps=0)
    rng = np.random.default_rng(4)
    for _ in range(3):
        _feed(j, t, rng.integers(128, 256, 2048), rng.integers(0, 256, 2048))
    evs = [c.retune("stream") for c in (j, t)]
    for ev in evs:
        assert ev.promoted is False and ev.candidate_version == 2
    assert t.policy.lookup("stream") is None
    assert t.store.current_version() == 1 and t.store.candidate_version() is None
    kinds = [e["kind"] for e in _assert_same_audit(j, t)]
    assert "canary_rejected" in kinds


def test_canary_promotion_arms_then_disarms_guard(tmp_path):
    j, t = _pair(tmp_path, None, canary=True, min_observe_steps=1, cooldown_steps=0,
                 rollback_min_steps=1, rollback_window=4)
    rng = np.random.default_rng(5)
    for _ in range(3):
        _feed(j, t, rng.integers(128, 256, 2048), rng.integers(0, 256, 2048))
    assert [c.retune("stream").promoted for c in (j, t)] == [True, True]
    assert t.store.current_version() == 2 and "stream" in t._guards
    for _ in range(6):
        _feed(j, t, rng.integers(128, 256, 2048), rng.integers(0, 256, 2048))
    assert t._guards == {} == j._guards and t.rollbacks == [] == j.rollbacks
    _assert_same_audit(j, t)


def test_auto_rollback_restores_last_good_bit_identically(tmp_path):
    j, t = _pair(tmp_path, None, canary=True, drift_threshold=10.0, min_observe_steps=1,
                 cooldown_steps=0, rollback_guard=0.5, rollback_min_steps=2,
                 rollback_window=32)
    rng = np.random.default_rng(6)
    for _ in range(4):
        _feed(j, t, rng.integers(0, 64, 2048), rng.integers(0, 64, 2048))
    assert [c.retune("stream").promoted for c in (j, t)] == [True, True]
    expected = TR.SwapPolicy.from_json(t.store.load(1).to_json())
    for _ in range(12):
        _feed(j, t, rng.integers(128, 256, 2048), rng.integers(128, 256, 2048))
        if t.rollbacks:
            break
    assert len(t.rollbacks) == 1 == len(j.rollbacks)
    rb = t.rollbacks[0]
    assert rb["to_version"] == 1 and rb["observed"] > rb["baseline"] * 1.5
    assert t.store.current_version() == 1
    assert t.policy.configs_equal(expected)
    assert t.policy.to_json() == t.store.load(1).to_json()   # byte for byte
    audits = [e for e in _assert_same_audit(j, t) if e["kind"] == "rollback"]
    assert len(audits) == 1 and audits[0]["store_version"] == 1


def test_controller_slo_veto_blocks_canary_promotion(tmp_path):
    j, t = _pair(tmp_path, None, canary=True, decay=0.4, drift_threshold=10.0,
                 min_observe_steps=1, cooldown_steps=0)
    engines = []
    for c, o in ((j, jobs), (t, tobs)):
        eng = o.SLOEngine([o.SLOSpec(
            name="qor_stream", kind="qor", source="stream", threshold=0.0,
            objective=0.1, short_window=4, long_window=4, min_events=2,
            veto_promotion=True)], audit=c.audit)
        c.attach_slo(eng)
        engines.append(eng)
    rng = np.random.default_rng(5)
    for _ in range(4):
        _feed(j, t, rng.integers(128, 256, 2048), rng.integers(0, 256, 2048))
    assert [e.vetoes_promotion() for e in engines] == ["qor_stream"] * 2
    assert [c.retune("stream").promoted for c in (j, t)] == [False, False]
    assert t.policy.lookup("stream") is None and t.store.current_version() == 1
    events = _assert_same_audit(j, t)
    veto = [e for e in events if e["kind"] == "slo_veto"]
    assert veto and veto[0]["vetoed_by"] == "qor_stream"
    assert any(e["kind"] == "slo_alert" for e in events)


def test_poisoned_telemetry_is_quarantined_with_no_retune(tmp_path):
    j, t = _pair(tmp_path, ("A", 3, 0))
    rng = np.random.default_rng(3)
    plans = [o.FaultPlan([o.FaultSpec("controller.observe", "poison_nan", at=k)
                          for k in range(4, 10)]) for o in (jchaos, tchaos)]
    hj, ht = jchaos.install(plans[0]), tchaos.install(plans[1])
    try:
        for _ in range(12):
            _feed(j, t, rng.integers(128, 256, 2048), rng.integers(0, 256, 2048))
    finally:
        jchaos.uninstall()
        tchaos.uninstall()
    assert ht.fired_count("poison_nan") == 6 == hj.fired_count("poison_nan")
    assert t.quarantine.by_reason.get("nonfinite", 0) >= 6 and t.retunes == []
    kinds = [e["kind"] for e in _assert_same_audit(j, t)]
    assert kinds == ["quarantine"] * 6
    snap = t.telemetry.snapshot()["stream"]
    assert np.isfinite(snap["bit_probs"]).all() and np.isfinite(snap["ew_mae"])


def test_retune_stall_site_fires_and_changes_nothing(tmp_path):
    j, t = _pair(tmp_path, None, min_observe_steps=1, cooldown_steps=0)
    rng = np.random.default_rng(8)
    for _ in range(3):
        _feed(j, t, rng.integers(128, 256, 2048), rng.integers(0, 256, 2048))
    with tchaos.active(tchaos.FaultPlan([tchaos.FaultSpec("controller.retune",
                                                          "stall_retune", at=0,
                                                          arg=0.0)])) as h:
        t.retune("stream")
    j.retune("stream")
    assert h.fired_count("stall_retune") == 1
    _assert_same_audit(j, t)


def _phases(rng, n_batches, batch):
    """The three operand regimes of ``benchmarks/adaptive_table.py``."""

    def high_a():
        return rng.integers(128, 256, batch), rng.integers(0, 256, batch)

    def low_a():
        return rng.integers(0, 128, batch), rng.integers(0, 256, batch)

    def gauss():
        a = np.clip(rng.normal(96, 32, batch), 0, 255).astype(np.int64)
        b = np.clip(rng.normal(160, 48, batch), 0, 255).astype(np.int64)
        return a, b

    return [("high_a", high_a, n_batches), ("low_a", low_a, n_batches),
            ("gauss", gauss, n_batches)]


@pytest.mark.parametrize("mname,order,margin,rolls,rejects", [
    ("mul8u_trunc0_4", (0, 1, 2), 0.0, 0, 0),
    ("mul8u_trunc0_4", (2, 1, 0), 0.0, 1, 0),
    ("mul8u_trunc0_4", (2, 1, 0), 0.05, 0, 1),
    ("mul8u_drum3_4", (1, 0, 2), 0.0, 1, 0),
    ("mul8u_drum3_4", (1, 0, 2), 0.05, 0, 2),
    ("mul8u_drum3_4", (1, 0, 1, 0), 0.0, 1, 1),
])
def test_adaptive_table_drift_streams_with_the_canary_equal_jax(tmp_path, mname, order,
                                                                margin, rolls, rejects):
    """The benchmark's drift regimes (its full-size batches and controller
    settings, in its order and in others) with ``canary=True`` and a tight
    guard: the same promotions, rejections and rollbacks, and among the
    cases each outcome at least once."""
    j, t = _pair(tmp_path, ("A", 3, 0), mname=mname, decay=0.3, drift_threshold=0.04,
                 min_observe_steps=2, cooldown_steps=2, canary=True, canary_margin=margin,
                 rollback_min_steps=1, rollback_guard=0.2)
    phases = _phases(np.random.default_rng(0), 12, 4096)
    for i in order:
        _, draw, nb = phases[i]
        for _ in range(nb):
            _feed(j, t, *draw())
    assert len(t.retunes) >= 1
    assert [(e.step, e.promoted, e.candidate_version) for e in t.retunes] == \
        [(e.step, e.promoted, e.candidate_version) for e in j.retunes]
    assert [(r["step"], r["to_version"]) for r in t.rollbacks] == \
        [(r["step"], r["to_version"]) for r in j.rollbacks]
    assert (len(t.rollbacks), sum(not e.promoted for e in t.retunes)) == (rolls, rejects)
    _assert_same_audit(j, t)


def test_dyn_tree_follows_a_promotion_after_a_rejection(tmp_path):
    """After a rejected candidate the next promotion is published under the
    number the reverted policy already carried (the store rewrites the
    version).  The port's controller drops its tensor cache at each of its
    own policy changes, so the served triples follow the promotion; the
    JAX controller caches on the version alone and keeps serving the
    reverted triples (ROADMAP queue 3)."""
    j, t = _pair(tmp_path, None, canary=True, canary_margin=0.5, min_observe_steps=1,
                 cooldown_steps=0)
    rng = np.random.default_rng(4)
    for _ in range(3):
        _feed(j, t, rng.integers(128, 256, 2048), rng.integers(0, 256, 2048))
    for c in (j, t):
        assert c.retune("stream").promoted is False        # v2 rejected
        c.dyn_tree()                                       # cached at the reverted policy
        c.cfg.canary_margin = 0.0
        assert c.retune("stream").promoted is True         # v3 promoted
    assert t.policy.version == j.policy.version == 3
    want = t.policy.dyn_tree(t.targets, device="cpu")["stream"]
    assert t.dyn_tree()["stream"].tolist() == want.tolist() != list(TR.NO_SWAP_TRIPLE)
    assert np.asarray(j.dyn_tree()["stream"]).tolist() == list(TR.NO_SWAP_TRIPLE)  # JAX: stale
    _assert_same_audit(j, t)


# ---------------------------------------------------------------------------
# a writer and a replica over one store, serving on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(reduced(qwen2_72b), n_layers=2, compute_dtype="float32",
                              ax=AxPolicy(backend="kernel"))
    params = init_params(cfg, seed=0, device="cpu")
    prompts = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)))
    return cfg, params, prompts


def _writer(cfg, store, **kw):
    c = dict(min_observe_steps=2, cooldown_steps=2, drift_threshold=0.03, canary=True)
    c.update(kw)
    return TR.AdaptiveController(TR.SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                 TR.AdaptiveConfig(**c), store=store, device="cpu")


def _drift_serve(model, ctrl):
    cfg, params, prompts = model
    return generate(params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=10),
                    adaptive=ctrl, param_hook=drift_hook(3, 0.05))


def test_instrumented_serve_with_an_idle_fault_plan_gives_the_same_tokens(model, tmp_path):
    """A TraceRecorder installed and a FaultPlan armed at every site with
    visits that never come: tokens, re-tunes and audit kinds equal an
    uninstrumented serve's, and the trace holds the serve's spans."""
    runs = []
    for armed in (False, True):
        store = TStore(str(tmp_path / str(armed)))
        ctrl = _writer(model[0], store)
        ctrl.resume_from_store()
        rec, harness = tobs.TraceRecorder(), None
        if armed:
            prev = tobs.install_recorder(rec)
            harness = tchaos.install(tchaos.FaultPlan(
                [tchaos.FaultSpec(s, k, at=10 ** 6) for s, ks in tchaos.SITES.items()
                 for k in ks]))
        try:
            toks = _drift_serve(model, ctrl)
        finally:
            if armed:
                tobs.install_recorder(prev)
                tchaos.uninstall()
        runs.append((toks, [e.describe() for e in ctrl.retunes],
                     [e["kind"] for e in ctrl.audit.read()], rec, harness))
    (t0, r0, k0, _, _), (t1, r1, k1, rec, h) = runs
    assert torch.equal(t0, t1) and r0 == r1 and k0 == k1 and r0
    assert h.fired == [] and h.visits["controller.observe"] == 9
    names = {e["name"] for e in rec.events()}
    assert {"prefill", "decode", "retune", "canary"} <= names


def test_writer_and_replica_over_one_store(model, tmp_path):
    """The writer's drift serve canaries and publishes; a replica polls
    after each publish and serves on the fused path: its tokens under
    version N equal a no-drift controller serve of ``store.load(N)``."""
    cfg, params, prompts = model
    tobs.reset_default_registry()
    store = TStore(str(tmp_path))
    replica = PolicyReader(TStore(str(tmp_path)), cfg.ax.targets, device="cpu")
    assert replica.version == -1 and replica.staleness() == 0
    adopted = []

    def on_log(line):
        if line.startswith("published policy v"):
            lag = replica.staleness()
            assert replica.poll() is True and replica.staleness() == 0
            toks = generate(params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=6),
                            adaptive=replica)
            adopted.append((replica.version, lag, toks))

    ctrl = _writer(cfg, store)
    ctrl._log_fn = on_log
    ctrl.resume_from_store()
    assert replica.poll() is True and replica.version == 1
    _drift_serve(model, ctrl)
    published = [int(line.rsplit("v", 1)[1]) for line in ctrl.log
                 if line.startswith("published policy v")]
    assert published and [v for v, _, _ in adopted] == published
    assert store.current_version() == published[-1]
    for version, lag, toks in adopted:
        assert lag >= 1
        ref = TR.AdaptiveController(store.load(version), cfg.ax.targets,
                                    TR.AdaptiveConfig(drift_threshold=1e9), device="cpu")
        want = generate(params, {"tokens": prompts}, cfg, ServeConfig(max_new_tokens=6),
                        adaptive=ref)
        assert torch.equal(toks, want), version
    adoptions = tobs.default_registry().get("repro_policy_adoptions_total")
    assert adoptions.value(replica="replica") == len(adopted) + 1
