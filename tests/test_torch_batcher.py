"""The port's continuous batcher with a real model, against the JAX
package's batcher and against itself.

The reduced qwen2 with one layer, ``compute_dtype="float32"`` and the
``mxu`` backend, the JAX package's weights (``params_from_jax``); the port
runs on the CPU through the plain kernels.  Against JAX (three JAX drains in
all, in one module fixture): wave static, token static and token adaptive
with a controller that never re-tunes give each request JAX's greedy tokens
exactly (f32 logits agree to 5e-7, ``tests/test_torch_model.py``), and the
adaptive drain's per-request QoR summaries agree to ``QOR_RTOL``, the
tolerance of ``tests/test_torch_obs.py`` (the records are equal, so only
float64 rounding of the same sums may differ).  Inside the port: token ==
wave greedy and sampled, EOS truncation, async == sync admission, load
shedding, queued and decoding deadlines, chaos stalls and crashes, arrival
replay == direct drain, the latency summary and the SLO feed, a
``PolicyReader`` polled per admission, the slot cache kept across drains,
and ``mesh=`` refused.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.models as JM
import repro.runtime as JR
from repro.configs import qwen2_72b as j_qwen2, reduced as j_reduced
from repro.configs.base import AxPolicy as JPolicy
from repro.fleet import (BatcherConfig as JBatcherConfig, ContinuousBatcher as JBatcher,
                         Request as JRequest)
import repro_torch.fleet.scheduler as TS
import repro_torch.runtime as TR
from repro_torch import obs
from repro_torch.configs import qwen2_72b as t_qwen2, reduced as t_reduced
from repro_torch.configs.base import AxPolicy as TPolicy
from repro_torch.convert import params_from_jax
from repro_torch.fleet import (BatcherConfig, ContinuousBatcher, PolicyReader, PolicyStore,
                               Request, chaos, poisson_arrivals)

QOR_RTOL = 1e-12
N_REQ = 8
BUCKETS = (8, 16)
T = 4


def _trace(vocab, n=N_REQ, seed=5):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, vocab, int(rng.integers(2, 17))).astype(np.int32),
             int(rng.integers(1, T + 1))) for rid in range(n)]


@pytest.fixture(scope="module")
def model():
    jc = dataclasses.replace(j_reduced(j_qwen2), n_layers=1, compute_dtype="float32",
                             ax=JPolicy(backend="mxu"))
    tc = dataclasses.replace(t_reduced(t_qwen2), n_layers=1, compute_dtype="float32",
                             ax=TPolicy(backend="mxu"))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.device_get(jp), tc, device="cpu")
    return jc, tc, jp, tp


def _tctrl(tc, **kw):
    kw.setdefault("min_observe_steps", 10 ** 6)
    return TR.AdaptiveController(TR.SwapPolicy.from_ax_policy(tc.ax), tc.ax.targets,
                                 TR.AdaptiveConfig(**kw), device="cpu")


def _serve(bat, trace, req_cls=Request, **req_kw):
    for rid, p, n in trace:
        bat.submit(req_cls(rid, p.copy(), n, **req_kw))
    return bat.run()


def _tokens(done):
    return {c.rid: [int(t) for t in c.tokens] for c in done}


@pytest.fixture(scope="module")
def jax_drains(model):
    """The three JAX drains: wave static, token static, token adaptive."""
    jc, _, jp, _ = model
    trace = _trace(jc.vocab)
    out = {}
    for name, token, adaptive in (("wave", False, False), ("token", True, False),
                                  ("adaptive", True, True)):
        ctrl = (JR.AdaptiveController(JR.SwapPolicy.from_ax_policy(jc.ax),
                                      targets=jc.ax.targets,
                                      cfg=JR.AdaptiveConfig(min_observe_steps=10 ** 6))
                if adaptive else None)
        bat = JBatcher(jp, jc, JBatcherConfig(n_slots=3, prompt_buckets=BUCKETS,
                                              new_token_bucket=T, token_granular=token),
                       adaptive=ctrl)
        out[name] = (_serve(bat, trace, JRequest), bat)
    return out


@pytest.fixture(scope="module")
def port_drains(model):
    _, tc, _, tp = model
    trace = _trace(tc.vocab)
    out = {}
    for name, token, adaptive in (("wave", False, False), ("token", True, False),
                                  ("adaptive", True, True)):
        bat = ContinuousBatcher(tp, tc, BatcherConfig(n_slots=3, prompt_buckets=BUCKETS,
                                                      new_token_bucket=T,
                                                      token_granular=token),
                                adaptive=_tctrl(tc) if adaptive else None)
        out[name] = (_serve(bat, trace), bat)
    return out


def _approx_equal(a, b, path="qor"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _approx_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _approx_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=QOR_RTOL, abs=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("name", ["wave", "token", "adaptive"])
def test_batcher_tokens_match_jax(name, jax_drains, port_drains):
    """Per-request greedy tokens, completion order, statuses, waves/steps
    and stats equal the JAX batcher's."""
    jdone, jbat = jax_drains[name]
    tdone, tbat = port_drains[name]
    assert _tokens(tdone) == _tokens(jdone)
    assert [(c.rid, c.status, c.finish, c.wave, c.bucket, c.corr) for c in tdone] == \
        [(c.rid, c.status, c.finish, c.wave, c.bucket, c.corr) for c in jdone]
    assert tbat.stats == jbat.stats
    assert len(tdone) == N_REQ


def test_adaptive_token_drain_qor_matches_jax(jax_drains, port_drains):
    """Every adaptive token completion carries JAX's QoR summary."""
    jdone, jbat = jax_drains["adaptive"]
    tdone, tbat = port_drains["adaptive"]
    for j, t in zip(jdone, tdone):
        assert t.qor is not None and j.qor is not None
        _approx_equal(t.qor, j.qor)
    assert {c.qor["basis"] for c in tdone} <= {"request", "fleet"}
    assert tbat.qor.finished == jbat.qor.finished == N_REQ
    _approx_equal(tbat.qor.fleet_share(), jbat.qor.fleet_share())
    assert tbat.adaptive.step == jbat.adaptive.step > 0
    assert not tbat.adaptive.retunes and not jbat.adaptive.retunes


def test_token_matches_wave_and_static(port_drains):
    waves = _tokens(port_drains["wave"][0])
    assert _tokens(port_drains["token"][0]) == waves == _tokens(port_drains["adaptive"][0])
    assert port_drains["token"][1].stats["splices"] > 0
    assert all(c.qor is None and c.corr for c in port_drains["wave"][0])
    assert port_drains["token"][1].occupancy() >= port_drains["wave"][1].occupancy()


def _bat(tp, tc, **kw):
    adaptive = kw.pop("adaptive", None)
    base = dict(n_slots=3, prompt_buckets=BUCKETS, new_token_bucket=T)
    base.update(kw)
    return ContinuousBatcher(tp, tc, BatcherConfig(**base), adaptive=adaptive)


def test_sampled_token_equals_wave_and_async_equals_sync(model):
    """temperature 0.8 with per-request seeds: token (sync and async
    admission) == wave; greedy async == sync too."""
    _, tc, _, tp = model
    trace = _trace(tc.vocab, seed=6)
    res = {}
    for temp in (0.0, 0.8):
        for mode in ("wave", "sync", "async"):
            bat = _bat(tp, tc, temperature=temp, seed=3, token_granular=mode != "wave",
                       async_admission=mode == "async")
            res[temp, mode] = _tokens(_serve(bat, trace))
            assert bat.stats["requests"] == N_REQ
    for temp in (0.0, 0.8):
        assert res[temp, "sync"] == res[temp, "wave"] == res[temp, "async"], temp
    assert res[0.8, "wave"] != res[0.0, "wave"]       # sampling bites


def test_eos_truncates_and_token_equals_wave(model, port_drains):
    _, tc, _, tp = model
    trace = _trace(tc.vocab)
    base = _tokens(port_drains["wave"][0])
    eos = next(toks[1] for toks in base.values() if len(toks) > 2)
    got = {}
    for token in (False, True):
        bat = _bat(tp, tc, eos_id=eos, token_granular=token)
        done = _serve(bat, trace)
        got[token] = _tokens(done)
        n_eos = 0
        for c in done:
            full = base[c.rid]
            want = full[:full.index(eos) + 1] if eos in full else full
            assert got[token][c.rid] == want, c.rid
            assert c.finish == ("eos" if eos in full else "length")
            n_eos += c.finish == "eos"
        assert bat.stats["eos_retired"] == n_eos > 0
    assert got[False] == got[True]


def test_shedding_deadlines_and_stall(model):
    _, tc, _, tp = model
    trace = _trace(tc.vocab)
    bat = _bat(tp, tc, token_granular=True, max_queue=5)
    accepted = [bat.submit(Request(rid, p, n)) for rid, p, n in trace]
    assert accepted == [True] * 5 + [False] * 3 and bat.stats["shed"] == 3
    assert len(bat.run()) == 5

    # a lapsed request times out queued; a request whose deadline lapses
    # during a stalled step times out decoding with its partial tokens
    bat = _bat(tp, tc, token_granular=True, n_slots=2)
    bat.submit(Request(0, trace[0][1], T, deadline_s=0.5))
    bat.submit(Request(1, trace[1][1], T))
    bat.submit(Request(2, trace[2][1], 2, deadline_s=0.0))
    plan = chaos.FaultPlan([chaos.FaultSpec("sched.step", "stall_step", at=0, arg=1.0)])
    with chaos.active(plan) as h:
        done = {c.rid: c for c in bat.run()}
    assert h.fired_count("stall_step") == 1
    assert done[2].status == "timeout" and len(done[2].tokens) == 0
    assert done[0].status == "timeout" and done[0].finish == "timeout"
    assert 1 <= len(done[0].tokens) < T
    assert done[1].status == "ok" and len(done[1].tokens) == T
    assert bat.stats["timeouts"] == 2 and bat.stats["decode_retraces_post_warmup"] == 0


@pytest.mark.parametrize("token", [False, True])
def test_crash_supervision_resumes_drain(model, token):
    """An injected replica kill at ``sched.step`` is survived by the
    supervision loop of the serve CLI, and the resumed drain retires every
    request still queued at the kill exactly once.  As in the JAX package,
    the killed drain's completions and the requests in its slots are lost
    with it: in wave mode a kill at the first visit comes before anything is
    popped, so every request retires exactly once."""
    _, tc, _, tp = model
    trace = _trace(tc.vocab)
    bat = _bat(tp, tc, token_granular=token, n_slots=2)
    for rid, p, n in trace:
        bat.submit(Request(rid, p, n))
    plan = chaos.FaultPlan([chaos.FaultSpec("sched.step", "crash_replica",
                                            at=1 if token else 0)])
    done, crashes, queued = [], 0, None
    with chaos.active(plan) as h:
        while True:
            try:
                done.extend(bat.run())
                break
            except chaos.InjectedFault:
                crashes += 1
                queued = {r.rid for q in bat.queues.values() for r in q}
    assert crashes == 1 and h.fired_count("crash_replica") == 1
    rids = [c.rid for c in done]
    assert len(rids) == len(set(rids)) and bat.pending() == 0
    assert queued <= set(rids) <= set(range(N_REQ))
    if not token:
        assert sorted(rids) == list(range(N_REQ))
    else:
        assert len(queued) < N_REQ


def _twin_within_resolution(s, bat, k):
    """The histogram twin ``s[k + "_bucketed"]`` lies in the bucket of the
    order statistic that the histogram reads, the ceil(q * n)-th smallest
    sample (numpy's ``inverted_cdf``), so it is within ``_resolution`` of
    it; and within ``_resolution`` of the interpolated ``s[k]`` too wherever
    the two samples that ``s[k]`` interpolates share that bucket.  Where
    they do not (a gap in wall-clock latencies, as waves land together
    under load), ``s[k]`` lies outside the bucket and no bound holds."""
    fam, q = k.split("_p")
    samples = np.sort([r[fam] for r in bat.request_log if r[fam] is not None])
    q = int(q) / 100.0
    assert s[k] == float(np.percentile(samples, 100 * q))
    res = s[f"{k}_resolution"]
    if res == float("inf"):
        return
    edges = np.asarray(obs.TTFT_BUCKETS if fam == "ttft" else obs.E2E_BUCKETS)
    read = float(np.percentile(samples, 100 * q, method="inverted_cdf"))
    assert abs(s[f"{k}_bucketed"] - read) <= res
    pos = (len(samples) - 1) * q
    lo, hi = samples[int(np.floor(pos))], samples[int(np.ceil(pos))]
    if np.searchsorted(edges, lo, side="left") == np.searchsorted(edges, hi, side="left"):
        assert abs(s[f"{k}_bucketed"] - s[k]) <= res


def test_arrivals_replay_direct_drain_and_latency_summary(model, port_drains):
    """Arrivals at 200 req/s on the wall clock give the direct drain's
    tokens in both modes (the CPU's prefill logits are bit-equal at every
    bucket, so wave composition does not move a token) and a latency
    summary whose histogram twins keep their stated resolution."""
    _, tc, _, tp = model
    trace = _trace(tc.vocab)
    for token in (False, True):
        bat = _bat(tp, tc, token_granular=token)
        eng = obs.SLOEngine(obs.default_serving_slos())
        bat.attach_slo(eng)
        src = poisson_arrivals([Request(rid, p.copy(), n) for rid, p, n in trace], 200.0,
                               seed=0)
        done = bat.run_arrivals(src)
        assert sorted(c.rid for c in done) == list(range(N_REQ))
        assert _tokens(done) == _tokens(port_drains["wave"][0])
        assert eng.events("ttft") == N_REQ and eng.events("e2e") == N_REQ
        s = bat.latency_summary()
        assert s["requests"] == N_REQ and "queue_delay_p99" in s
        for k in ("e2e_p50", "e2e_p99", "ttft_p50", "ttft_p99"):
            assert np.isfinite(s[k]) and f"{k}_bucketed" in s
            _twin_within_resolution(s, bat, k)
        assert "batcher[" + ("token" if token else "wave") + "]" in bat.describe()


def test_policy_reader_is_polled_per_admission(model, port_drains, tmp_path):
    """A replica's ``PolicyReader`` is polled before each admission (token
    mode) and each wave, serves the store's policy, and its steps feed the
    QoR attribution."""
    _, tc, _, tp = model
    store = PolicyStore(str(tmp_path))
    store.publish(TR.SwapPolicy.from_ax_policy(tc.ax))
    trace = _trace(tc.vocab)
    for token in (True, False):
        reader = PolicyReader(store, tc.ax.targets, device="cpu")
        polls = []
        poll = reader.poll
        reader.poll = lambda: polls.append(1) or poll()
        bat = _bat(tp, tc, token_granular=token, adaptive=reader)
        done = _serve(bat, trace)
        assert _tokens(done) == _tokens(port_drains["wave"][0])
        assert len(polls) == (bat.stats["requests"] if token else bat.stats["waves"])
        assert all((c.qor is not None) == token for c in done)


def test_second_drain_reuses_the_slot_cache(model):
    _, tc, _, tp = model
    trace = _trace(tc.vocab)
    bat = _bat(tp, tc, token_granular=True)
    first = _tokens(_serve(bat, trace))
    cache = bat._cache
    ptrs = [t.data_ptr() for layer in cache for t in layer.values()]
    assert [t.device.type for layer in cache for t in layer.values()] == ["cpu"] * 2
    second = _tokens(_serve(bat, [(rid + 100, p, n) for rid, p, n in trace]))
    assert bat._cache is cache
    assert [t.data_ptr() for layer in cache for t in layer.values()] == ptrs
    assert second == {rid + 100: v for rid, v in first.items()}
    assert bat.stats["decode_retraces_post_warmup"] == 0


def test_mesh_and_par_are_refused(model):
    """A mesh needs the adaptive decode and slots that divide over its
    ranks (``ValueError``, where JAX asserts); ``par`` alone is taken."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.sharding import MeshShape

    _, tc, _, tp = model
    with pytest.raises(ValueError, match="requires an adaptive"):
        ContinuousBatcher(tp, tc, BatcherConfig(), mesh=MeshShape(("data",), (2,)))
    ctrl = TR.AdaptiveController(TR.SwapPolicy.from_ax_policy(tc.ax), tc.ax.targets,
                                 device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        ContinuousBatcher(tp, tc, BatcherConfig(n_slots=8), adaptive=ctrl,
                          mesh=MeshShape(("data",), (3,)))
    assert ContinuousBatcher(tp, tc, BatcherConfig(), par=ParallelConfig()).mesh is None
    assert TS.ContinuousBatcher is ContinuousBatcher


def test_prefill_one_over_rows_keeps_the_first(model):
    """``prefill_one(rows=n)`` (the batcher's admission: a wave's prefill
    shape) returns one request's first token and a batch-1 cache, those of
    the same request prefilled in a batch of n."""
    from repro_torch.models import prefill
    from repro_torch.serve import prefill_one

    _, tc, _, tp = model
    p = _trace(tc.vocab)[3][1]
    padded = np.concatenate([p, np.full(16 - len(p), p[-1], np.int32)])[None]
    first, fresh = prefill_one(tp, padded, len(p), tc, max_cache_len=21, rows=3)
    with torch.inference_mode():
        lg, cache = prefill(tp, {"tokens": torch.from_numpy(np.repeat(padded, 3, 0))}, tc,
                            max_cache_len=21, prompt_lens=torch.full((3,), len(p)))
    assert int(first[0]) == int(torch.argmax(lg[0, len(p) - 1]))
    for f, c in zip(fresh, cache):
        assert f["k"].shape[0] == 1 and torch.equal(f["k"], c["k"][:1])
        assert torch.equal(f["v"], c["v"][:1])
