"""The port's continuous batcher against the JAX package's, with no model.

The engine is replaced by deterministic token-stream fakes (the five
module-level engine names of each scheduler are monkeypatched), as in
``tests/test_scheduler_fuzz.py``: a request's stream is a pure function of
(stream key, token index), the key being the request seed when sampling and
the prompt when greedy, so wave and token modes agree and EOS fires on the
small vocabulary.

* the fuzz of ``tests/test_scheduler_fuzz.py`` on the port (25 seeds x 8
  seeded interleavings of submits, partial waves, drains, arrival replays,
  lapsed deadlines and a bounded queue; the same invariants);
* each fuzz schedule through the JAX batcher and the port's, each with its
  fake, on a shared deterministic clock (it advances 1 ms per engine call
  and by each sleep): the completions are equal in order (rid, tokens,
  status, finish, wave/step, bucket, prompt length, corr), the stats are
  equal, and so is the request log but for its walls;
* ``poisson_arrivals`` stamps exactly JAX's timestamps, and the straggler
  watchdog flags exactly JAX's steps on a seeded stream of step times.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.fleet.scheduler as JS
import repro.train.fault as JF
import repro_torch.fleet.scheduler as TS
from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.configs.base import AxPolicy as JPolicy
from repro_torch.configs import qwen2_72b as t_qwen2, reduced as t_reduced
from repro_torch.configs.base import AxPolicy as TPolicy
from repro_torch.fleet import ArrivalSource, BatcherConfig, ContinuousBatcher, Request
from repro_torch.train import StragglerWatchdog

VOCAB = 32
EOS = 5


def _stream_tok(key: int, t: int) -> int:
    return int((key * 1315423911 + (t + 1) * 2654435761) % (2**31)) % VOCAB


def _greedy_key(prompt) -> int:
    return int(np.asarray(prompt, np.int64).sum() * 2654435761 % (2**31))


class _Clock:
    """A deterministic clock for both schedulers' ``time`` module name: it
    advances only by sleeps and by ``tick`` per engine call."""

    def __init__(self, tick: float = 1e-3):
        self.t = 0.0
        self.tick = tick

    def perf_counter(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        # at least 1 us, so a float-rounded remainder still advances time
        self.t += max(float(dt), 1e-6)

    def advance(self) -> None:
        self.t += self.tick


def _wave_rows(batch, lens, seeds, T, eos_id):
    out = np.zeros((batch.shape[0], T), np.int64)
    for b in range(batch.shape[0]):
        skey = int(seeds[b]) if seeds is not None else _greedy_key(batch[b, :lens[b]])
        frozen = None
        for t in range(T):
            nxt = frozen if frozen is not None else _stream_tok(skey, t)
            out[b, t] = nxt
            if eos_id is not None and nxt == eos_id:
                frozen = nxt
    return out


class _PortFake:
    """The port's five engine names (the port's signatures: no PRNG key, no
    ``par``/``mesh``; tensors in and out)."""

    def __init__(self, clock=None):
        self.clock = clock

    def _tick(self):
        if self.clock is not None:
            self.clock.advance()

    def init_cache(self, cfg, B, max_len, device="cuda"):
        return {"skey": np.zeros(B, np.int64), "idx": np.zeros(B, np.int64)}

    def prefill_one(self, params, tokens, length, cfg, *, max_cache_len,
                    temperature=0.0, seed=None, rows=1):
        self._tick()
        assert (seed is not None) == (temperature > 0)
        skey = int(seed) if seed is not None else _greedy_key(np.asarray(tokens)[0, :length])
        return (torch.tensor([_stream_tok(skey, 0)]),
                {"skey": np.asarray([skey], np.int64), "idx": np.asarray([1], np.int64)})

    def splice_slot(self, cache, fresh, slot):
        out = {k: v.copy() for k, v in cache.items()}
        out["skey"][slot] = fresh["skey"][0]
        out["idx"][slot] = fresh["idx"][0]
        return out

    def token_step(self, params, cache, tok, pos, active, cfg, *, temperature=0.0,
                   adaptive=None, gate=True, eos_id=None, seeds=None, nt=None):
        self._tick()
        assert adaptive is None and (seeds is not None) == (temperature > 0)
        tok = tok.numpy().copy()
        act = active.numpy()
        cache = {k: v.copy() for k, v in cache.items()}
        for s in range(len(tok)):
            if act[s]:
                tok[s] = _stream_tok(int(cache["skey"][s]), int(cache["idx"][s]))
                cache["idx"][s] += 1
        return torch.from_numpy(tok), cache

    def generate(self, params, prompt, cfg, scfg, *, adaptive=None, prompt_lens=None,
                 slot_new_tokens=None, slot_seeds=None, max_cache_len=None):
        self._tick()
        assert adaptive is None
        batch = np.asarray(prompt["tokens"])
        lens = (np.asarray(prompt_lens) if prompt_lens is not None
                else np.full(batch.shape[0], batch.shape[1]))
        return torch.from_numpy(_wave_rows(batch, lens, slot_seeds, scfg.max_new_tokens,
                                           scfg.eos_id)).to(torch.int32)


class _JaxFake(_PortFake):
    """The JAX package's engine names, with its signatures."""

    def init_cache(self, cfg, B, max_cache_len):
        return super().init_cache(cfg, B, max_cache_len)

    def prefill_one(self, params, padded, L, cfg, par, max_cache_len, temperature=0.0,
                    key=None, seed=None):
        first, fresh = super().prefill_one(params, np.asarray(padded), L, cfg,
                                           max_cache_len=max_cache_len,
                                           temperature=temperature, seed=seed)
        return first.numpy().astype(np.int32), fresh

    def splice_slot_jit(self, cache, fresh, slot):
        return self.splice_slot(cache, fresh, slot)

    def token_step(self, params, cache, tok, sub, pos, active, cfg, par, temperature=0.0,
                   adaptive=None, mesh=None, gate=False, eos_id=None, seeds=None, nt=None):
        t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
        tok2, cache = super().token_step(params, cache, t(tok), t(pos), t(active), cfg,
                                         temperature=temperature, adaptive=adaptive,
                                         eos_id=eos_id, seeds=t(seeds), nt=t(nt))
        return tok2.numpy(), cache

    def generate(self, params, prompt, cfg, scfg, par=None, adaptive=None, mesh=None,
                 prompt_lens=None, slot_new_tokens=None, max_cache_len=None,
                 slot_seeds=None):
        return super().generate(params, prompt, cfg, scfg, adaptive=adaptive,
                                prompt_lens=prompt_lens, slot_seeds=slot_seeds).numpy()


def _patch_port(monkeypatch, fk):
    for name in ("generate", "prefill_one", "splice_slot", "token_step", "init_cache"):
        monkeypatch.setattr(TS, name, getattr(fk, name))


def _patch_jax(monkeypatch, fk):
    import repro.models

    for name in ("generate", "prefill_one", "splice_slot_jit", "token_step"):
        monkeypatch.setattr(JS, name, getattr(fk, name))
    monkeypatch.setattr(repro.models, "init_cache", fk.init_cache)


@pytest.fixture
def port_fake(monkeypatch):
    fk = _PortFake()
    _patch_port(monkeypatch, fk)
    return fk


def _tiny_cfg():
    return dataclasses.replace(t_reduced(t_qwen2), n_layers=1, ax=TPolicy(backend="mxu"))


def _tiny_jcfg():
    return dataclasses.replace(j_reduced(J_ARCHS["qwen2-72b"]), n_layers=1,
                               ax=JPolicy(backend="mxu"))


def _expected_stream(bat, req):
    key = (bat._request_seed(req) if bat.bcfg.temperature > 0 else _greedy_key(req.tokens))
    ts = [_stream_tok(key, t) for t in range(req.max_new)]
    if bat.bcfg.eos_id is not None and bat.bcfg.eos_id in ts:
        ts = ts[:ts.index(bat.bcfg.eos_id) + 1]
    return ts


def _schedule(rng, mod, cfg):
    """One seeded interleaving (``test_scheduler_fuzz._fuzz_one``) on the
    batcher classes of ``mod``; the draws do not depend on the outcomes,
    so the same seed gives both packages the same schedule."""
    token = bool(rng.integers(2))
    bcfg = mod.BatcherConfig(
        n_slots=int(rng.integers(1, 5)),
        prompt_buckets=(8, 16),
        new_token_bucket=int(rng.integers(2, 7)),
        temperature=float(rng.choice([0.0, 0.8])),
        seed=int(rng.integers(100)),
        token_granular=token,
        max_queue=int(rng.integers(3, 9)),
        eos_id=EOS if rng.integers(2) else None,
        async_admission=bool(rng.integers(2)) and token,
    )
    bat = mod.ContinuousBatcher(None, cfg, bcfg)
    run = dict(bat=bat, accepted={}, rejected=0, expect_timeout=set(), maybe_shed=set(),
               done=[], rid=0)

    def submit_some(n):
        for _ in range(n):
            L = int(rng.integers(2, 17))
            lapsed = rng.integers(4) == 0
            r = mod.Request(run["rid"], rng.integers(0, VOCAB, L).astype(np.int32),
                            max_new=int(rng.integers(1, bcfg.new_token_bucket + 1)),
                            deadline_s=0.0 if lapsed else None)
            if bat.submit(r):
                run["accepted"][r.rid] = r
                if lapsed:
                    run["expect_timeout"].add(r.rid)
            else:
                run["rejected"] += 1
            run["rid"] += 1

    for _ in range(int(rng.integers(2, 6))):
        op = rng.choice(["submit", "step", "drain", "arrivals"])
        if op == "submit":
            submit_some(int(rng.integers(1, 6)))
        elif op == "step" and not token:
            run["done"].extend(bat.step())
        elif op == "drain":
            submit_some(int(rng.integers(0, 4)))
            run["done"].extend(bat.run())
        elif op == "arrivals":
            reqs = []
            for _ in range(int(rng.integers(1, 4))):
                L = int(rng.integers(2, 17))
                r = mod.Request(run["rid"], rng.integers(0, VOCAB, L).astype(np.int32),
                                max_new=int(rng.integers(1, bcfg.new_token_bucket + 1)))
                reqs.append(r)
                run["accepted"][r.rid] = r
                run["maybe_shed"].add(r.rid)
                run["rid"] += 1
            offs = np.cumsum(rng.uniform(0, 2e-3, len(reqs))).tolist()
            run["done"].extend(bat.run_arrivals(mod.ArrivalSource(list(zip(offs, reqs)))))
    run["done"].extend(bat.run())
    return run


def _check_invariants(run):
    bat, done, accepted = run["bat"], run["done"], run["accepted"]
    rejected = run["rejected"]
    bcfg = bat.bcfg
    assert bat.pending() == 0
    assert not bat._order and not bat._submit_t and not bat._corr, "leak"
    rids = [c.rid for c in done]
    assert len(rids) == len(set(rids)), "a request retired twice"
    shed_arrivals = set(accepted) - set(rids)
    assert shed_arrivals <= run["maybe_shed"], "a request was lost"
    assert set(rids) <= set(accepted), "a request was invented"
    for r in shed_arrivals:
        del accepted[r]
    rejected += len(shed_arrivals)
    for r, c in {c.rid: c for c in done}.items():
        assert c.status in ("ok", "timeout")
        assert c.finish in ("length", "eos", "timeout")
        assert (c.status == "timeout") == (c.finish == "timeout")
        if r in run["expect_timeout"]:
            assert c.status == "timeout" and len(c.tokens) == 0
        else:
            assert c.status == "ok"
            expect = _expected_stream(bat, accepted[r])
            assert list(c.tokens) == expect, (r, "stream mismatch")
            assert c.finish == ("eos" if (bcfg.eos_id is not None
                                          and expect[-1] == bcfg.eos_id)
                                else "length")
    assert bat.stats["shed"] == rejected
    assert bat.stats["timeouts"] == sum(1 for c in done if c.status == "timeout")
    assert bat.stats["eos_retired"] == sum(1 for c in done if c.finish == "eos")
    assert bat.stats["requests"] == sum(1 for c in done if c.status == "ok")
    assert len(accepted) + rejected == run["rid"]
    assert sorted(r["rid"] for r in bat.request_log) == sorted(rids)


@pytest.mark.parametrize("seed", range(25))
def test_scheduler_fuzz_interleavings(seed, port_fake):
    """8 schedules per seed x 25 seeds = 200 interleavings on the port."""
    cfg = _tiny_cfg()
    for sub in range(8):
        rng = np.random.default_rng(100_000 * seed + sub)
        try:
            _check_invariants(_schedule(rng, TS, cfg))
        except AssertionError as e:
            raise AssertionError(f"fuzz schedule failed (seed={seed}, sub={sub}): {e}") from e


_WALLS = ("ttft", "e2e", "queue_delay")


def _completion_key(c):
    return (c.rid, [int(t) for t in c.tokens], c.status, c.finish, c.wave, c.bucket,
            c.prompt_len, c.corr, c.qor)


@pytest.mark.parametrize("seed", range(25))
def test_fuzz_schedules_make_the_jax_batchers_decisions(seed, monkeypatch):
    """Each schedule through both batchers on one deterministic clock:
    equal completions in order, equal stats, equal request logs (walls
    aside)."""
    jcfg, tcfg = _tiny_jcfg(), _tiny_cfg()
    for sub in range(8):
        runs = {}
        for name, mod, cfg, fake, patch in (("jax", JS, jcfg, _JaxFake, _patch_jax),
                                            ("port", TS, tcfg, _PortFake, _patch_port)):
            clock = _Clock()
            with monkeypatch.context() as m:
                patch(m, fake(clock))
                m.setattr(mod, "time", clock)
                runs[name] = _schedule(np.random.default_rng(100_000 * seed + sub), mod, cfg)
        j, t = runs["jax"], runs["port"]
        where = f"seed={seed}, sub={sub}"
        assert [_completion_key(c) for c in t["done"]] == \
            [_completion_key(c) for c in j["done"]], where
        assert t["bat"].stats == j["bat"].stats, where
        strip = lambda log: [{k: v for k, v in r.items() if k not in _WALLS}  # noqa: E731
                             for r in log]
        assert strip(t["bat"].request_log) == strip(j["bat"].request_log), where
        assert t["bat"].describe() == j["bat"].describe(), where
        assert t["rejected"] == j["rejected"] and t["rid"] == j["rid"], where


def test_fake_engine_contract(port_fake):
    """Wave and token modes replay the same streams for the same request."""
    cfg = _tiny_cfg()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, VOCAB, int(rng.integers(2, 17))),
                    max_new=int(rng.integers(1, 5))) for i in range(8)]

    def serve(token):
        bat = ContinuousBatcher(None, cfg, BatcherConfig(
            n_slots=3, prompt_buckets=(8, 16), new_token_bucket=4,
            temperature=0.8, eos_id=EOS, token_granular=token, seed=7))
        for r in reqs:
            bat.submit(Request(r.rid, r.tokens.copy(), r.max_new))
        return {c.rid: list(c.tokens) for c in bat.run()}, bat

    wave, _ = serve(False)
    tok, tbat = serve(True)
    assert wave == tok
    assert tbat.stats["eos_retired"] > 0


def test_slot_cache_is_allocated_once_per_batcher(port_fake, monkeypatch):
    """Token mode allocates its slot cache at the first drain and keeps it:
    later drains reuse it (a cache is part of a step graph's identity)."""
    calls = []
    monkeypatch.setattr(TS, "init_cache", lambda *a, **k: calls.append(k) or
                        port_fake.init_cache(*a, **k))
    bat = ContinuousBatcher(None, _tiny_cfg(), BatcherConfig(
        n_slots=2, prompt_buckets=(8,), new_token_bucket=3, token_granular=True))
    for drain in range(3):
        for i in range(3):
            bat.submit(Request(10 * drain + i, np.arange(1, 4 + i), max_new=3))
        assert len(bat.run()) == 3
    assert calls == [{"device": None}]


@pytest.mark.parametrize("rate,seed", [(200.0, 0), (5.0, 3), (1e4, 11)])
def test_poisson_arrivals_match_jax(rate, seed):
    reqs_t = [Request(i, np.arange(3), 1) for i in range(17)]
    reqs_j = [JS.Request(i, np.arange(3), 1) for i in range(17)]
    t = TS.poisson_arrivals(reqs_t, rate, seed=seed)
    j = JS.poisson_arrivals(reqs_j, rate, seed=seed)
    assert [ts for ts, _ in t._items] == [ts for ts, _ in j._items]
    assert [r.rid for _, r in t._items] == [r.rid for _, r in j._items]
    assert len(t) == 17 and isinstance(t, ArrivalSource)
    got = t.poll(t._items[5][0])
    assert [r.rid for r in got] == [r.rid for r in j.poll(j._items[5][0])]
    assert t.next_due() == j.next_due()


@pytest.mark.parametrize("factor,history", [(3.0, 32), (1.5, 8), (2.0, 5)])
def test_straggler_watchdog_matches_jax(factor, history):
    rng = np.random.default_rng(int(factor * 10) + history)
    times = rng.lognormal(-4.0, 0.6, 400)
    times[rng.integers(0, 400, 20)] *= 6.0
    t, j = StragglerWatchdog(factor, history), JF.StragglerWatchdog(factor, history)
    flags_t = [t.observe(float(x)) for x in times]
    flags_j = [j.observe(float(x)) for x in times]
    assert flags_t == flags_j
    assert t.flagged == j.flagged == sum(flags_t) > 0
    assert not any(flags_t[:5])                 # 5 samples before any flag
