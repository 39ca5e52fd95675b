"""Per-slot serving of the port against the JAX package: vector decode
positions, gated cache writes, pad-mask prefill, per-slot budgets, EOS
retirement, per-request sampling streams, and the token-granular API
(``token_step``, ``prefill_one``, ``splice_slot``).

Mirrors ``tests/test_token_granular.py`` and the invariants of
``tests/test_serving_properties.py`` on the reduced qwen2 in f32 with the
JAX package's own weights (``params_from_jax``) and the default ``mxu``
backend.  Tolerances: integer results (tokens, caches written through a
mask) are compared exactly; greedy tokens against JAX exactly (f32 logits
agree to 5e-7, ``tests/test_torch_model.py``, far below every top-2 margin
here); logits against JAX within ``TOL_F32 = 1e-5``; a padded prompt's
logits against the unpadded ones within ``TOL_PAD = 1e-6`` (the CPU's
batched matmuls sum a longer key axis in another order); the port against
itself otherwise bit for bit.  Sampling at temperature > 0 is not JAX's threefry
stream, so it is held to the invariants: deterministic per seed,
splice-invariant, and padded == unpadded per request.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro.configs import qwen2_72b as j_qwen2, reduced as j_reduced
from repro.configs.base import AxPolicy as JPolicy
from repro.serve.engine import ServeConfig as JServe, generate as j_generate
from repro_torch.configs import qwen2_72b as t_qwen2, reduced as t_reduced
from repro_torch.configs.base import AxPolicy as TPolicy
from repro_torch.convert import params_from_jax
from repro_torch.models import decode_step, init_cache, prefill
import repro_torch.runtime as TR
from repro_torch.serve import (ServeConfig, generate, prefill_one, slot_sample, splice_slot,
                               token_step)

TOL_F32 = 1e-5
TOL_PAD = 1e-6


@pytest.fixture(scope="module")
def model():
    jc = dataclasses.replace(j_reduced(j_qwen2), n_layers=2, compute_dtype="float32",
                             ax=JPolicy(backend="mxu"))
    tc = dataclasses.replace(t_reduced(t_qwen2), n_layers=2, compute_dtype="float32",
                             ax=TPolicy(backend="mxu"))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.device_get(jp), tc, device="cpu")
    return jc, tc, jp, tp


def _toks(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# layers: vector cache_index == scalar; write_mask keeps slots inert
# ---------------------------------------------------------------------------

def test_vector_cache_index_matches_scalar(model):
    _, tc, _, tp = model
    B, S = 3, 10
    toks = _t(_toks((B, S), 0))
    t = _t(_toks((B, 1), 1))
    with torch.inference_mode():
        _, c1 = prefill(tp, {"tokens": toks}, tc, max_cache_len=S + 4)
        _, c2 = prefill(tp, {"tokens": toks}, tc, max_cache_len=S + 4)
        l_s, c_s = decode_step(tp, c1, t, S, tc)
        l_v, c_v = decode_step(tp, c2, t, torch.full((B,), S), tc,
                               write_mask=torch.ones(B, dtype=torch.bool))
    assert torch.equal(l_s, l_v)
    for a, b in zip(c_s, c_v):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_vector_positions_match_jax(model):
    """Per-slot positions (each slot at its own length) against JAX's vector
    decode step: logits within TOL_F32, the written cache rows too."""
    jc, tc, jp, tp = model
    B, S = 3, 8
    toks = _toks((B, S), 2)
    lens = np.asarray([8, 5, 3], np.int32)
    pos = lens.copy()
    t = _toks((B, 1), 3)
    _, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, max_cache_len=S + 4,
                           prompt_lens=jnp.asarray(lens))
    jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(t), jnp.asarray(pos), jc,
                                write_mask=jnp.ones((B,), bool))
    with torch.inference_mode():
        _, tcache = prefill(tp, {"tokens": _t(toks)}, tc, max_cache_len=S + 4,
                            prompt_lens=_t(lens))
        tl, tcache = decode_step(tp, tcache, _t(t), _t(pos).long(), tc,
                                 write_mask=torch.ones(B, dtype=torch.bool))
    assert np.abs(np.asarray(jl) - tl.numpy()).max() <= TOL_F32
    jk = np.asarray(jcache["stack"]["p0"]["k"])
    for i, c in enumerate(tcache):
        np.testing.assert_allclose(c["k"].numpy(), jk[i], atol=TOL_F32)


@pytest.mark.parametrize("mask", [[True, False, True], [False, False, True],
                                  [False, False, False]])
def test_write_mask_keeps_retired_slot_cache_inert(model, mask):
    _, tc, _, tp = model
    B, S = 3, 8
    with torch.inference_mode():
        _, cache = prefill(tp, {"tokens": _t(_toks((B, S), 4))}, tc, max_cache_len=S + 4)
        old = [{k: v.clone() for k, v in c.items()} for c in cache]
        m = torch.tensor(mask)
        decode_step(tp, cache, _t(_toks((B, 1), 5)), torch.full((B,), S), tc, write_mask=m)
    for o, n in zip(old, cache):
        for name in ("k", "v"):
            for b in range(B):
                same = torch.equal(o[name][b], n[name][b])
                assert same != mask[b], (name, b)


def test_out_of_range_position_drops_the_write(model):
    _, tc, _, tp = model
    B, S = 2, 6
    with torch.inference_mode():
        _, cache = prefill(tp, {"tokens": _t(_toks((B, S), 6))}, tc, max_cache_len=S + 1)
        old = [{k: v.clone() for k, v in c.items()} for c in cache]
        decode_step(tp, cache, _t(_toks((B, 1), 7)), torch.tensor([S, S + 1]), tc)
    for o, n in zip(old, cache):
        assert torch.equal(o["k"][1], n["k"][1])            # past the ring: dropped
        assert not torch.equal(o["k"][0], n["k"][0])


# ---------------------------------------------------------------------------
# pad-mask prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket", [6, 8, 12, 16])
def test_padmask_prefill_matches_unpadded_at_every_bucket(model, bucket):
    """A padded prompt's logits at its real positions equal the unpadded
    run's to TOL_PAD: the pad keys add exact zeros, but the CPU's batched
    matmuls sum the longer key axis in another order (measured 1.8e-7);
    greedy tokens are held exactly in the generate tests below."""
    _, tc, _, tp = model
    B, L = 2, 5
    prompt = _toks((B, L), 8)
    padded = np.concatenate([prompt, np.repeat(prompt[:, -1:], bucket - L, axis=1)], axis=1)
    lens = torch.full((B,), L)
    with torch.inference_mode():
        ref, _ = prefill(tp, {"tokens": _t(prompt)}, tc, max_cache_len=24, prompt_lens=lens)
        lg, cache = prefill(tp, {"tokens": _t(padded)}, tc, max_cache_len=24, prompt_lens=lens)
        plain, _ = prefill(tp, {"tokens": _t(prompt)}, tc, max_cache_len=24)
    assert (ref - lg[:, :L]).abs().max().item() <= TOL_PAD
    assert torch.equal(ref, plain)


def test_padmask_prefill_matches_jax(model):
    jc, tc, jp, tp = model
    toks = _toks((3, 12), 9)
    lens = np.asarray([4, 12, 9], np.int32)
    jl, _ = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, max_cache_len=20,
                       prompt_lens=jnp.asarray(lens))
    with torch.inference_mode():
        tl, _ = prefill(tp, {"tokens": _t(toks)}, tc, max_cache_len=20, prompt_lens=_t(lens))
    for b, L in enumerate(lens):
        assert np.abs(np.asarray(jl)[b, :L] - tl.numpy()[b, :L]).max() <= TOL_F32


# ---------------------------------------------------------------------------
# generate: per-slot budgets, pad-mask, EOS, against JAX
# ---------------------------------------------------------------------------

def _padded_batch(seed, lens, bucket):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, int(L)).astype(np.int32) for L in lens]
    batch = np.stack([np.concatenate([p, np.full(bucket - len(p), p[-1], np.int32)])
                      for p in prompts])
    return prompts, batch


@pytest.mark.parametrize("eos", [None, "from_run"])
@pytest.mark.parametrize("fused", [True, False])
def test_generate_per_slot_matches_jax_greedy(model, eos, fused):
    """prompt_lens + slot_new_tokens (+ eos_id taken from the run's own
    tokens, so retirement fires): the port's greedy tokens are JAX's."""
    jc, tc, jp, tp = model
    lens = np.asarray([4, 7, 12, 9], np.int32)
    budgets = np.asarray([6, 2, 5, 6], np.int32)
    _, batch = _padded_batch(10, lens, 12)
    T, max_len = 6, 12 + 6 + 1
    eos_id = None
    if eos is not None:
        base = np.asarray(generate(tp, {"tokens": _t(batch)}, tc, ServeConfig(max_new_tokens=T),
                                   prompt_lens=lens, max_cache_len=max_len))
        eos_id = int(base[0, 2])                   # slot 0 emits it at index 2
    jt = np.asarray(j_generate(jp, {"tokens": jnp.asarray(batch)}, jc,
                               JServe(max_new_tokens=T, eos_id=eos_id, fused=fused),
                               prompt_lens=lens, slot_new_tokens=budgets,
                               max_cache_len=max_len))
    tt = generate(tp, {"tokens": _t(batch)}, tc,
                  ServeConfig(max_new_tokens=T, eos_id=eos_id, fused=fused),
                  prompt_lens=lens, slot_new_tokens=budgets, max_cache_len=max_len)
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (4, T)
    np.testing.assert_array_equal(tt.numpy(), jt)
    if eos_id is not None:
        assert (tt[0, 2:] == eos_id).all()                   # frozen at EOS


def test_generate_plain_matches_jax_scalar_path(model):
    jc, tc, jp, tp = model
    toks = _toks((2, 8), 11)
    jt = np.asarray(j_generate(jp, {"tokens": jnp.asarray(toks)}, jc, JServe(max_new_tokens=5)))
    tt = generate(tp, {"tokens": _t(toks)}, tc, ServeConfig(max_new_tokens=5))
    np.testing.assert_array_equal(tt.numpy(), jt)


def test_padmask_generate_matches_unpadded_per_request(model):
    _, tc, _, tp = model
    lens = np.asarray([4, 7, 12, 9], np.int32)
    prompts, batch = _padded_batch(12, lens, 12)
    T, max_len = 6, 12 + 6 + 1
    out = generate(tp, {"tokens": _t(batch)}, tc, ServeConfig(max_new_tokens=T),
                   prompt_lens=lens, max_cache_len=max_len)
    for i, p in enumerate(prompts):
        solo = generate(tp, {"tokens": _t(p[None])}, tc, ServeConfig(max_new_tokens=T),
                        prompt_lens=[len(p)], max_cache_len=max_len)
        assert torch.equal(out[i], solo[0]), i


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_slot_budgets_freeze_and_fused_equals_stepwise(model, temperature):
    _, tc, _, tp = model
    B, S, T = 3, 8, 7
    prompt = {"tokens": _t(_toks((B, S), 13))}
    budgets = np.asarray([2, T, 5], np.int32)
    scfg = ServeConfig(max_new_tokens=T, temperature=temperature, seed=3)
    full = generate(tp, prompt, tc, scfg)
    out_f = generate(tp, prompt, tc, scfg, slot_new_tokens=budgets)
    out_s = generate(tp, prompt, tc, dataclasses.replace(scfg, fused=False),
                     slot_new_tokens=budgets)
    assert torch.equal(out_f, out_s)
    for b in range(B):
        n = int(budgets[b])
        assert torch.equal(out_f[b, :n], full[b, :n]), b           # live prefix
        assert (out_f[b, n:] == out_f[b, n - 1]).all(), b          # frozen tail


def _controller(tc, **kw):
    return TR.AdaptiveController(TR.SwapPolicy.from_ax_policy(tc.ax), tc.ax.targets,
                                 TR.AdaptiveConfig(min_observe_steps=10 ** 6, **kw),
                                 device="cpu")


@pytest.mark.parametrize("tile_rows", [0, 2])
def test_adaptive_fused_with_budgets_matches_stepwise(model, tile_rows):
    """The observe gate stays budget-driven (i < max budget) on both
    schedules: tokens and telemetry equal."""
    _, tc, _, tp = model
    prompt = {"tokens": _t(_toks((2, 8), 14))}
    budgets = np.asarray([3, 5], np.int32)
    cA, cB = _controller(tc, tile_rows=tile_rows), _controller(tc, tile_rows=tile_rows)
    kw = dict(max_new_tokens=7, observe_every=2)
    o_loop = generate(tp, prompt, tc, ServeConfig(fused=False, **kw), adaptive=cA,
                      slot_new_tokens=budgets)
    o_scan = generate(tp, prompt, tc, ServeConfig(fused=True, **kw), adaptive=cB,
                      slot_new_tokens=budgets)
    assert torch.equal(o_loop, o_scan)
    # steps 0..5, gated at 0, 2, 4 by k = 2, and step 4 < max budget 4 fails
    assert cA.step == cB.step == 2
    sA, sB = cA.telemetry.snapshot(), cB.telemetry.snapshot()
    assert set(sA) == set(sB)
    for t in sA:
        for f, v in sA[t].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, sB[t][f])
            else:
                assert v == sB[t][f], (t, f)


def test_adaptive_per_slot_matches_jax(model):
    """The adaptive fused serve with budgets and EOS against JAX's: the same
    greedy tokens and the same number of observed steps."""
    jc, tc, jp, tp = model
    import repro.runtime as JR

    lens = np.asarray([8, 5, 3], np.int32)
    _, batch = _padded_batch(15, lens, 8)
    budgets = np.asarray([5, 3, 5], np.int32)
    jctl = JR.AdaptiveController(JR.SwapPolicy.from_ax_policy(jc.ax), targets=jc.ax.targets,
                                 cfg=JR.AdaptiveConfig(min_observe_steps=10 ** 6))
    tctl = _controller(tc)
    jt = np.asarray(j_generate(jp, {"tokens": jnp.asarray(batch)}, jc,
                               JServe(max_new_tokens=5), adaptive=jctl, prompt_lens=lens,
                               slot_new_tokens=budgets, max_cache_len=14))
    tt = generate(tp, {"tokens": _t(batch)}, tc, ServeConfig(max_new_tokens=5),
                  adaptive=tctl, prompt_lens=lens, slot_new_tokens=budgets, max_cache_len=14)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert tctl.step == jctl.step == 4


# ---------------------------------------------------------------------------
# sampling streams
# ---------------------------------------------------------------------------

def test_slot_sample_is_splice_invariant_and_deterministic():
    rng = np.random.default_rng(16)
    lg = torch.from_numpy(rng.normal(size=(6, 300)).astype(np.float32))
    seeds = torch.tensor([3, 3, 9, 11, 3, 7])
    nt = torch.tensor([0, 1, 0, 5, 0, 2])
    a = slot_sample(lg, seeds, nt, 0.9)
    perm = torch.tensor([4, 2, 0, 5, 1, 3])
    b = slot_sample(lg[perm], seeds[perm], nt[perm], 0.9)
    assert torch.equal(a[perm], b)                       # any batch arrangement
    assert torch.equal(a, slot_sample(lg, seeds, nt, 0.9))
    assert a[0] == a[4]                                   # same (row, seed, index)
    one = torch.stack([slot_sample(lg[i:i + 1], seeds[i:i + 1], nt[i:i + 1], 0.9)[0]
                       for i in range(6)])
    assert torch.equal(a, one)
    # greedy is argmax, first maximum winning
    tie = torch.zeros((2, 5))
    tie[0, 3] = tie[0, 1] = 1.0
    assert slot_sample(tie, None, None, 0.0).tolist() == [1, 0]


def test_slot_sample_follows_the_distribution():
    """Gumbel-max draws are softmax samples: frequencies over many token
    indices within 3 sigma of the probabilities."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    n = 4000
    draws = torch.stack([slot_sample(logits, torch.tensor([5]), torch.tensor([t]), 1.0)[0]
                         for t in range(n)])
    p = torch.softmax(logits[0], dim=0)
    freq = torch.bincount(draws, minlength=4).float() / n
    sigma = torch.sqrt(p * (1 - p) / n)
    assert ((freq - p).abs() <= 3 * sigma + 1e-9).all(), (freq, p)


def test_sampled_generate_is_deterministic_and_splice_invariant(model):
    _, tc, _, tp = model
    lens = np.asarray([4, 7, 10], np.int32)
    prompts, batch = _padded_batch(17, lens, 10)
    seeds = np.asarray([101, 202, 303], np.int32)
    scfg = ServeConfig(max_new_tokens=6, temperature=1.0)
    out = generate(tp, {"tokens": _t(batch)}, tc, scfg, prompt_lens=lens, slot_seeds=seeds,
                   max_cache_len=17)
    again = generate(tp, {"tokens": _t(batch)}, tc, scfg, prompt_lens=lens, slot_seeds=seeds,
                     max_cache_len=17)
    assert torch.equal(out, again)
    for i, p in enumerate(prompts):                      # served alone, unpadded
        solo = generate(tp, {"tokens": _t(p[None])}, tc, scfg, prompt_lens=[len(p)],
                        slot_seeds=seeds[i:i + 1], max_cache_len=17)
        assert torch.equal(out[i], solo[0]), i
    other = generate(tp, {"tokens": _t(batch)}, tc, scfg, prompt_lens=lens,
                     slot_seeds=seeds + 1, max_cache_len=17)
    assert not torch.equal(out, other)


# ---------------------------------------------------------------------------
# token-granular API: token_step + prefill_one + splice_slot vs the wave oracle
# ---------------------------------------------------------------------------

def _trace(n, seed, max_new=6):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, 512, int(rng.integers(3, 17))).astype(np.int32),
             int(rng.integers(1, max_new + 1)), 1000 + rid) for rid in range(n)]


def _bucket(n, buckets=(8, 16)):
    return min(b for b in buckets if b >= n)


def _token_drain(tp, tc, trace, *, n_slots=3, T=6, eos=None, temperature=0.0,
                 adaptive=None):
    """A minimal token-granular batcher: prefill_one + splice_slot into
    free slots at step boundaries, token_step over the slot batch."""
    max_len = 16 + T + 1
    cache = init_cache(tc, n_slots, max_len, device="cpu")
    queue = list(trace)
    state = [None] * n_slots
    pos, tok, nt, seeds = (np.zeros(n_slots, np.int64) for _ in range(4))
    done, stats = {}, {"splices": 0, "steps": 0}

    def fill(mid_flight):
        for s in range(n_slots):
            while state[s] is None and queue:
                rid, p, max_new, seed = queue.pop(0)
                padded = np.concatenate([p, np.full(_bucket(len(p)) - len(p), p[-1])])
                first, fresh = prefill_one(tp, padded[None], len(p), tc, max_cache_len=max_len,
                                           temperature=temperature,
                                           seed=seed if temperature > 0 else None)
                splice_slot(cache, fresh, s)
                first = int(first[0])
                state[s] = dict(rid=rid, left=max_new - 1, toks=[first])
                pos[s], tok[s], nt[s], seeds[s] = len(p), first, 1, seed
                stats["splices"] += int(mid_flight)
                if state[s]["left"] == 0 or (eos is not None and first == eos):
                    done[rid] = state[s]["toks"]
                    state[s] = None

    fill(False)
    while any(st is not None for st in state):
        active = np.asarray([st is not None for st in state])
        out = token_step(tp, cache, _t(tok), _t(pos), _t(active), tc, temperature=temperature,
                         adaptive=adaptive, eos_id=eos,
                         seeds=_t(seeds) if temperature > 0 else None,
                         nt=_t(nt) if temperature > 0 else None)
        if adaptive is not None:
            tok_d, cache, rec = out
            adaptive.observe(TR.telemetry.records_to_host(rec))
        else:
            tok_d, cache = out
        tok = tok_d.numpy().copy()
        pos += active
        nt += active
        stats["steps"] += 1
        for s in range(len(state)):
            st = state[s]
            if st is None:
                continue
            st["toks"].append(int(tok[s]))
            st["left"] -= 1
            if st["left"] == 0 or (eos is not None and int(tok[s]) == eos):
                done[st["rid"]] = st["toks"]
                state[s] = None
        fill(True)
    return done, stats


def _wave_oracle(tp, tc, trace, *, T=6, eos=None, temperature=0.0):
    """Every request of the trace in one wave: pad-mask prefill at the
    largest bucket, per-slot budgets; each row cut at its budget and at its
    first EOS (kept)."""
    lens = np.asarray([len(p) for _, p, _, _ in trace], np.int32)
    batch = np.stack([np.concatenate([p, np.full(16 - len(p), p[-1])]) for _, p, _, _ in trace])
    out = generate(tp, {"tokens": _t(batch)}, tc,
                   ServeConfig(max_new_tokens=T, eos_id=eos, temperature=temperature),
                   prompt_lens=lens, slot_new_tokens=[m for _, _, m, _ in trace],
                   slot_seeds=[s for *_, s in trace], max_cache_len=16 + T + 1).numpy()
    res = {}
    for row, (rid, _, max_new, _) in zip(out, trace):
        toks = row[:max_new].tolist()
        if eos is not None and eos in toks:
            toks = toks[:toks.index(eos) + 1]
        res[rid] = toks
    return res


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_token_granular_matches_wave_oracle(model, temperature):
    _, tc, _, tp = model
    trace = _trace(7, 18)
    tok, stats = _token_drain(tp, tc, trace, temperature=temperature)
    wave = _wave_oracle(tp, tc, trace, temperature=temperature)
    assert stats["splices"] > 0                          # admission mid-flight
    assert tok == wave


def test_token_granular_eos_matches_wave_oracle_and_truncates_at_first_eos(model):
    _, tc, _, tp = model
    trace = _trace(6, 19)
    plain = _wave_oracle(tp, tc, trace)
    eos = plain[0][1]                                    # request 0's second token
    tok, _ = _token_drain(tp, tc, trace, eos=eos)
    wave = _wave_oracle(tp, tc, trace, eos=eos)
    assert tok == wave
    for rid, toks in tok.items():
        assert toks == plain[rid][:len(toks)]            # a prefix of the no-EOS stream
        if eos in toks:
            assert toks.index(eos) == len(toks) - 1
        else:
            assert len(toks) == len(plain[rid])


def test_token_granular_matches_jax_greedy(model):
    """The token-granular drain gives JAX's greedy per-request tokens (JAX's
    generate over the trace as one wave)."""
    jc, tc, jp, tp = model
    trace = _trace(5, 20)
    tok, _ = _token_drain(tp, tc, trace)
    lens = np.asarray([len(p) for _, p, _, _ in trace], np.int32)
    batch = np.stack([np.concatenate([p, np.full(16 - len(p), p[-1])]) for _, p, _, _ in trace])
    jt = np.asarray(j_generate(jp, {"tokens": jnp.asarray(batch)}, jc, JServe(max_new_tokens=6),
                               prompt_lens=lens,
                               slot_new_tokens=np.asarray([m for _, _, m, _ in trace], np.int32),
                               max_cache_len=23))
    for row, (rid, _, max_new, _) in zip(jt, trace):
        assert tok[rid] == row[:max_new].tolist(), rid


def test_token_step_adaptive_records_only_when_gated(model):
    _, tc, _, tp = model
    ctrl = _controller(tc)
    B, S = 2, 6
    with torch.inference_mode():
        _, cache = prefill(tp, {"tokens": _t(_toks((B, S), 21))}, tc, max_cache_len=S + 3)
    tok = torch.tensor([1, 2])
    pos = torch.full((B,), S)
    active = torch.tensor([True, False])
    t1, cache, rec = token_step(tp, cache, tok, pos, active, tc, adaptive=ctrl, gate=True)
    assert rec is not None and "mlp" in rec and int(t1[1]) == 2      # inactive slot frozen
    _, _, rec = token_step(tp, cache, t1, pos + 1, active, tc, adaptive=ctrl, gate=False)
    assert rec is None


def test_token_step_and_prefill_one_need_seeds_to_sample(model):
    _, tc, _, tp = model
    cache = init_cache(tc, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        token_step(tp, cache, torch.tensor([1]), torch.tensor([0]), torch.tensor([True]), tc,
                   temperature=1.0)
    with pytest.raises(ValueError, match="seed"):
        prefill_one(tp, _toks((1, 4), 22), 4, tc, max_cache_len=8, temperature=1.0)


def test_splice_slot_writes_one_row_in_place(model):
    _, tc, _, tp = model
    cache = init_cache(tc, 3, 12, device="cpu")
    ptrs = [c["k"].data_ptr() for c in cache]
    _, fresh = prefill_one(tp, _toks((1, 8), 23), 5, tc, max_cache_len=12)
    splice_slot(cache, fresh, torch.tensor(1))
    for c, f, p in zip(cache, fresh, ptrs):
        assert c["k"].data_ptr() == p
        assert torch.equal(c["k"][1], f["k"][0]) and not c["k"][0].any() and not c["k"][2].any()
    splice_slot(cache, fresh, 2)
    assert torch.equal(cache[0]["v"][2], fresh[0]["v"][0])
