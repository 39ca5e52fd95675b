"""Recurrent and SSM state through the serving paths of the port, against
the JAX package (the companion of ``tests/test_torch_families.py``, whose
configs and tolerances it uses): per-slot budgets on recurrentgemma (a
retired slot's state advances, only attention writes are gated),
``splice_slot`` and ``token_step`` over recurrent and SSM caches, and the
continuous batcher on a hybrid stack (waves without the pad mask; token
mode refused).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro.fleet import BatcherConfig as JBatcherConfig, ContinuousBatcher as JBatcher
from repro.fleet import Request as JRequest
from repro.serve.engine import ServeConfig as JServe, generate as j_generate
from repro.serve.engine import splice_slot as j_splice
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.fleet import BatcherConfig, ContinuousBatcher, Request
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.serve import ServeConfig, generate, splice_slot, token_step
from test_torch_families import B, T, TOL_F32, TOL_SSM, _cfgs, _close


def test_budgets_on_a_recurrent_stack_equal_jax():
    """Per-slot budgets need no pad mask: on recurrentgemma both packages
    serve them, a retired slot's recurrent state advancing (only attention
    writes are gated), and give the same tokens."""
    jc, tc = _cfgs("recurrentgemma-2b")
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.device_get(jp), tc, device="cpu")
    toks = np.random.default_rng(3).integers(0, jc.vocab, (B, 12)).astype(np.int32)
    budgets = np.array([T, 2], np.int32)
    jt = np.asarray(j_generate(jp, {"tokens": jnp.asarray(toks)}, jc,
                               JServe(max_new_tokens=T), slot_new_tokens=jnp.asarray(budgets)))
    tt = generate(tp, {"tokens": torch.from_numpy(toks)}, tc, ServeConfig(max_new_tokens=T),
                  slot_new_tokens=budgets)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert (tt[1, 2:] == tt[1, 1]).all()


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "mamba2-370m"])
def test_splice_slot_copies_recurrent_and_ssm_state(name):
    """``splice_slot`` writes a batch-1 cache (attention rows, ring rows,
    ``h`` and ``conv``) into one row of a slot-batched cache, as JAX's does,
    and leaves the other rows alone (the caches meet no code flip: held to
    the exact path's bounds, relative, measured 6.8e-7); a ``token_step``
    over the spliced cache equals ``decode_step``."""
    jc, tc = _cfgs(name)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.device_get(jp), tc, device="cpu")
    L, S = 24, 16
    toks = np.random.default_rng(4).integers(0, jc.vocab, (1, S)).astype(np.int32)
    _, jfresh = jax.jit(lambda p, b: JM.prefill(p, b, jc, max_cache_len=L))(
        jp, {"tokens": jnp.asarray(toks)})
    jbig = JM.init_cache(jc, 4, L)
    jbig = j_splice(jbig, jfresh, 2)
    with torch.inference_mode():
        _, fresh = prefill(tp, {"tokens": torch.from_numpy(toks)}, tc, max_cache_len=L)
        big = init_cache(tc, 4, L, device="cpu")
        ptrs = [t.data_ptr() for c in big for t in c.values()]
        splice_slot(big, fresh, torch.tensor(2))
    assert [t.data_ptr() for c in big for t in c.values()] == ptrs
    for a, b, f in zip(cache_from_jax(jax.device_get(jbig), tc, device="cpu"), big, fresh):
        for k in a:
            _close(a[k], b[k], TOL_SSM if tc.family == "ssm" else TOL_F32, rel=True)
            assert torch.equal(b[k][2], f[k][0].to(b[k].dtype))
            assert not b[k][[0, 1, 3]].any()
    tok = torch.tensor([0, 0, 5, 0])
    pos = torch.tensor([0, 0, S, 0])
    active = torch.tensor([False, False, True, False])
    ref = [{k: v.clone() for k, v in c.items()} for c in big]
    with torch.inference_mode():
        got, _ = token_step(tp, big, tok, pos, active, tc)
        lg, _ = decode_step(tp, ref, tok[:, None], pos, tc, write_mask=active)
    assert int(got[2]) == int(torch.argmax(lg[2, -1]))


def test_batcher_on_a_hybrid_stack_waves_without_pad_mask_and_refuses_token_mode():
    """The continuous batcher on recurrentgemma: wave mode serves with the
    pad mask dropped (each wave's prompts are left as they are), both
    packages give the same tokens per request; token mode asserts in both."""
    jc, tc = _cfgs("recurrentgemma-2b")
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.device_get(jp), tc, device="cpu")
    rng = np.random.default_rng(9)
    trace = [(rid, rng.integers(0, jc.vocab, 8).astype(np.int32), 3) for rid in range(5)]
    kw = dict(n_slots=2, prompt_buckets=(8,), new_token_bucket=3)
    jbat = JBatcher(jp, jc, JBatcherConfig(**kw))
    tbat = ContinuousBatcher(tp, tc, BatcherConfig(**kw))
    assert not jbat.padmask and not tbat.padmask
    for rid, p, n in trace:
        jbat.submit(JRequest(rid, p, max_new=n))
        tbat.submit(Request(rid, p, max_new=n))
    jd = {c.rid: list(c.tokens) for c in jbat.run()}
    td = {c.rid: list(c.tokens) for c in tbat.run()}
    assert jd == td and len(td) == len(trace)
    with pytest.raises(AssertionError, match="token-granular"):
        JBatcher(jp, jc, JBatcherConfig(token_granular=True, **kw))
    with pytest.raises(AssertionError, match="token-granular"):
        ContinuousBatcher(tp, tc, BatcherConfig(token_granular=True, **kw))
