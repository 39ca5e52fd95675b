"""The port's MoE, RG-LRU and SSD blocks (``repro_torch.models.blocks``)
against the JAX package's (``repro.models.blocks``), block by block, on the
reduced configs in f32 with the JAX package's own initial weights, inputs
made from a numpy seed and JAX under ``jax.jit``.

Tolerances, stated and measured on these inputs (activations of order 1):

* integer routing — top-k indices, dispatch slots and keeps — is equal, as
  is the dispatch buffer (every kept row is written exactly once);
* MoE output and ``aux``: ``TOL = 1e-5`` (measured at most 6.0e-7);
* RG-LRU train, prefill (an odd length, a nonzero initial state) and three
  decode steps: ``TOL`` on the output and the state (measured at most
  4.2e-7; the port's scan runs JAX's odd/even recursion);
* SSD (one and two chunks, from a nonzero state, three decode steps):
  ``TOL`` relative to the largest magnitude when that exceeds 1 (measured
  at most 1.5e-6 relative, 1.9e-5 absolute on ``h`` of magnitude ~13);
* the causal conv with and without state: ``TOL`` (measured 0).

The blocks run with ``ax=None`` here, the exact projections; which of
their projections go through the SWAPPER path is counted separately
(``test_swapper_projections_of_each_block``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import blocks as JB
import repro_torch.configs as TC
import repro_torch.models.layers as TL
from repro_torch.configs.base import AxPolicy
from repro_torch.convert import _map, _tensor
from repro_torch.models import blocks as TB

TOL = 1e-5
B = 2


def _cfgs(name, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(JC.reduced(JC.ARCHS[name]), **kw),
            dataclasses.replace(TC.reduced(TC.ARCHS[name]), **kw))


def _params(init, jc, seed=0):
    jp = init(jax.random.PRNGKey(seed), jc, jnp.float32)
    return jp, _map(jax.device_get(jp), lambda a: _tensor(a, "cpu"))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(j, t, tol=TOL, rel=False):
    diff = np.abs(_np(j) - _np(t)).max()
    scale = max(1.0, float(np.abs(_np(j)).max())) if rel else 1.0
    assert diff <= tol * scale, (diff, scale)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["no_drops", "drops"])
@pytest.mark.parametrize("name", ["deepseek-moe-16b", "granite-moe-1b-a400m"])
def test_moe_apply_matches_jax(name, case):
    """Routing, dispatch and the combine.  ``drops``: ``moe_capacity`` 1.0
    and a router skewed towards expert 0, so choices beyond an expert's
    capacity are dropped (slot C - 1, keep False)."""
    kw = {"moe_capacity": 1.0} if case == "drops" else {}
    jc, tc = _cfgs(name, **kw)
    jp, tp = _params(JB.moe_init, jc)
    if case == "drops":
        jp["router"]["w"] = jp["router"]["w"].at[:, 0].add(0.3)
        tp["router"]["w"][:, 0] += 0.3
    x = _x((B, 16, jc.d_model), 1)
    flat = x.reshape(-1, jc.d_model)
    T, E, k = flat.shape[0], jc.n_experts, jc.top_k

    logits = jnp.asarray(flat) @ jp["router"]["w"]
    jprobs = jax.nn.softmax(logits, axis=-1)
    jtopv, jtopi = jax.lax.top_k(jprobs, k)
    probs, topv, topi = TB._route(torch.from_numpy(flat), tp["router"]["w"], k)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    C = TB.capacity(T, tc)
    assert C == min(max(int(np.ceil(T * k / E * jc.moe_capacity)), 8), T)
    jbuf, jslots, jkeeps = JB._dispatch(jnp.asarray(flat), jtopi, k, E, C, jnp.float32)
    buf, slots, keeps = TB._dispatch(torch.from_numpy(flat), topi, k, E, C)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
    np.testing.assert_array_equal(keeps.numpy(), np.asarray(jkeeps))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    if case == "drops":
        assert C == 8 and 0 < int((~keeps).sum()) < T * k
    else:
        assert bool(keeps.all())

    jy, jaux = jax.jit(lambda p, v: JB.moe_apply(p, v, jc))(jp, jnp.asarray(x))
    y, aux = TB.moe_apply(tp, torch.from_numpy(x), tc)
    assert tuple(y.shape) == x.shape and y.dtype == torch.float32
    _close(jy, y)
    _close(jaux, aux)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _state(cfg, kind, seed):
    """A nonzero recurrent / SSM state, the same for both packages."""
    if kind == "rec":
        h = _x((B, cfg.d_rnn), seed)
        conv = _x((B, 3, cfg.d_rnn), seed + 1)
    else:
        din = cfg.ssm_expand * cfg.d_model
        H = din // cfg.ssm_head_dim
        h = _x((B, H, cfg.ssm_head_dim, cfg.ssm_state), seed)
        conv = _x((B, 3, din + 2 * cfg.ssm_state), seed + 1)
    return ({"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
            {"h": torch.from_numpy(h.copy()), "conv": torch.from_numpy(conv.copy())})


@pytest.mark.parametrize("S", [1, 2, 13, 32])
def test_rglru_train_matches_jax(S):
    jc, tc = _cfgs("recurrentgemma-2b")
    jp, tp = _params(JB.rglru_init, jc)
    np.testing.assert_array_equal(tp["lam"].numpy(), np.asarray(jp["lam"]))
    x = _x((B, S, jc.d_model), 2)
    jy, jc_ = jax.jit(lambda p, v: JB.rglru_apply(p, v, jc))(jp, jnp.asarray(x))
    y, c = TB.rglru_apply(tp, torch.from_numpy(x), tc)
    assert jc_ is None and c is None
    _close(jy, y)


def test_rglru_prefill_from_a_state_then_decode_matches_jax():
    jc, tc = _cfgs("recurrentgemma-2b")
    jp, tp = _params(JB.rglru_init, jc)
    jcache, tcache = _state(jc, "rec", 3)
    fn = jax.jit(lambda p, v, c: JB.rglru_apply(p, v, jc, c))
    x = _x((B, 13, jc.d_model), 4)
    jy, jcache = fn(jp, jnp.asarray(x), jcache)
    y, tcache = TB.rglru_apply(tp, torch.from_numpy(x), tc, tcache)
    _close(jy, y)
    for k in ("h", "conv"):
        _close(jcache[k], tcache[k])
    for step in range(3):
        xs = _x((B, 1, jc.d_model), 10 + step)
        ptrs = {k: t.data_ptr() for k, t in tcache.items()}
        jy, jcache = fn(jp, jnp.asarray(xs), jcache)
        y, out = TB.rglru_apply(tp, torch.from_numpy(xs), tc, tcache)
        assert out is tcache and {k: t.data_ptr() for k, t in out.items()} == ptrs
        _close(jy, y)
        for k in ("h", "conv"):
            _close(jcache[k], tcache[k])


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 24, 64])
def test_ssd_train_matches_jax(S):
    jc, tc = _cfgs("mamba2-370m")
    jp, tp = _params(JB.ssd_init, jc)
    np.testing.assert_array_equal(tp["a_log"].numpy(), np.asarray(jp["a_log"]))
    x = _x((B, S, jc.d_model), 5)
    jy, _ = jax.jit(lambda p, v: JB.ssd_apply(p, v, jc))(jp, jnp.asarray(x))
    y, c = TB.ssd_apply(tp, torch.from_numpy(x), tc)
    assert c is None
    _close(jy, y, rel=True)


def test_ssd_prefill_over_two_chunks_from_a_state_then_decode_matches_jax():
    jc, tc = _cfgs("mamba2-370m")
    jp, tp = _params(JB.ssd_init, jc)
    jcache, tcache = _state(jc, "ssm", 6)
    fn = jax.jit(lambda p, v, c: JB.ssd_apply(p, v, jc, c))
    x = _x((B, 2 * jc.ssm_chunk, jc.d_model), 7)
    jy, jcache = fn(jp, jnp.asarray(x), jcache)
    y, tcache = TB.ssd_apply(tp, torch.from_numpy(x), tc, tcache)
    _close(jy, y, rel=True)
    for k in ("h", "conv"):
        _close(jcache[k], tcache[k], rel=True)
    for step in range(3):
        xs = _x((B, 1, jc.d_model), 20 + step)
        ptrs = {k: t.data_ptr() for k, t in tcache.items()}
        jy, jcache = fn(jp, jnp.asarray(xs), jcache)
        y, out = TB.ssd_apply(tp, torch.from_numpy(xs), tc, tcache)
        assert out is tcache and {k: t.data_ptr() for k, t in out.items()} == ptrs
        _close(jy, y, rel=True)
        for k in ("h", "conv"):
            _close(jcache[k], tcache[k], rel=True)


def test_ssd_prompt_must_fill_whole_chunks():
    jc, tc = _cfgs("mamba2-370m")
    jp, tp = _params(JB.ssd_init, jc)
    x = _x((1, jc.ssm_chunk + 8, jc.d_model), 8)
    with pytest.raises(AssertionError):
        JB.ssd_apply(jp, jnp.asarray(x), jc)
    with pytest.raises(ValueError, match="chunk"):
        TB.ssd_apply(tp, torch.from_numpy(x), tc)


# ---------------------------------------------------------------------------
# the causal conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 5])
def test_causal_conv_matches_jax(S, with_state):
    x = _x((B, S, 48), 30)
    w = _x((4, 48), 31)
    st = _x((B, 3, 48), 32) if with_state else None
    jy, jst = JB._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              None if st is None else jnp.asarray(st))
    y, nst = TB._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             None if st is None else torch.from_numpy(st))
    _close(jy, y)
    np.testing.assert_array_equal(nst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(nst[:, -1].numpy(), x[:, -1])


# ---------------------------------------------------------------------------
# where the SWAPPER projection sits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", ["moe", "rglru", "ssd"])
def test_swapper_projections_of_each_block(block, monkeypatch):
    """RG-LRU and SSD send ``in``/``gate``/``out`` through ``dense`` with
    target ``mlp`` (3 approximate products), MoE its shared expert's three
    (the routed experts are plain products); SSD's B, C and dt projections
    stay exact."""
    calls = []
    real = TL.ax_dense

    def counting(x, w, policy, wcodes=None):
        calls.append(tuple(w.shape))
        return real(x, w, policy, wcodes=wcodes)

    monkeypatch.setattr(TL, "ax_dense", counting)
    ax = AxPolicy(backend="kernel")
    name, init, apply = {"moe": ("deepseek-moe-16b", TB.moe_init, TB.moe_apply),
                         "rglru": ("recurrentgemma-2b", TB.rglru_init, TB.rglru_apply),
                         "ssd": ("mamba2-370m", TB.ssd_init, TB.ssd_apply)}[block]
    _, tc = _cfgs(name, ax=ax)
    p = init(tc, torch.float32, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(_x((1, 4, tc.d_model), 40))
    with torch.inference_mode():
        y = apply(p, x, tc)[0]
    assert len(calls) == 3 and bool(torch.isfinite(y).all())
    D = tc.d_model
    inner = {"moe": tc.n_shared_experts * tc.moe_d_ff, "rglru": tc.d_rnn,
             "ssd": tc.ssm_expand * D}[block]
    assert sorted(calls) == sorted([(D, inner), (D, inner), (inner, D)])
