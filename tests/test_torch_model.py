"""The port's dense decoder and serving loop against the JAX package on the
reduced qwen2 (2 layers, SWAPPER ``backend="kernel"``), with the JAX
package's own initial weights handed over through ``params_from_jax``.

Tolerances (measured on these inputs, max |logit diff|, logits of order 1):

* ``compute_dtype="float32"``: measured 5e-7; stated ``TOL_F32 = 1e-5``.
  The ax projections are bit-identical; only f32 rounding in norms,
  attention and the exact projections differs.
* ``compute_dtype="bfloat16"``: measured max 0.17-0.21 over three seeds
  (prefill), mean 0.03 (prefill) and 0.05 (teacher-forced decode).  XLA keeps some
  bf16 intermediates in f32 and expands sigmoid its own way, so activations
  differ in the last bf16 bit here and there; int8 re-quantization of a row
  turns such a bit into a different code and the coarse approximate
  multiplier amplifies it (with ``ax=None`` the same model agrees to 0.01).
  Stated ``TOL_BF16 = 0.4`` and a mean |diff| below ``TOL_BF16_MEAN = 0.1``.

Greedy tokens must be equal wherever JAX's top-2 logit margin exceeds the
tolerance; after the first permitted divergence a row's histories differ
and its later tokens are not compared.
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
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.serve import ServeConfig, generate

TOL_F32 = 1e-5
TOL_BF16 = 0.4
TOL_BF16_MEAN = 0.1
TOL = {"float32": TOL_F32, "bfloat16": TOL_BF16}
B, S, T = 2, 8, 5


def _cfgs(dtype):
    jc = dataclasses.replace(j_reduced(j_qwen2), n_layers=2, compute_dtype=dtype,
                             ax=JPolicy(backend="kernel"))
    tc = dataclasses.replace(t_reduced(t_qwen2), n_layers=2, compute_dtype=dtype,
                             ax=TPolicy(backend="kernel"))
    return jc, tc


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    dtype = request.param
    jc, tc = _cfgs(dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.device_get(jp), tc, device="cpu")
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S)).astype(np.int32)
    return dtype, jc, tc, jp, tp, toks


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not torch.is_tensor(x) \
        else x.to(torch.float32).numpy()


def _assert_close(dtype, j, t):
    diff = np.abs(_f32(j) - _f32(t))
    assert diff.max() <= TOL[dtype], diff.max()
    if dtype == "bfloat16":
        assert diff.mean() <= TOL_BF16_MEAN, diff.mean()


def test_params_from_jax_unstacks_layers(pair):
    _, jc, tc, jp, tp, _ = pair
    assert len(tp["layers"]) == tc.n_layers
    stacked = jax.device_get(jp)["layers"]["p0"]
    for i, lp in enumerate(tp["layers"]):
        np.testing.assert_array_equal(lp["mlp"]["gate"]["w"].numpy(),
                                      np.asarray(stacked["mlp"]["gate"]["w"])[i])
        np.testing.assert_array_equal(lp["attn"]["q"]["b"].numpy(),
                                      np.asarray(stacked["attn"]["q"]["b"])[i])
    assert tuple(tp["lm_head"]["w"].shape) == (tc.vocab, tc.d_model)


def test_prefill_logits_and_cache(pair):
    dtype, jc, tc, jp, tp, toks = pair
    jl, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, max_cache_len=S + T + 1)
    with torch.inference_mode():
        tl, tcache = prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                             max_cache_len=S + T + 1)
    assert tl.dtype == getattr(torch, dtype) and tuple(tl.shape) == jl.shape
    _assert_close(dtype, jl, tl)
    jk = np.asarray(jcache["stack"]["p0"]["k"].astype(jnp.float32))
    for i, c in enumerate(tcache):
        assert tuple(c["k"].shape) == jk.shape[1:]
        assert not c["k"][:, S:].any()                      # padded tail
        if dtype == "float32":
            np.testing.assert_allclose(c["k"].numpy(), jk[i], atol=TOL_F32)


def test_decode_teacher_forced(pair):
    """Decode steps fed the JAX tokens give the same logits."""
    dtype, jc, tc, jp, tp, toks = pair
    jt = np.asarray(j_generate(jp, {"tokens": jnp.asarray(toks)}, jc,
                               JServe(max_new_tokens=T)))
    L = S + T + 1
    _, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, max_cache_len=L)
    with torch.inference_mode():
        _, tcache = prefill(tp, {"tokens": torch.from_numpy(toks)}, tc, max_cache_len=L)
        for i in range(T - 1):
            step = jt[:, i:i + 1]
            jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(step), jnp.int32(S + i), jc)
            tl, tcache = decode_step(tp, tcache, torch.from_numpy(step), S + i, tc)
            assert tuple(tl.shape) == (B, 1, tc.vocab)
            _assert_close(dtype, jl, tl)


def test_greedy_tokens_agree_where_margin_exceeds_tolerance(pair):
    dtype, jc, tc, jp, tp, toks = pair
    jt = np.asarray(j_generate(jp, {"tokens": jnp.asarray(toks)}, jc,
                               JServe(max_new_tokens=T)))
    tt = generate(tp, {"tokens": torch.from_numpy(toks)}, tc, ServeConfig(max_new_tokens=T))
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (B, T)
    # JAX's logits along its own tokens: the margins its choices had
    seq = np.concatenate([toks, jt[:, :-1]], axis=1)
    jl, _ = JM.prefill(jp, {"tokens": jnp.asarray(seq)}, jc, max_cache_len=S + T)
    lg = _f32(jl)[:, S - 1:]
    top2 = np.sort(lg, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    compared = 0
    for b in range(B):
        for t in range(T):
            if tt[b, t].item() != jt[b, t]:
                assert margin[b, t] <= TOL[dtype], (b, t, margin[b, t])
                break
            compared += 1
    if dtype == "float32":
        assert compared == B * T


def test_sampling_is_deterministic_per_seed():
    _, tc = _cfgs("float32")
    tp = init_params(tc, seed=2, device="cpu")
    toks = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(0, tc.vocab, (B, S)))}
    runs = [generate(tp, toks, tc, ServeConfig(max_new_tokens=T, temperature=1.0, seed=s))
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < tc.vocab


def test_entry_points_default_to_cuda():
    """Without ``device=`` the entry points allocate on the card: on a host
    without one they raise instead of running on the CPU."""
    _, tc = _cfgs("float32")
    if torch.cuda.is_available():
        assert init_cache(tc, 1, 4)[0]["k"].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            init_cache(tc, 1, 4)
        with pytest.raises((RuntimeError, AssertionError)):
            init_params(tc)
    cache = init_cache(tc, 1, 4, device="cpu")
    assert len(cache) == tc.n_layers and tuple(cache[0]["v"].shape) == (1, 4, 1, 32)
