"""Whisper, the encoder-decoder, in the port against the JAX package: the
reduced config (2 encoder and 4 decoder layers, d_model 128) with the JAX
package's own initial weights handed over through ``params_from_jax``,
``compute_dtype="float32"``, 24 seeded frame embeddings and 12 tokens,
JAX under ``jax.jit``.

Tolerances (max |logit diff|, logits of order 1), the families' bounds of
``tests/test_torch_families.py``:

* the forward, prefill and three decode steps, on the exact path and with
  the SWAPPER projection (``mxu``, ``mlp`` and ``attn_out``), and the
  prefill cache converted by ``cache_from_jax``: ``TOL_F32 = 1e-5``;
  measured 6.6e-7 in the logits (exact), 3.0e-7 (SWAPPER), 2.6e-6 in the
  caches.  At 24 frames no activation meets an int8 rounding boundary;
* greedy ``generate`` tokens, in bf16 as the serve CLI runs: equal wherever
  JAX's top-2 margin exceeds ``TOL_AX = 0.4``;
* at 2048 frames (two whole 1024-key chunks of the encoder's non-causal
  attention, no padded keys), the exact path to ``TOL_F32`` (measured
  1.5e-6 in the encoder output).  Through the SWAPPER projection the
  encoder's first projection reads 4 codes one step apart, each within
  ``TOL_FLIP = 1e-4`` of a rounding boundary (measured 1.5e-5: the
  attention sums 2048 keys in another order); non-causal attention carries
  each flip to every frame of the next layer and cross-attention to every
  decoder token, so the logits are held to the families' flip bounds
  ``TOL_AX`` and a mean below ``TOL_AX_MEAN = 0.05`` (measured 0.172 and
  0.029; caches relative to their largest magnitude 0.185 and 0.0185).

Beside these: the non-causal chunked attention over keys padded up to a
multiple of ``kv_chunk``, which the JAX package attends to (ROADMAP queue
3) and the port masks, so whisper's 1500 frames agree prefill vs decode; the
refusals (per-slot decode, adaptive serving, which the JAX package fails
on); the serve CLI.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models as JM
from repro.configs.base import AxPolicy as JPolicy
from repro.models import whisper as JW
from repro.models.layers import chunked_attention as j_chunked
from repro.serve.engine import ServeConfig as JServe, generate as j_generate
import repro_torch.configs as TC
from repro_torch.configs.base import AxPolicy as TPolicy
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import decode_step, init_cache, init_params, prefill, whisper
from repro_torch.models.layers import chunked_attention, decode_attention
from repro_torch.serve import ServeConfig, generate

TOL_F32 = 1e-5
TOL_AX, TOL_AX_MEAN = 0.4, 0.05
TOL_FLIP = 1e-4
B, FRAMES, S = 2, 24, 12


def _cfgs(ax=True, dtype="float32"):
    kw = dict(compute_dtype=dtype)
    jc = dataclasses.replace(JC.reduced(JC.ARCHS["whisper-base"]), **kw,
                             ax=JPolicy(backend="mxu") if ax else None)
    tc = dataclasses.replace(TC.reduced(TC.ARCHS["whisper-base"]), **kw,
                             ax=TPolicy(backend="mxu") if ax else None)
    return jc, tc


def _inputs(seed=1, frames=FRAMES):
    rng = np.random.default_rng(seed)
    fr = rng.standard_normal((B, frames, 128)).astype(np.float32)
    tok = rng.integers(0, 512, (B, S)).astype(np.int32)
    return fr, tok


@pytest.fixture(scope="module")
def jparams():
    jc, _ = _cfgs()
    return JM.init_params(jax.random.PRNGKey(0), jc)


def _np(x):
    return x.to(torch.float32).numpy() if torch.is_tensor(x) else \
        np.asarray(jnp.asarray(x).astype(jnp.float32))


def _hold_first_flip(jparams, tp, fr, jc, tc, monkeypatch):
    """The encoder's first approximate projection (layer 1's ``attn_out``)
    reads the same int8 activation codes in both packages, but for codes
    one step apart whose port value ``x / scale`` lies within ``TOL_FLIP``
    of a rounding boundary.  Returns how many codes differ."""
    import repro.quant.ax as JAX_AX
    import repro_torch.quant.ax as T_AX

    jq, tq, jseen, tseen = JAX_AX.quantize_rows, T_AX.quantize_rows, [], []
    traced = []

    def jw(x, axis=-1):
        q, s = jq(x, axis)
        if axis == -1 and not traced:           # the first call of the trace
            traced.append(1)
            jax.debug.callback(lambda q: jseen.append(np.asarray(q)), q, ordered=True)
        return q, s

    def tw(x, axis=-1):
        q, s = tq(x, axis)
        if axis == -1:
            tseen.append((q.numpy().copy(), (x / s).numpy()))
        return q, s

    with monkeypatch.context() as m:
        m.setattr(JAX_AX, "quantize_rows", jw)
        m.setattr(T_AX, "quantize_rows", tw)
        jax.jit(lambda p, f: JW._encode(p, f, jc, None))(jparams, jnp.asarray(fr))
        jax.effects_barrier()
        with torch.inference_mode():
            whisper._encode(tp, torch.from_numpy(fr), tc)
    (tcodes, ratio), jcodes = tseen[0], jseen[0].reshape(tseen[0][0].shape)
    d = jcodes != tcodes
    assert (np.abs(jcodes[d].astype(np.int32) - tcodes[d].astype(np.int32)) == 1).all()
    assert (np.abs(np.abs(ratio[d]) % 1 - 0.5) <= TOL_FLIP).all(), ratio[d]
    return int(d.sum())


@pytest.mark.parametrize("frames", [FRAMES, 2 * 1024])
@pytest.mark.parametrize("ax", [False, True], ids=["exact", "swapper"])
def test_forward_prefill_and_decode_equal_jax(jparams, ax, frames, monkeypatch):
    """At 24 frames, and at 2048: two whole key chunks of the encoder's
    non-causal attention, which the JAX package and the port treat alike
    (no padded keys).  At 2048 frames through the SWAPPER projection the
    first projection's codes flip (module note), and the flips' bounds
    hold."""
    jc, tc = _cfgs(ax)
    tp = params_from_jax(jax.device_get(jparams), tc, device="cpu")
    fr, tok = _inputs(frames=frames)
    flips = ax and frames > FRAMES
    if flips:
        assert _hold_first_flip(jparams, tp, fr, jc, tc, monkeypatch) > 0

    def close(got, want, cache=False):
        got, want = _np(got), _np(want)
        if flips:
            # a cache tensor relative to its largest magnitude above 1, as
            # tests/test_torch_families.py holds caches
            d = np.abs(got - want) / (max(1.0, np.abs(want).max()) if cache else 1.0)
            assert d.max() <= TOL_AX and d.mean() <= TOL_AX_MEAN, (d.max(), d.mean())
        else:
            np.testing.assert_allclose(got, want, atol=TOL_F32, rtol=0)

    jb = {"frames": jnp.asarray(fr), "tokens": jnp.asarray(tok)}
    tb = {"frames": torch.from_numpy(fr), "tokens": torch.from_numpy(tok)}
    jl, _, _ = jax.jit(lambda p, b: JW.forward(p, b, jc, mode="train"))(jparams, jb)
    with torch.inference_mode():
        tl, cache = whisper.forward(tp, tb, tc, mode="train")
    assert cache is None
    close(tl, jl)

    P = S - 3
    jl, jcache = jax.jit(lambda p, b: JM.prefill(p, b, jc, max_cache_len=S + 4))(
        jparams, {"frames": jb["frames"], "tokens": jb["tokens"][:, :P]})
    with torch.inference_mode():
        tl, tcache = prefill(tp, {"frames": tb["frames"], "tokens": tb["tokens"][:, :P]}, tc,
                             max_cache_len=S + 4)
    close(tl, jl)
    conv = cache_from_jax(jax.device_get(jcache), tc, device="cpu")
    assert [sorted(c) for c in tcache] == [["k", "v", "xk", "xv"]] * tc.n_layers
    for got, want in zip(tcache, conv):
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
            close(got[k], want[k], cache=True)
    dec = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jc))
    for i in range(3):
        p = P + i
        jl, jcache = dec(jparams, jcache, jb["tokens"][:, p:p + 1], p)
        with torch.inference_mode():
            tl, tcache = decode_step(tp, tcache, tb["tokens"][:, p:p + 1], p, tc)
        close(tl, jl)


def test_greedy_generate_equals_jax(jparams):
    """bf16, the JAX CLI's frames and 8 decoder tokens, 6 greedy tokens."""
    jc, tc = _cfgs(dtype="bfloat16")
    tp = params_from_jax(jax.device_get(jparams), tc, device="cpu")
    fr, tok = _inputs(seed=3)
    T = 6
    jb = {"frames": jnp.asarray(fr, jnp.bfloat16), "tokens": jnp.asarray(tok[:, :8])}
    jt = np.asarray(j_generate(jparams, jb, jc, JServe(max_new_tokens=T)))
    tt = generate(tp, {"frames": torch.from_numpy(fr).to(torch.bfloat16),
                       "tokens": torch.from_numpy(tok[:, :8])}, tc, ServeConfig(max_new_tokens=T))
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (B, T)
    if np.array_equal(jt, tt.numpy()):
        return
    seq = jnp.concatenate([jb["tokens"], jnp.asarray(jt[:, :-1])], axis=1)
    jl, _ = jax.jit(lambda p, b: JM.prefill(p, b, jc, max_cache_len=8 + T))(
        jparams, {"frames": jb["frames"], "tokens": seq})
    top2 = np.sort(_np(jl)[:, 7:], axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for b in range(B):
        d = np.nonzero(tt[b].numpy() != jt[b])[0]
        if len(d):
            assert margin[b, d[0]] <= TOL_AX, (b, d[0], margin[b, d[0]])


def test_generate_runs_eagerly_and_refuses_what_jax_refuses():
    _, tc = _cfgs()
    tp = init_params(tc, seed=0, device="cpu")
    fr, tok = _inputs()
    prompt = {"frames": torch.from_numpy(fr), "tokens": torch.from_numpy(tok[:, :8])}
    st = {}
    out = generate(tp, prompt, tc, ServeConfig(max_new_tokens=4), stats=st)
    assert tuple(out.shape) == (B, 4) and st["path"] == "eager"
    assert torch.equal(out, generate(tp, prompt, tc, ServeConfig(max_new_tokens=4)))
    for kw in (dict(prompt_lens=[8, 6]), dict(slot_new_tokens=[2, 4]),
               dict(slot_seeds=[1, 2])):
        with pytest.raises(ValueError, match="per-slot decode"):
            generate(tp, prompt, tc, ServeConfig(max_new_tokens=4), **kw)
    with pytest.raises(ValueError, match="per-slot decode"):
        generate(tp, prompt, tc, ServeConfig(max_new_tokens=4, eos_id=3))
    with pytest.raises(ValueError, match="pad-mask"):
        prefill(tp, prompt, tc, max_cache_len=16, prompt_lens=torch.tensor([8, 6]))
    cache = init_cache(tc, B, 16, device="cpu", enc_len=FRAMES)
    assert cache[0]["xk"].shape == (B, FRAMES, tc.n_kv_heads, tc.head_dim_)
    with pytest.raises(ValueError, match="write mask"):
        decode_step(tp, cache, prompt["tokens"][:, :1], 0, tc,
                    write_mask=torch.ones(B, dtype=torch.bool))


def test_adaptive_whisper_is_refused_as_jax_fails_on_it(jparams):
    """The JAX package's adaptive decode leaks an int8 telemetry record out
    of whisper's scan over layers; the port refuses the same call."""
    from repro.runtime import AdaptiveConfig as JAC, AdaptiveController as JA, \
        SwapPolicy as JS
    from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy

    jc, tc = _cfgs()
    fr, tok = _inputs()
    jctl = JA(JS.from_ax_policy(jc.ax), jc.ax.targets, JAC())
    with pytest.raises(jax.errors.UnexpectedTracerError):
        j_generate(jparams, {"frames": jnp.asarray(fr), "tokens": jnp.asarray(tok[:, :8])}, jc,
                   JServe(max_new_tokens=3), adaptive=jctl)
    tp = params_from_jax(jax.device_get(jparams), tc, device="cpu")
    ctl = AdaptiveController(SwapPolicy.from_ax_policy(tc.ax), tc.ax.targets, AdaptiveConfig(),
                             device="cpu")
    with pytest.raises(ValueError, match="JAX package fails"):
        generate(tp, {"frames": torch.from_numpy(fr), "tokens": torch.from_numpy(tok[:, :8])},
                 tc, ServeConfig(max_new_tokens=3), adaptive=ctl)


def test_convert_takes_the_stacked_jax_trees(jparams):
    _, tc = _cfgs()
    np_tree = jax.device_get(jparams)
    tp = params_from_jax(np_tree, tc, device="cpu")
    assert len(tp["layers_enc"]) == tc.n_enc_layers == 2
    assert len(tp["layers_dec"]) == tc.n_layers == 4
    for i in range(tc.n_layers):
        np.testing.assert_array_equal(tp["layers_dec"][i]["xattn"]["q"]["w"].numpy(),
                                      np.asarray(np_tree["layers_dec"]["xattn"]["q"]["w"])[i])
    assert tp["pos_embed"]["w"].shape == (whisper.MAX_DEC_POS, tc.d_model)
    mine = init_params(tc, seed=0, device="cpu")
    assert sorted(_flat(mine)) == sorted(_flat(tp))
    with pytest.raises(ValueError, match="tree keys"):
        params_from_jax({k: v for k, v in np_tree.items() if k != "ln_enc"}, tc, device="cpu")


def _flat(t, pre=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _flat(v, f"{pre}/{k}")
    elif isinstance(t, list):
        for i, v in enumerate(t):
            yield from _flat(v, f"{pre}/{i}")
    else:
        yield pre, tuple(t.shape)


@pytest.mark.parametrize("Sk", [1100, 2048], ids=["padded", "whole"])
def test_noncausal_attention_masks_padded_keys(Sk):
    """Non-causal chunked attention is softmax attention over the real keys
    and agrees with ``decode_attention`` over them.  The JAX package agrees
    where the keys fill whole chunks and attends to the zero padding
    otherwise (whisper's 1500 frames pad to 2048)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 3, 2, 16), generator=g)
    k = torch.randn((1, Sk, 2, 16), generator=g)
    v = torch.randn((1, Sk, 2, 16), generator=g)
    qp = torch.zeros((1, 3), dtype=torch.int64)
    kp = torch.arange(Sk)[None]
    got = chunked_attention(q, k, v, qp, kp, causal=False)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(16)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    dec = decode_attention(q[:, :1], k, v, torch.full((1,), Sk - 1), torch.full((1,), Sk))
    np.testing.assert_allclose(got[:, :1].numpy(), dec.numpy(), atol=1e-5, rtol=0)
    jgot = np.asarray(j_chunked(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                jnp.asarray(v.numpy()), jnp.asarray(qp.numpy()),
                                jnp.asarray(kp.numpy()), causal=False))
    assert (np.abs(jgot - want.numpy()).max() <= 1e-5) == (Sk % 1024 == 0)


def test_serve_cli_serves_whisper(capsys):
    from repro_torch.launch import serve

    out, ctrl = serve.main(["--arch", "whisper-base", "--device", "cpu", "--smoke", "--ax",
                            "--batch", "2", "--prompt-len", "16", "--new-tokens", "3"])
    assert out.shape == (2, 3) and ctrl is None
    assert "arch=whisper-base-smoke generated 6 tokens" in capsys.readouterr().out
    for flag in (["--adaptive"], ["--fleet", "1"]):
        with pytest.raises(SystemExit, match="statically only"):
            serve.main(["--arch", "whisper-base", "--device", "cpu", "--smoke"] + flag)
