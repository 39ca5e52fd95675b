"""Every decoder-only family of the port against the JAX package: the
reduced configs of gemma3-27b (5 local : 1 global, a ring cache; 7 layers
here, one full period and a rest layer), starcoder2-15b (gelu MLP with
biases), qwen1.5-110b, qwen2-vl-72b (M-RoPE, ``embeds``/``pos`` prompts),
deepseek-moe-16b (a dense_ffn layer, then MoE with a shared expert),
granite-moe-1b-a400m (MoE, tied embeddings), recurrentgemma-2b (RG-LRU +
local attention) and mamba2-370m (SSD), with the JAX package's own initial
weights handed over through ``params_from_jax`` and
``compute_dtype="float32"``.  JAX runs under ``jax.jit`` (the port follows
the jitted quantization, ``quant/ax.py::quantize_rows``).

Tolerances (max |logit diff|, logits of order 1):

* the exact path (``ax=None``), forward, prefill, the prefill cache
  converted by ``cache_from_jax``, three teacher-forced decode steps and
  the caches after them: stated ``TOL_F32 = 1e-5``, for a cache tensor
  relative to its largest magnitude when that exceeds 1; measured at most
  1.4e-6 in the logits and 1.5e-6 relative in the caches on seven
  families.  mamba2's chunked scan sums in another order than XLA's
  einsums: stated ``TOL_SSM = 5e-5``, measured 8.6e-6 (decode logits)
  and 4.6e-5 absolute on an SSD state of magnitude ~15.
* with the SWAPPER projection (the default ``backend="mxu"``, ``mlp`` and
  ``attn_out``: JAX's int8 ``dot_general`` over the K-stacked limbs, the
  port's limbs and integer matmul on the CPU, bit-equal per
  ``tests/test_torch_mxu.py``): six families agree to 5.4e-7 and are held
  to ``TOL_F32``.  In gemma3 and mamba2 an activation in which XLA's fused
  transcendental and PyTorch's differ in the last bit sits on an int8
  rounding boundary; re-quantization turns it into another code, the
  coarse multiplier moves that token, and attention or the SSD state
  carries it to the later tokens of its row (measured: gemma3 0.16 from
  one flip at token 40 of row 1, mean 5.9e-3; mamba2 8.6e-3 from token 27
  of row 1).  For these two (``FLIPS``) the test shows the flip itself:
  the logits differ beyond ``TOL_F32`` in one row only, from one token on,
  and everything else agrees to ``TOL_F32``; the rest is held to the
  bounds of the bf16 comparison in ``tests/test_torch_model.py``, stated
  ``TOL_AX = 0.4`` and a mean below ``TOL_AX_MEAN = 0.05``.

Serving every family (greedy tokens, the raises, splices, the batcher,
the CLI) is in ``tests/test_torch_families_serve.py``: greedy tokens must
be equal wherever JAX's top-2 logit margin exceeds ``TOL_AX``; after a
permitted divergence a row's later tokens are not compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models as JM
from repro.configs.base import AxPolicy as JPolicy
from repro.models import transformer as JT
import repro_torch.configs as TC
from repro_torch.configs.base import AxPolicy as TPolicy
from repro_torch.convert import cache_from_jax, layer_order, params_from_jax
from repro_torch.models import decode_step, prefill, transformer

TOL_F32 = 1e-5
TOL_SSM = 5e-5
TOL_AX = 0.4
TOL_AX_MEAN = 0.05
FAMILIES = ["gemma3-27b", "starcoder2-15b", "qwen1.5-110b", "qwen2-vl-72b",
            "deepseek-moe-16b", "granite-moe-1b-a400m", "recurrentgemma-2b", "mamba2-370m"]
NOT_FULL = ["gemma3-27b", "recurrentgemma-2b", "mamba2-370m"]
# the families whose SWAPPER comparison meets one int8 code flip (module note)
FLIPS = ("gemma3-27b", "mamba2-370m")
B, T = 2, 5
# gemma3's prompt outruns the reduced window of 64 (the ring wraps in
# prefill and again in decode); mamba2's spans two SSD chunks of 32
PROMPT = {"gemma3-27b": 70, "mamba2-370m": 64}
# gemma3 at 7 layers: one full 5:1 period (a global layer) and a rest layer
LAYERS = {"gemma3-27b": 7}


def _cfgs(name, ax=True):
    kw = dict(compute_dtype="float32")
    if name in LAYERS:
        kw["n_layers"] = LAYERS[name]
    jc = dataclasses.replace(JC.reduced(JC.ARCHS[name]), **kw,
                             ax=JPolicy(backend="mxu") if ax else None)
    tc = dataclasses.replace(TC.reduced(TC.ARCHS[name]), **kw,
                             ax=TPolicy(backend="mxu") if ax else None)
    return jc, tc


def _batch(cfg, S, seed=1):
    """The same prompt for both packages: tokens, or embeds with three
    distinct position streams for the vlm family."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        emb = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        t = np.arange(S, dtype=np.int32)
        pos = np.stack([t, t // 4, t % 4], -1)[None].repeat(B, 0).astype(np.int32)
        return ({"embeds": jnp.asarray(emb), "pos": jnp.asarray(pos)},
                {"embeds": torch.from_numpy(emb), "pos": torch.from_numpy(pos)})
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    name = request.param
    jc, tc = _cfgs(name)
    jc0, tc0 = _cfgs(name, ax=False)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    np_tree = jax.device_get(jp)
    tp = params_from_jax(np_tree, tc, device="cpu")
    S = PROMPT.get(name, 16)
    jb, tb = _batch(jc, S)
    return dict(name=name, jc=jc, tc=tc, jc0=jc0, tc0=tc0, jp=jp, np_tree=np_tree, tp=tp,
                S=S, jb=jb, tb=tb)


def _np(x):
    return x.to(torch.float32).numpy() if torch.is_tensor(x) else \
        np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(j, t, tol, mean=None, rel=False):
    """max |j - t| <= tol (times max(1, max |j|) with ``rel``)."""
    diff = np.abs(_np(j) - _np(t))
    scale = max(1.0, float(np.abs(_np(j)).max())) if rel else 1.0
    assert diff.max() <= tol * scale, (diff.max(), scale)
    if mean is not None:
        assert diff.mean() <= mean, diff.mean()


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_params_from_jax_maps_the_stack_layout(fam):
    """Every leaf of every layer lands where ``layer_order`` says (gemma3 at
    7 layers: 1 period of 6 and 1 rest; recurrentgemma: 1 period of 3 and
    1 rest; deepseek: 1 lead and 3 periods); tied embeddings have no
    lm_head."""
    tc, tp, tree = fam["tc"], fam["tp"], fam["np_tree"]
    order = layer_order(tc)
    assert len(tp["layers"]) == len(order) == tc.n_layers
    for i, (key, n) in enumerate(order):
        src = tree[key] if n is None else tree["layers"][key]
        for path, leaf in _leaf_paths(src):
            want = np.asarray(leaf) if n is None else np.asarray(leaf)[n]
            np.testing.assert_array_equal(_get(tp["layers"][i], path).numpy(), want)
    assert ("lm_head" in tp) == (not tc.tie_embeddings)
    kinds = tc.layer_kinds()
    for i, lp in enumerate(tp["layers"]):
        block = {"recurrent": "rec", "ssm": "ssm"}.get(kinds[i], "attn")
        assert block in lp, (i, kinds[i], sorted(lp))


def test_gemma3_full_layout_has_ten_periods_and_two_rest_layers():
    order = layer_order(TC.gemma3_27b)
    assert len(order) == 62
    assert sum(k is not None for _, k in order) == 60 and max(k or 0 for _, k in order) == 9
    assert [key for key, k in order if k is None] == ["rest0", "rest1"]
    assert TC.gemma3_27b.layer_kinds()[60:] == ("local", "local")


def _tol(fam):
    return TOL_SSM if fam["tc"].family == "ssm" else TOL_F32


def _jax_prefill_exact(fam):
    """JAX's prefill on the exact path (its logits are its forward's), made
    once per family and shared by the tests below."""
    if "jax_prefill" not in fam:
        jc, L = fam["jc0"], fam["S"] + T + 1
        fam["jax_prefill"] = jax.jit(lambda p, b: JM.prefill(p, b, jc, max_cache_len=L))(
            fam["jp"], fam["jb"])
    return fam["jax_prefill"]


def test_forward_logits_exact_path(fam):
    tc = fam["tc0"]
    jl, _ = _jax_prefill_exact(fam)
    with torch.inference_mode():
        tl, cache = transformer.forward(fam["tp"], fam["tb"], tc, mode="train")
    assert cache is None and tuple(tl.shape) == (B, fam["S"], tc.vocab)
    _close(jl, tl, _tol(fam))


def test_forward_logits_with_swapper(fam):
    """``TOL_F32``, or for a family of ``FLIPS`` one flip: the logits leave
    ``TOL_F32`` in a single row, from a single token on, within ``TOL_AX``."""
    jc, tc = fam["jc"], fam["tc"]
    jl, _, _ = jax.jit(lambda p, b: JT.forward(p, b, jc, mode="train"))(fam["jp"], fam["jb"])
    with torch.inference_mode():
        tl, _ = transformer.forward(fam["tp"], fam["tb"], tc, mode="train")
    if fam["name"] not in FLIPS:
        _close(jl, tl, TOL_F32)
        return
    _close(jl, tl, TOL_AX, TOL_AX_MEAN)
    off = np.abs(_np(jl) - _np(tl)).max(-1) > TOL_F32                 # (B, S)
    rows = np.flatnonzero(off.any(-1))
    assert len(rows) == 1, rows
    onset = int(np.argmax(off[rows[0]]))
    assert onset > 0, (rows[0], onset)


def test_prefill_cache_and_three_decode_steps(fam):
    """Prefill logits, the JAX prefill cache converted to the port's layout
    against the port's cache, then three teacher-forced decode steps
    (logits and the caches after them), on the exact path."""
    jc, tc, S = fam["jc0"], fam["tc0"], fam["S"]
    L = S + T + 1
    jl, jcache = _jax_prefill_exact(fam)
    with torch.inference_mode():
        tl, tcache = prefill(fam["tp"], fam["tb"], tc, max_cache_len=L)
    _close(jl, tl, _tol(fam))
    conv = cache_from_jax(jax.device_get(jcache), tc, device="cpu")
    assert len(conv) == len(tcache) == tc.n_layers
    for a, b in zip(conv, tcache):
        assert set(a) == set(b)
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            _close(a[k], b[k], _tol(fam), rel=True)
    if "local" in tc.layer_kinds():
        i = tc.layer_kinds().index("local")
        assert tcache[i]["k"].shape[1] == min(tc.local_window, L)
    step_fn = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jc))
    toks = np.random.default_rng(7).integers(0, tc.vocab, (B, 3)).astype(np.int32)
    for i in range(3):
        st = toks[:, i:i + 1]
        jl, jcache = step_fn(fam["jp"], jcache, jnp.asarray(st), jnp.int32(S + i))
        with torch.inference_mode():
            tl, tcache = decode_step(fam["tp"], tcache, torch.from_numpy(st), S + i, tc)
        assert tuple(tl.shape) == (B, 1, tc.vocab)
        _close(jl, tl, _tol(fam))
    for a, b in zip(cache_from_jax(jax.device_get(jcache), tc, device="cpu"), tcache):
        for k in a:
            _close(a[k], b[k], _tol(fam), rel=True)


def test_decode_writes_the_state_in_place(fam):
    """A decode step keeps every cache tensor's address (the graph
    contract): attention rows, ring rows and recurrent/SSM state alike."""
    tc, S = fam["tc"], fam["S"]
    with torch.inference_mode():
        _, cache = prefill(fam["tp"], fam["tb"], tc, max_cache_len=S + 3)
        ptrs = [(k, t.data_ptr()) for c in cache for k, t in c.items()]
        before = [t.clone() for c in cache for t in c.values()]
        tok = torch.zeros((B, 1), dtype=torch.int64)
        _, out = decode_step(fam["tp"], cache, tok, S, tc)
    assert all(a is b for a, b in zip(out, cache))
    assert [(k, t.data_ptr()) for c in out for k, t in c.items()] == ptrs
    changed = [not torch.equal(a, t) for a, t in zip(before, (t for c in out
                                                              for t in c.values()))]
    assert all(changed[i] for i, (k, _) in enumerate(ptrs) if k in ("h", "conv"))


@pytest.mark.parametrize("targets", [("mlp", "attn_out"), ("attn_qkv", "attn_out", "mlp")])
@pytest.mark.parametrize("name", ["qwen2-72b"] + FAMILIES)
def test_ax_projections_are_the_approximate_dense_calls(name, targets, monkeypatch):
    """``transformer.ax_projections`` lists the weights that reach
    ``ax_dense``, in call order, in a prefill and again in a decode step
    (the chip script reckons its launches and its kernel shapes from it)."""
    from repro_torch.models import init_params
    import repro_torch.models.layers as TL

    calls = []
    real = TL.ax_dense

    def recording(x, w, policy, wcodes=None):
        calls.append(tuple(w.shape))
        return real(x, w, policy, wcodes=wcodes)

    monkeypatch.setattr(TL, "ax_dense", recording)
    kw = {"n_layers": LAYERS[name]} if name in LAYERS else {}
    tc = dataclasses.replace(TC.reduced(TC.ARCHS[name]), compute_dtype="float32",
                             ax=TPolicy(targets=targets), **kw)
    want = [(K, N) for _, _, K, N in transformer.ax_projections(tc)]
    assert want and [i for i, *_ in transformer.ax_projections(tc)] == \
        sorted(i for i, *_ in transformer.ax_projections(tc))
    tp = init_params(tc, seed=0, device="cpu")
    _, tb = _batch(tc, 8)
    with torch.inference_mode():
        _, cache = prefill(tp, tb, tc, max_cache_len=10)
        assert calls == want
        calls.clear()
        decode_step(tp, cache, torch.zeros((B, 1), dtype=torch.int64), 8, tc)
    assert calls == want
    assert transformer.ax_projections(dataclasses.replace(tc, ax=None)) == []
