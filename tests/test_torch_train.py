"""Training on one device in the port against the JAX package: AdamW, the
static and adaptive train steps, gradient accumulation, bf16 gradient
compression, the synthetic and file streams, checkpoints (a JAX checkpoint
resumes in the port), the supervised restart and the train CLI.  JAX runs
under ``jax.jit``; the JAX package's initial weights and train states come
across through ``convert.params_from_jax`` / ``train_state_from_jax``.

Tolerances (stated; measured on the CPU):

* ``adamw_update`` on the same gradients, none and bf16 compression, three
  updates: parameters, moments and error feedback within ``TOL_OPT =
  1e-6`` (the bias corrections' f32 powers may round apart by an ulp).
* Three steps of reduced qwen2 and deepseek-moe at two layers (deepseek's
  dense layer and a MoE layer, the aux term included), f32 compute, on the
  exact path: losses and grad norms within
  ``TOL_LOSS = 1e-5`` relative (measured 8e-8 and 1.5e-6), the parameters
  within ``TOL_PARAM = 2e-4`` (measured 8.1e-5: AdamW's first steps divide
  a gradient by its own magnitude, so a gradient near ``eps`` turns a 1e-7
  difference into a visible one).
* The same steps through the SWAPPER projection (``mxu``), each port step
  started from JAX's state before it so that a step's difference does not
  compound: losses and grad norms within ``TOL_LOSS_AX = 1e-4`` relative
  (measured 1.06e-5 and 3.7e-5 on qwen2, 1.5e-7 and 3.5e-7 on deepseek),
  and every parameter leaf's update within ``TOL_UPDATE_AX = 0.1`` of
  JAX's, |d_port - d_jax| / |d_jax| (measured 0.021 on qwen2, 3.9e-4 on
  deepseek; 0.0041 on the exact path).  A step that leaves a leaf
  unchanged reads 1; a straight-through backward whose weight gradient is
  half taken from its rows reversed reads grad norms 1.35e-2 apart, one
  whose input gradient is scaled by 1.2 reads 1.05 (mutation checks on a
  copy).  Run in
  a chain, qwen2's steps drift apart (0.29 in an update after three):
  AdamW's first steps move a weight by about ``lr`` whatever its
  gradient's size, so a small gradient difference becomes a sign flip.
* Where they differ, the cause is an int8 code that flips: an activation
  whose float value the two packages compute an ulp apart sits on a
  rounding boundary.  The adaptive step's telemetry records carry the
  int8 activation codes they sample (the test adds them in both packages):
  every record whose codes equal JAX's equals JAX's record bit for bit.
  On qwen2's first step, layer 2's mlp input has one code one step apart
  (58 vs 59) whose port ``x / scale`` is 3.8e-6 (one f32 ulp) from the
  boundary, within ``TOL_FLIP = 1e-4``; the down projection of the same
  token then reads 7 more; only these three records differ (``err_cnt``
  by one, ``err_lo``).  deepseek meets no flip.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models as JM
import repro.runtime.telemetry as JTel
import repro.train as JT
from repro.configs.base import AxPolicy as JPolicy
import repro_torch.configs as TC
import repro_torch.runtime.telemetry as TTel
import repro_torch.train as TT
from repro_torch.configs.base import AxPolicy as TPolicy
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.train.optimizer import tree_leaves

TOL_OPT = 1e-6
TOL_LOSS = 1e-5
TOL_PARAM = 2e-4
TOL_LOSS_AX, TOL_UPDATE_AX, TOL_FLIP = 1e-4, 0.1, 1e-4
LR, WARMUP = 3e-3, 2


def _cfgs(name, ax=False, dtype="float32", **kw):
    jc = dataclasses.replace(JC.reduced(JC.ARCHS[name]), compute_dtype=dtype, **kw,
                             ax=JPolicy(backend="mxu") if ax else None)
    tc = dataclasses.replace(TC.reduced(TC.ARCHS[name]), compute_dtype=dtype, **kw,
                             ax=TPolicy(backend="mxu") if ax else None)
    return jc, tc


def _stream(vocab, batch=4, seq=16, seed=1):
    return JT.SyntheticStream(JT.DataConfig(vocab, seq, batch, seed=seed, mode="arith"))


def _maxdiff(a_tree, b_tree):
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))


@pytest.mark.parametrize("compress", ["none", "bf16"])
def test_adamw_update_equals_jax(compress):
    rng = np.random.default_rng(0)
    shapes = {"a": {"w": (8, 5)}, "b": {"w": (7,), "s": (3, 2, 4)}}
    params = {k: {n: rng.standard_normal(s).astype(np.float32) for n, s in v.items()}
              for k, v in shapes.items()}
    jcfg = JT.AdamWConfig(lr=1e-2, warmup=3, clip_norm=0.5, compress=compress)
    tcfg = TT.AdamWConfig(lr=1e-2, warmup=3, clip_norm=0.5, compress=compress)
    jp = jax.tree.map(jnp.asarray, params)
    js = JT.adamw_init(jp, jcfg)
    tp = jax.tree.map(torch.from_numpy, params)
    ts = TT.adamw_init(tp, tcfg)
    upd = jax.jit(lambda g, s, p: JT.adamw_update(g, s, p, jcfg))
    for i in range(3):
        grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 3).astype(np.float32),
                             params)
        jp, js, jm = upd(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tm = TT.adamw_update(jax.tree.map(torch.from_numpy, grads), ts, tp, tcfg)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= TOL_OPT * LR
        assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) <= TOL_OPT
        for key in ("m", "v") + (("ef",) if compress == "bf16" else ()):
            for a, b in zip(jax.tree.leaves(js[key]), tree_leaves(_sorted(ts[key]))):
                np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(),
                                           atol=TOL_OPT, rtol=TOL_OPT)
                assert (b.dtype == torch.bfloat16) == (key != "ef" and compress == "bf16")
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(_sorted(tp))):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=TOL_OPT, rtol=0)


def _sorted(tree):
    """A dict tree with its keys sorted, as JAX orders its leaves."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _run_both(name, ax, steps=3, par_kw=None, teacher=False):
    """``steps`` train steps of JAX and the port on the same batches.  Each
    entry: (JAX metrics, port metrics, JAX state, port state, parameters
    the port's step started from).  With ``teacher``, every port step
    starts from JAX's state before it, so an entry holds one step's
    difference alone."""
    jc, tc = _cfgs(name, ax, n_layers=2)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    jopt, topt = JT.AdamWConfig(lr=LR, warmup=WARMUP), TT.AdamWConfig(lr=LR, warmup=WARMUP)
    jstep = jax.jit(JT.make_train_step(jc, JC.ParallelConfig(remat="none"), jopt))
    tstep = TT.make_train_step(tc, TC.ParallelConfig(remat="none", **(par_kw or {})), topt)
    js = JT.init_train_state(jp, jopt)
    ts = train_state_from_jax(jax.device_get(js), tc, device="cpu")
    stream, out = _stream(jc.vocab), []
    for _ in range(steps):
        b = stream.next()
        if teacher:
            ts = train_state_from_jax(jax.device_get(js), tc, device="cpu")
        start = ts["params"]
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b))
        ts, tm = tstep(ts, b)
        out.append((jm, tm, train_state_from_jax(jax.device_get(js), tc, device="cpu"), ts,
                    start))
    return out


@pytest.mark.parametrize("name", ["qwen2-72b", "deepseek-moe-16b"])
def test_train_steps_equal_jax_on_the_exact_path(name):
    for jm, tm, jstate, tstate, _ in _run_both(name, ax=False):
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= TOL_LOSS * max(abs(float(jm[k])), 1e-3), k
        if name == "deepseek-moe-16b":
            assert float(tm["aux"]) > 0
        assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"])
        for part in ("params", "opt"):
            assert _maxdiff(tstate[part], jstate[part]) <= TOL_PARAM, part


def _update_gap(new, ref, start) -> float:
    """The largest over leaves of |(new - start) - (ref - start)| /
    |ref - start|: how far one step's update departs from the reference's
    (a step that leaves a leaf unchanged reads 1)."""
    gaps = []
    for a, b, p in zip(tree_leaves(new), tree_leaves(ref), tree_leaves(start)):
        da, db = a.float() - p.float(), b.float() - p.float()
        gaps.append(((da - db).norm() / db.norm()).item())
    return max(gaps)


@pytest.mark.parametrize("name", ["qwen2-72b", "deepseek-moe-16b"])
def test_train_steps_through_swapper_agree_with_jax(name):
    """Each step from JAX's state before it (module note): its loss, its
    grad norm and every leaf's update against JAX's."""
    for jm, tm, jstate, tstate, start in _run_both(name, ax=True, teacher=True):
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) / float(jm[k]) - 1) <= TOL_LOSS_AX, k
        assert _update_gap(tstate["params"], jstate["params"], start) <= TOL_UPDATE_AX
        assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"])


def _j_tile_codes(xq, gm):
    """The int8 codes each JAX ``tile_summary`` tile samples."""
    from repro.core.tiling import rowtile_count, rowtile_span

    x2d = xq.reshape(-1, xq.shape[-1])
    g, span = rowtile_count(x2d.shape[0], gm), rowtile_span(x2d.shape[0], gm)
    tiles = x2d[:g * span].reshape(g, -1)
    return jax.vmap(lambda v: JTel._flat_sample(v, JTel.TILE_TELEMETRY_SAMPLE))(tiles)


def _t_tile_codes(xq, gm):
    """The int8 codes each port ``tile_summary`` tile samples."""
    from repro_torch.core.tiling import rowtile_count, rowtile_span

    x2d = xq.reshape(-1, xq.shape[-1])
    g, span = rowtile_count(x2d.shape[0], gm), rowtile_span(x2d.shape[0], gm)
    tiles = x2d[:g * span].reshape(g, -1)
    return torch.stack([TTel._flat_sample(v, TTel.TILE_TELEMETRY_SAMPLE) for v in tiles])


def _sample_codes(monkeypatch):
    """Add to every telemetry record of both packages the int8 activation
    codes its statistics read (``a_codes``: the scalar record's sample;
    ``tile_a_codes``: each tile's), and to the port's scalar records the
    pre-rounding ``x / scale`` of those codes (``a_ratio``), the operand's
    row width (``a_width``) and the call's place in the forward (``a_seq``)."""
    import repro_torch.quant.ax as TAX

    jos, jts = JTel.operand_summary, JTel.tile_summary
    tos, tts, tq = TTel.operand_summary, TTel.tile_summary, TAX.quantize_rows
    ratio, seq = [], []

    def jo(xq, wq, mult, dyn, **kw):
        return dict(jos(xq, wq, mult, dyn, **kw),
                    a_codes=JTel._flat_sample(xq, JTel.TELEMETRY_SAMPLE))

    def jt(xq, wq, mult, gm, **kw):
        return dict(jts(xq, wq, mult, gm, **kw), tile_a_codes=_j_tile_codes(xq, gm))

    def tq_(x, axis=-1):
        q, s = tq(x, axis)
        if axis == -1:
            ratio[:] = [TTel._flat_sample(x / s, TTel.TELEMETRY_SAMPLE)]
        return q, s

    def to(xq, wq, mult, dyn, **kw):
        seq.append(len(seq))
        return dict(tos(xq, wq, mult, dyn, **kw), a_ratio=ratio[0],
                    a_width=torch.tensor(xq.shape[-1]), a_seq=torch.tensor(seq[-1]),
                    a_codes=TTel._flat_sample(xq, TTel.TELEMETRY_SAMPLE))

    def tt(xq, wq, mult, gm, **kw):
        return dict(tts(xq, wq, mult, gm, **kw), tile_a_codes=_t_tile_codes(xq, gm))

    for mod, name, fn in ((JTel, "operand_summary", jo), (JTel, "tile_summary", jt),
                          (TTel, "operand_summary", to), (TTel, "tile_summary", tt),
                          (TAX, "quantize_rows", tq_)):
        monkeypatch.setattr(mod, name, fn)


def _flipped(jcodes, tcodes):
    """Where the codes of one sample differ port vs JAX; each such code
    must be one rounding step apart."""
    d = jcodes != tcodes
    assert (np.abs(jcodes[d].astype(np.int32) - tcodes[d].astype(np.int32)) == 1).all()
    return d


def _hold_flip_causes(flips, seq_len):
    """``flips``: (place in the forward, flattened token rows, distances of
    the port's ``x / scale`` from a rounding boundary) per call whose codes
    differ.  The first such call's flips sit within ``TOL_FLIP`` of a
    boundary (an ulp-level difference of the float activations tips them);
    every later flip lies in a token at or after an earlier flip's token of
    the same sequence, where that flip's change reaches."""
    flips = sorted(flips, key=lambda f: f[0])
    if not flips:
        return
    assert (flips[0][2] <= TOL_FLIP).all(), flips[0]
    seen = set(flips[0][1].tolist())
    for _, rows, _ in flips[1:]:
        for r in rows.tolist():
            assert any(r0 // seq_len == r // seq_len and r0 <= r for r0 in seen), (r, seen)
        seen |= set(rows.tolist())


@pytest.mark.parametrize("tile_rows", [0, 2])
@pytest.mark.parametrize("name", ["qwen2-72b", "deepseek-moe-16b"])
def test_adaptive_step_telemetry_equals_jax_bit_for_bit(name, tile_rows, monkeypatch):
    """Every record (one per projection call, and per tile in tile mode)
    whose sampled int8 activation codes equal JAX's equals JAX's record bit
    for bit; a record that differs reads codes that differ, and each such
    code flip is explained (``_hold_flip_causes``; module note)."""
    from repro.runtime import AdaptiveConfig as JAC, AdaptiveController as JA, \
        SwapPolicy as JS
    from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy
    from repro_torch.runtime.telemetry import records_to_host

    _sample_codes(monkeypatch)
    jc, tc = _cfgs(name, ax=True, n_layers=2)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    jopt, topt = JT.AdamWConfig(lr=LR, warmup=WARMUP), TT.AdamWConfig(lr=LR, warmup=WARMUP)
    jpar = JC.ParallelConfig(remat="none", scan_layers=False)
    jstep = jax.jit(JT.make_train_step(jc, jpar, jopt, adaptive=True, tile_rows=tile_rows))
    tstep = TT.make_train_step(tc, TC.ParallelConfig(remat="none"), topt, adaptive=True,
                               tile_rows=tile_rows)
    jctl = JA(JS.from_ax_policy(jc.ax), jc.ax.targets, JAC(tile_rows=tile_rows))
    tctl = AdaptiveController(SwapPolicy.from_ax_policy(tc.ax), tc.ax.targets,
                              AdaptiveConfig(tile_rows=tile_rows), device="cpu")
    js = JT.init_train_state(jp, jopt)
    ts = train_state_from_jax(jax.device_get(js), tc, device="cpu")
    b = _stream(jc.vocab).next()
    _, jm = jstep(js, jax.tree.map(jnp.asarray, b), jctl.dyn_tree())
    ts2, tm = tstep(ts, b, tctl.dyn_tree())
    jt, tt = jax.device_get(jm["ax_telemetry"]), tm["ax_telemetry"]
    assert sorted(jt) == sorted(tt) and len(jt) == (2 if tile_rows == 0 else 4)
    assert all(not v.requires_grad for r in tt.values() for v in r.values())
    host, flips = records_to_host(tt), []
    for target, rec in jt.items():
        rec, got = {k: np.asarray(v) for k, v in rec.items()}, dict(host[target])
        extra = {k: got.pop(k) for k in ("a_ratio", "a_width", "a_seq") if k in got}
        assert sorted(rec) == sorted(got)
        tiles = "tile_a_codes" in rec
        codes = rec.pop("tile_a_codes" if tiles else "a_codes")
        tcodes = got.pop("tile_a_codes" if tiles else "a_codes")
        for c in range(codes.shape[0]):
            for t in (range(codes.shape[1]) if tiles else [None]):
                at = (c, t) if tiles else (c,)
                d = _flipped(codes[at], tcodes[at])
                if d.any():
                    if not tiles:
                        dist = np.abs(np.abs(extra["a_ratio"][c][d]) % 1 - 0.5)
                        flips.append((int(extra["a_seq"][c]),
                                      np.flatnonzero(d) // int(extra["a_width"][c]), dist))
                    continue
                for k, v in rec.items():
                    # tile samples lie (sample, tile): the tile axis is last
                    i = (c, Ellipsis, t) if tiles and k.endswith("_smp") else at
                    np.testing.assert_array_equal(got[k][i], v[i], err_msg=f"{target}/{k}{at}")
                    assert got[k].dtype == v.dtype
    _hold_flip_causes(flips, b["tokens"].shape[1])
    assert int(ts2["opt"]["step"]) == 1 and int(ts["opt"]["step"]) == 0
    assert abs(float(tm["loss"]) / float(jm["loss"]) - 1) <= TOL_LOSS_AX


def test_grad_accum_parity_and_bf16_compression_converge():
    """As ``tests/test_train_runtime.py``: k = 4 microbatches give the one
    batch's loss and update (up to accumulation rounding), and bf16
    gradient compression with error feedback still trains (bf16 compute,
    the reduced qwen2 at one layer)."""
    _, tc = _cfgs("qwen2-72b", dtype="bfloat16", n_layers=1)
    params = TT.fresh_train_state(tc, TT.AdamWConfig(), device="cpu")["params"]
    batch = _stream(tc.vocab, batch=8).next()
    outs = {}
    for k in (1, 4):
        step = TT.make_train_step(tc, TC.ParallelConfig(remat="none", grad_accum=k),
                                  TT.AdamWConfig(lr=1e-3))
        new, m = step(TT.init_train_state(params, TT.AdamWConfig(lr=1e-3)), batch)
        outs[k] = (float(m["loss"]), tree_leaves(new["params"])[0].float().numpy())
    assert outs[1][0] == pytest.approx(outs[4][0], rel=1e-3)
    np.testing.assert_allclose(outs[1][1], outs[4][1], rtol=2e-2, atol=2e-4)
    for compress in ("none", "bf16"):
        opt = TT.AdamWConfig(lr=3e-3, warmup=5, compress=compress)
        step = TT.make_train_step(tc, TC.ParallelConfig(remat="none"), opt)
        state, stream, losses = TT.init_train_state(params, opt), _stream(tc.vocab, 8), []
        for _ in range(20):
            state, m = step(state, stream.next())
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] - 0.1, (compress, losses[:3], losses[-3:])


def test_remat_layer_gives_the_same_step_and_the_sharded_settings_raise():
    _, tc = _cfgs("deepseek-moe-16b", n_layers=2)
    opt = TT.AdamWConfig(lr=LR)
    state = TT.fresh_train_state(tc, opt, device="cpu")
    b = _stream(tc.vocab).next()
    a, ma = TT.make_train_step(tc, TC.ParallelConfig(remat="none"), opt)(state, b)
    r, mr = TT.make_train_step(tc, TC.ParallelConfig(remat="layer"), opt)(state, b)
    assert float(ma["loss"]) == float(mr["loss"]) and float(ma["aux"]) == float(mr["aux"])
    assert _maxdiff(a["params"], r["params"]) == 0.0
    with pytest.raises(ValueError, match="dots"):
        TT.make_train_step(tc, TC.ParallelConfig(remat="dots"), opt)
    # the sharded settings act only on a mesh (tests/test_torch_train_mesh.py):
    # without one the step is the plain step, as JAX's shard() is a no-op
    for kw in (dict(fsdp=True), dict(seq_shard=True), dict(ep=True), dict(dp_only=True),
               dict(grad_compress="bf16")):
        s, ms = TT.make_train_step(tc, TC.ParallelConfig(remat="none", **kw), opt)(state, b)
        assert float(ms["loss"]) == float(ma["loss"]) and _maxdiff(a["params"], s["params"]) == 0
    with pytest.raises(ValueError, match="grad_accum=1"):
        TT.make_train_step(tc, TC.ParallelConfig(remat="none", grad_accum=2), opt,
                           adaptive=True)
    assert set(f.name for f in dataclasses.fields(TC.ParallelConfig)) == \
        set(f.name for f in dataclasses.fields(JC.ParallelConfig)) - {"donate"}


@pytest.mark.parametrize("remat", ["none", "layer"])
def test_a_step_frees_its_intermediates_without_the_garbage_collector(remat):
    """With the collector off, a step leaves no tensor alive but those it
    returns: no reference cycle holds its parameters' gathered copies or its
    gradients past the step (on the card they would stay on the device
    through the next step)."""
    import gc

    _, tc = _cfgs("deepseek-moe-16b", n_layers=2)
    opt = TT.AdamWConfig(lr=LR)
    state = TT.fresh_train_state(tc, opt, device="cpu")
    b = _stream(tc.vocab).next()
    step = TT.make_train_step(tc, TC.ParallelConfig(remat=remat), opt)
    step(state, b)
    gc.collect()
    before = {id(o) for o in gc.get_objects() if torch.is_tensor(o)}
    gc.disable()
    try:
        out = step(state, b)
        del out
        left = [tuple(o.shape) for o in gc.get_objects()
                if torch.is_tensor(o) and id(o) not in before]
    finally:
        gc.enable()
    assert left == []


@pytest.mark.parametrize("step,seed,mode", [(0, 0, "hash"), (3, 1, "hash"), (7, 5, "arith"),
                                            (123456789, 2 ** 40, "hash")])
def test_synthetic_stream_tokens_equal_jax(step, seed, mode):
    jcfg = JT.DataConfig(vocab=997, seq_len=9, global_batch=3, seed=seed, mode=mode)
    tcfg = TT.DataConfig(vocab=997, seq_len=9, global_batch=3, seed=seed, mode=mode)
    a = JT.SyntheticStream(jcfg, step=step)
    b = TT.SyntheticStream(tcfg).restore({"step": step})
    for _ in range(2):
        x, y = a.next(), b.next()
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])
    assert b.state() == {"step": step + 2}
    assert TT.make_batch_specs(tcfg) == {"tokens": ((3, 9), torch.int32),
                                         "labels": ((3, 9), torch.int32)}


def test_file_stream_reads_a_local_file_as_jax_does(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(1000, dtype=np.int32).tofile(path)
    a = JT.FileStream(str(path), JT.DataConfig(50, 7, 4))
    b = TT.FileStream(str(path), TT.DataConfig(50, 7, 4))
    for _ in range(40):
        x, y = a.next(), b.next()
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
        np.testing.assert_array_equal(x["labels"], y["labels"])
    assert b.restore({"step": 3}).next()["tokens"][0, 0] == 3 * 4 * 8


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    jc, tc = _cfgs("deepseek-moe-16b", n_layers=2)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    jopt, topt = JT.AdamWConfig(lr=LR, warmup=WARMUP), TT.AdamWConfig(lr=LR, warmup=WARMUP)
    jstep = jax.jit(JT.make_train_step(jc, JC.ParallelConfig(remat="none"), jopt))
    stream = _stream(jc.vocab)
    js, _ = jstep(JT.init_train_state(jp, jopt), jax.tree.map(jnp.asarray, stream.next()))
    JT.save(str(tmp_path), 1, js, extra={"train_step": 1, "data": stream.state()})
    assert TT.latest_step(str(tmp_path)) == 1
    tree, extra = TT.load_tree(str(tmp_path), 1)
    ts = train_state_from_jax(tree, tc, device="cpu")
    assert int(ts["opt"]["step"]) == 1 and extra == {"train_step": 1, "data": {"step": 1}}
    b = TT.SyntheticStream(TT.DataConfig(tc.vocab, 16, 4, seed=1, mode="arith")).restore(
        extra["data"]).next()
    _, jm = jstep(js, jax.tree.map(jnp.asarray, b))
    _, tm = TT.make_train_step(tc, TC.ParallelConfig(remat="none"), topt)(ts, b)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL_LOSS * float(jm["loss"])


@pytest.mark.parametrize("compress", ["none", "bf16"])
def test_port_checkpoints_round_trip(tmp_path, compress):
    _, tc = _cfgs("qwen2-72b", n_layers=1)
    opt = TT.AdamWConfig(compress=compress)
    state = TT.fresh_train_state(tc, opt, device="cpu")
    state["opt"]["m"]["embed"]["w"].normal_()
    TT.save(str(tmp_path), 7, state, extra={"train_step": 7, "data": {"step": 7}})
    saver = TT.AsyncCheckpointer()
    saver.save_async(str(tmp_path), 9, state, extra={"train_step": 9})
    saver.wait()
    assert TT.latest_step(str(tmp_path)) == 9
    for step in (7, 9):
        got, extra = TT.restore(str(tmp_path), step, state, device="cpu")
        assert extra["train_step"] == step
        for a, b in zip(tree_leaves(state), tree_leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert TT.latest_step(str(tmp_path / "none")) is None


def test_run_supervised_survives_a_simulated_failure(tmp_path):
    """As ``tests/test_train_runtime.py``: killed at step 6 of 12 (after the
    step-4 checkpoint), the loop restores and ends where an uninterrupted
    run ends."""
    _, tc = _cfgs("qwen2-72b", n_layers=1)
    opt = TT.AdamWConfig(lr=1e-3, warmup=2)
    step = TT.make_train_step(tc, TC.ParallelConfig(remat="none"), opt)
    params0 = TT.fresh_train_state(tc, opt, device="cpu")["params"]

    def make_state():
        return TT.init_train_state(params0, opt)

    def stream():
        return TT.SyntheticStream(TT.DataConfig(tc.vocab, 16, 2, seed=1, mode="arith"))

    s_ref, log_ref = TT.run_supervised(make_state, step, stream(), 12,
                                       TT.FaultConfig(ckpt_dir=str(tmp_path / "ref"),
                                                      ckpt_every=4))
    assert log_ref["restarts"] == 0 and log_ref["steps_run"] == 12
    fired = []

    def chaos(i):
        if i == 6 and not fired:
            fired.append(i)
            raise TT.SimulatedFailure("node died")

    s_chaos, log_chaos = TT.run_supervised(make_state, step, stream(), 12,
                                           TT.FaultConfig(ckpt_dir=str(tmp_path / "chaos"),
                                                          ckpt_every=4), chaos=chaos)
    assert log_chaos["restarts"] == 1 and int(s_chaos["opt"]["step"]) == 12
    for a, b in zip(tree_leaves(s_ref["params"]), tree_leaves(s_chaos["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    state, log, ctrl = train.main(["--device", "cpu", "--smoke", "--steps", "3", "--batch",
                                   "2", "--seq", "16", "--ckpt-every", "2", "--log-every", "1",
                                   "--ckpt-dir", str(tmp_path / "a")])
    assert log["steps_run"] == 3 and ctrl is None and int(state["opt"]["step"]) == 3
    state, log, ctrl = train.main(["--device", "cpu", "--smoke", "--adaptive", "--steps", "2",
                                   "--batch", "2", "--seq", "16", "--ckpt-dir",
                                   str(tmp_path / "b")])
    assert ctrl is not None and ctrl.step == 2
    assert (tmp_path / "b" / "policy" / "CURRENT").exists()
    out = capsys.readouterr().out
    assert "step 3: loss=" in out and "done: {'restarts': 0" in out
    with pytest.raises(SystemExit, match="frames"):
        train.main(["--device", "cpu", "--smoke", "--arch", "whisper-base"])
    assert train._parser().parse_args([]).device == "cuda"
