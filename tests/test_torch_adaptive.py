"""Adaptive serving of the port against the JAX package on the reduced
qwen2 (2 layers, SWAPPER ``backend="kernel"``), with the JAX package's own
initial weights handed over through ``params_from_jax``.

In f32 the two packages give the same greedy tokens, the same re-tune and
tile re-tune events (step, target, winner, grid; scores to
``SCORE_RTOL = 1e-6``, the port's exact integer means against JAX's f32
means) and the same final policy JSON, under synthetic weight drift
(stepwise schedule), across generations (fused schedule) and with
decimated telemetry.  In bf16 the models agree only to ``TOL_BF16`` in the
logits (``tests/test_torch_model.py`` states why), so bf16 is held to the
logits of decode steps under a fixed dynamic policy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
import repro.runtime as JR
from repro.configs import qwen2_72b as j_qwen2, reduced as j_reduced
from repro.configs.base import AxPolicy as JPolicy, ParallelConfig
from repro.launch.serve import _drift_hook as j_drift_hook
from repro.serve.engine import ServeConfig as JServe, generate as j_generate
from repro_torch.configs import qwen2_72b as t_qwen2, reduced as t_reduced
from repro_torch.configs.base import AxPolicy as TPolicy
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ax_matmul import LAUNCHES
from repro_torch.launch.serve import drift_hook
from repro_torch.models import decode_step, prefill
import repro_torch.runtime as TR
from repro_torch.serve import ServeConfig, generate

SCORE_RTOL = 1e-6
TOL_BF16 = 0.4
TOL_BF16_MEAN = 0.1
B, S = 4, 8


def _cfgs(dtype):
    jc = dataclasses.replace(j_reduced(j_qwen2), n_layers=2, compute_dtype=dtype,
                             ax=JPolicy(backend="kernel"))
    tc = dataclasses.replace(t_reduced(t_qwen2), n_layers=2, compute_dtype=dtype,
                             ax=TPolicy(backend="kernel"))
    return jc, tc


@pytest.fixture(scope="module")
def f32():
    jc, tc = _cfgs("float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.device_get(jp), tc, device="cpu")
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S)).astype(np.int32)
    return jc, tc, jp, tp, toks


def _controllers(jc, tc, **kw):
    cfg = dict(min_observe_steps=2, cooldown_steps=2, drift_threshold=0.03)
    cfg.update(kw)
    j = JR.AdaptiveController(JR.SwapPolicy.from_ax_policy(jc.ax), jc.ax.targets,
                              cfg=JR.AdaptiveConfig(**cfg))
    t = TR.AdaptiveController(TR.SwapPolicy.from_ax_policy(tc.ax), tc.ax.targets,
                              cfg=TR.AdaptiveConfig(**cfg), device="cpu")
    return j, t


def _short(cfg):
    return None if cfg is None else cfg.short()


def _assert_same_events(j, t):
    assert [(e.step, e.target, _short(e.old), _short(e.new)) for e in t.retunes] == \
        [(e.step, e.target, _short(e.old), _short(e.new)) for e in j.retunes]
    for a, b in zip(t.retunes, j.retunes):
        assert a.new_score == pytest.approx(b.new_score, rel=SCORE_RTOL)
        assert a.old_score == pytest.approx(b.old_score, rel=SCORE_RTOL)
    assert [(e.step, e.target) for e in t.tile_retunes] == \
        [(e.step, e.target) for e in j.tile_retunes]
    for a, b in zip(t.tile_retunes, j.tile_retunes):
        np.testing.assert_array_equal(a.grid, b.grid)
        assert a.new_score == pytest.approx(b.new_score, rel=SCORE_RTOL)
    assert t.policy.to_json() == j.policy.to_json()


def _serve(pair, scfg_kw, j_ctrl, t_ctrl, hooks=(None, None), params=None):
    jc, tc, jp, tp, toks = pair
    jp, tp = params or (jp, tp)
    jo = np.asarray(j_generate(jp, {"tokens": jnp.asarray(toks)}, jc, JServe(**scfg_kw),
                               adaptive=j_ctrl, param_hook=hooks[0]))
    to = generate(tp, {"tokens": torch.from_numpy(toks)}, tc, ServeConfig(**scfg_kw),
                  adaptive=t_ctrl, param_hook=hooks[1])
    return jo, to.numpy()


@pytest.mark.parametrize("tile_rows", [0, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_drift_serve_matches_jax(f32, tile_rows, fused):
    """Weight drift injected at step 3 (a param_hook forces the stepwise
    schedule in both packages): same tokens, same re-tunes, and the tokens
    after the re-tune follow the adapted policy."""
    jc, tc, *_ = f32
    j, t = _controllers(jc, tc, tile_rows=tile_rows)
    before = LAUNCHES["ax_matmul_grid"]
    jo, to = _serve(f32, dict(max_new_tokens=14, fused=fused), j, t,
                    hooks=(j_drift_hook(3, 0.05), drift_hook(3, 0.05)))
    assert len(t.retunes) + len(t.tile_retunes) >= 1
    assert t.retunes[0].step < 12                     # later tokens see it
    np.testing.assert_array_equal(to, jo)
    _assert_same_events(j, t)
    assert LAUNCHES["ax_matmul_grid"] - before == 0   # the CPU runs the plain version


def test_decimated_telemetry_matches_jax(f32):
    """observe_every=3: off steps compute no summary and never reach the
    controller; the observed steps and their effects equal JAX's."""
    jc, tc, *_ = f32
    j, t = _controllers(jc, tc, tile_rows=2, drift_threshold=0.02, min_observe_steps=1,
                        cooldown_steps=1)
    jo, to = _serve(f32, dict(max_new_tokens=14, observe_every=3), j, t,
                    hooks=(j_drift_hook(2, 0.05), drift_hook(2, 0.05)))
    np.testing.assert_array_equal(to, jo)
    assert t.step == j.step == 5                      # steps 0, 3, 6, 9, 12
    _assert_same_events(j, t)


@pytest.mark.parametrize("tile_rows", [0, 2])
def test_fused_schedule_across_generations_matches_jax(f32, tile_rows):
    """The fused schedule freezes the policy within a generation and folds
    the records in after it; drift between generations re-tunes, and the
    next generation serves the adapted policy."""
    jc, tc, jp, tp, toks = f32
    j, t = _controllers(jc, tc, tile_rows=tile_rows, min_observe_steps=2, cooldown_steps=2)
    drifted = (jax.tree.map(lambda w: w if w.ndim < 2 else jnp.where(
                   (jnp.arange(w.shape[-2]) % 2 == 0)[:, None], w * 0.05, w), jp),
               drift_hook(0, 0.05)(0, tp))
    for params in (None, drifted, drifted):
        jo, to = _serve(f32, dict(max_new_tokens=6), j, t, params=params)
        np.testing.assert_array_equal(to, jo)
        _assert_same_events(j, t)
    assert len(t.retunes) + len(t.tile_retunes) >= 1


@pytest.mark.parametrize("tile_rows", [0, 2])
def test_adaptive_serve_without_drift_equals_static(f32, tile_rows):
    jc, tc, jp, tp, toks = f32
    static = generate(tp, {"tokens": torch.from_numpy(toks)}, tc, ServeConfig(max_new_tokens=8))
    ctrl = TR.AdaptiveController(TR.SwapPolicy.from_ax_policy(tc.ax), tc.ax.targets,
                                 TR.AdaptiveConfig(drift_threshold=1e9, tile_rows=tile_rows),
                                 device="cpu")
    out = generate(tp, {"tokens": torch.from_numpy(toks)}, tc, ServeConfig(max_new_tokens=8),
                   adaptive=ctrl)
    assert torch.equal(out, static) and ctrl.retunes == [] and ctrl.step == 7
    assert ctrl.telemetry.snapshot()["mlp"]["n"] == 7 * 6 * 2048


def test_bf16_decode_logits_under_a_dynamic_policy():
    """bf16: teacher-forced decode logits inside an adaptive scope (a grid
    per target) stay within the stated tolerance of JAX's."""
    jc, tc = _cfgs("bfloat16")
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.device_get(jp), tc, device="cpu")
    toks = np.random.default_rng(2).integers(0, jc.vocab, (B, S)).astype(np.int32)
    grid = np.asarray([[[1, 2, 0]], [[0, 5, 1]]], np.int32)
    par = ParallelConfig(scan_layers=False)

    @jax.jit
    def j_step(p, c, tok, i, dyn):
        with JR.ax_scope(dyn, tile_rows=2):
            return JM.decode_step(p, c, tok, i, jc, par)

    L = S + 4
    _, jcache = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, max_cache_len=L)
    with torch.inference_mode():
        _, tcache = prefill(tp, {"tokens": torch.from_numpy(toks)}, tc, max_cache_len=L)
        step = toks[:, -1:]
        for i in range(3):
            jl, jcache = j_step(jp, jcache, jnp.asarray(step), jnp.int32(S + i),
                                {t: jnp.asarray(grid) for t in jc.ax.targets})
            with TR.ax_scope({t: torch.from_numpy(grid) for t in tc.ax.targets}, tile_rows=2):
                tl, tcache = decode_step(tp, tcache, torch.from_numpy(step), S + i, tc)
            diff = np.abs(np.asarray(jl.astype(jnp.float32)) - tl.to(torch.float32).numpy())
            assert diff.max() <= TOL_BF16 and diff.mean() <= TOL_BF16_MEAN
            step = np.array(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
