"""The port's ``mxu`` backend against the JAX package, and the weight cache.

Mirrors ``tests/test_perf_paths.py``: on int8 operands the port's stacked
``mxu`` product equals JAX's ``mxu`` and JAX's 2-matmul oracle on every
static config and on all 4M+1 dynamic triples of ``mul8s_trunc0_4`` and
``mul8s_perf0_1``, and on row-tile grids (gn = 1).  Its guards raise where
JAX's do (a non-separable multiplier, a grid with column tiles), and on an
unsigned multiplier with int8 operands, which route T cannot take.  All
integer results are compared exactly.

Through ``ax_dense`` in the reduced qwen2 (f32 compute) the ``mxu`` and
``kernel`` backends give the same logits bit for bit and the same tokens.
The weight cache changes no token and no telemetry record, and a weight
that ``drift_hook`` replaces is quantized again.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as JC
import repro.quant.ax as JQ
from repro.configs.base import AxPolicy as JPolicy
from repro.runtime import all_triples as j_all_triples
import repro_torch.quant.ax as TQ
from repro_torch.core.swapper import cfg_to_triple
from repro_torch.configs import qwen2_72b as t_qwen2, reduced as t_reduced
from repro_torch.configs.base import AxPolicy as TPolicy
from repro_torch.launch.serve import drift_hook
from repro_torch.models import init_params, prefill
import repro_torch.runtime as TR
from repro_torch.serve import ServeConfig, generate

MULTS = ["mul8s_trunc0_4", "mul8s_perf0_1"]


def _ops(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, shape).astype(np.int8)


def _policies(mname, cfg):
    kw = dict(mult_name=mname, backend="mxu")
    if cfg is None:
        kw["swap_enabled"] = False
    else:
        kw.update(swap_operand=cfg.operand, swap_bit=cfg.bit, swap_value=cfg.value)
    return JPolicy(**kw), TPolicy(**kw)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# static and dynamic products == JAX mxu == JAX 2mm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mname", MULTS)
@pytest.mark.parametrize("shape", [((16, 32), 24), ((2, 5, 40), 12)])
def test_static_mxu_equals_jax_all_configs(mname, shape):
    a_shape, n = shape
    a, b = _ops(a_shape, 0), _ops((a_shape[-1], n), 1)
    for cfg in [None] + JC.all_configs(8):
        jp, tp = _policies(mname, cfg)
        want = np.asarray(JQ.ax_matmul_int(jnp.asarray(a), jnp.asarray(b), jp))
        oracle = np.asarray(JQ.ax_matmul_int_2mm(jnp.asarray(a), jnp.asarray(b), jp))
        got = TQ.ax_matmul_int(_t(a), _t(b), tp)
        got_2mm = TQ.ax_matmul_int_2mm(_t(a), _t(b), tp)
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(cfg))
        np.testing.assert_array_equal(got.numpy(), oracle, err_msg=str(cfg))
        np.testing.assert_array_equal(got_2mm.numpy(), oracle, err_msg=str(cfg))


@pytest.mark.parametrize("mname", MULTS)
def test_static_mxu_equals_emul(mname):
    """The stacked limbs compute the swapped multiplier itself."""
    a, b = _ops((8, 64), 2), _ops((64, 16), 3)
    for cfg in [None] + JC.all_configs(8)[::5]:
        _, tp = _policies(mname, cfg)
        got = TQ.ax_matmul_int(_t(a), _t(b), tp)
        want = TQ.ax_matmul_int(_t(a), _t(b), dataclasses.replace(tp, backend="emul"))
        assert torch.equal(got, want), cfg


@pytest.mark.parametrize("mname", MULTS)
def test_dyn_mxu_equals_jax_all_triples(mname):
    a, b = _ops((16, 32), 4), _ops((32, 24), 5)
    jp, tp = JPolicy(mult_name=mname, backend="mxu"), TPolicy(mult_name=mname, backend="mxu")
    triples = np.asarray(j_all_triples(8))
    assert np.array_equal(triples, TR.all_triples(8))
    assert len(triples) == 4 * 8 + 1
    for triple in triples:
        dyn = jnp.asarray(triple, jnp.int32)
        want = np.asarray(JQ.ax_matmul_int_dyn(jnp.asarray(a), jnp.asarray(b), jp, dyn))
        oracle = np.asarray(JQ.ax_matmul_int_dyn_2mm(jnp.asarray(a), jnp.asarray(b), jp, dyn))
        got = TQ.ax_matmul_int_dyn(_t(a), _t(b), tp, _t(triple))
        got_2mm = TQ.ax_matmul_int_dyn_2mm(_t(a), _t(b), tp, _t(triple))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(triple))
        np.testing.assert_array_equal(got.numpy(), oracle, err_msg=str(triple))
        np.testing.assert_array_equal(got_2mm.numpy(), oracle, err_msg=str(triple))


@pytest.mark.parametrize("mname", MULTS)
def test_dyn_triple_equals_static_config(mname):
    a, b = _ops((8, 64), 6), _ops((64, 16), 7)
    for cfg in [None] + JC.all_configs(8):
        _, tp = _policies(mname, cfg)
        triple = torch.tensor(cfg_to_triple(cfg), dtype=torch.int32)
        dyn = TQ.ax_matmul_int_dyn(_t(a), _t(b), TPolicy(mult_name=mname, backend="mxu"),
                                   triple)
        assert torch.equal(dyn, TQ.ax_matmul_int(_t(a), _t(b), tp)), cfg


def _row_grid(kind, gm, seed):
    rng = np.random.default_rng(seed)
    op = np.ones(gm, np.int32)
    bit = rng.integers(0, 8, gm).astype(np.int32)
    val = rng.integers(0, 3, gm).astype(np.int32)           # 2 = NoSwap
    if kind in ("one_bside", "mixed_bside"):
        op[::2] = 0                                          # B-side rows
        if kind == "one_bside":
            bit[::2], val[::2] = 5, 1
    return np.stack([op, bit, val], axis=-1)[:, None, :]     # (gm, 1, 3)


@pytest.mark.parametrize("mname", MULTS)
@pytest.mark.parametrize("kind", ["aside", "one_bside", "mixed_bside"])
@pytest.mark.parametrize("gm,rows", [(4, 16), (3, 10), (2, 1)])
def test_rowtile_grid_mxu_equals_jax(mname, kind, gm, rows):
    """Row-tile grids: A-side and NoSwap tiles, one shared B-side triple,
    and mixed B-side triples (JAX's representative semantics, reproduced),
    over ragged tile spans and fewer rows than tiles."""
    a, b = _ops((rows, 48), 8 + gm), _ops((48, 20), 9)
    grid = _row_grid(kind, gm, 10 + gm)
    jp, tp = JPolicy(mult_name=mname, backend="mxu"), TPolicy(mult_name=mname, backend="mxu")
    want = np.asarray(JQ.ax_matmul_int_dyn(jnp.asarray(a), jnp.asarray(b), jp,
                                           jnp.asarray(grid)))
    got = TQ.ax_matmul_int_dyn(_t(a), _t(b), tp, _t(grid))
    np.testing.assert_array_equal(got.numpy(), want)
    if kind != "mixed_bside":
        # the per-tile semantics themselves: the plain reference of any grid
        emul = TQ.ax_matmul_int_dyn(_t(a), _t(b), dataclasses.replace(tp, backend="emul"),
                                    _t(grid))
        assert torch.equal(got, emul)
    # the grid the card's kernel gets gives the same rows through the plain
    # reference (mixed B-side grids included)
    canon = TQ._mxu_row_grid(_t(grid))
    emul = TQ.ax_matmul_int_dyn(_t(a), _t(b), dataclasses.replace(tp, backend="emul"), canon)
    assert torch.equal(got, emul)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mname", ["mul8s_drum3_4", "mul8s_bam_v2_h1", "mul8s_mitch10_13"])
def test_non_separable_multiplier_raises_in_both(mname):
    a, b = _ops((4, 16), 11), _ops((16, 8), 12)
    jp, tp = JPolicy(mult_name=mname, backend="mxu"), TPolicy(mult_name=mname, backend="mxu")
    with pytest.raises(AssertionError):
        JQ.ax_matmul_int(jnp.asarray(a), jnp.asarray(b), jp)
    with pytest.raises(AssertionError):
        JQ.ax_matmul_int_dyn(jnp.asarray(a), jnp.asarray(b), jp, jnp.asarray([1, 3, 0]))
    with pytest.raises(ValueError, match="not separable"):
        TQ.ax_matmul_int(_t(a), _t(b), tp)
    with pytest.raises(ValueError, match="not separable"):
        TQ.ax_matmul_int_dyn(_t(a), _t(b), tp, torch.tensor([1, 3, 0], dtype=torch.int32))


def test_column_tiled_grid_raises_in_both():
    a, b = _ops((4, 16), 13), _ops((16, 8), 14)
    grid = np.tile(np.asarray([1, 3, 0], np.int32), (2, 2, 1))
    with pytest.raises(AssertionError):
        JQ.ax_matmul_int_dyn(jnp.asarray(a), jnp.asarray(b), JPolicy(backend="mxu"),
                             jnp.asarray(grid))
    with pytest.raises(ValueError, match="gn must be 1"):
        TQ.ax_matmul_int_dyn(_t(a), _t(b), TPolicy(backend="mxu"), _t(grid))


@pytest.mark.parametrize("mname", ["mul8u_trunc0_4", "mul8u_perf0_1", "mul12u_trunc0_6"])
def test_unsigned_multiplier_on_int8_raises(mname):
    """The port refuses what route T cannot take (JAX would compute
    f(a) * g(b) here; no JAX path uses such a pair)."""
    a, b = _ops((4, 16), 15), _ops((16, 8), 16)
    tp = TPolicy(mult_name=mname, backend="mxu")
    with pytest.raises(ValueError, match="refuses"):
        TQ.ax_matmul_int(_t(a), _t(b), tp)
    with pytest.raises(ValueError, match="refuses"):
        TQ.ax_matmul_int_dyn(_t(a), _t(b), tp, torch.tensor([1, 3, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="refuses"):
        TQ.ax_matmul_int_2mm(_t(a), _t(b), tp)


# ---------------------------------------------------------------------------
# through the model: mxu == kernel; the weight cache
# ---------------------------------------------------------------------------

def _cfg(backend):
    return dataclasses.replace(t_reduced(t_qwen2), n_layers=2, compute_dtype="float32",
                               ax=TPolicy(backend=backend))


@pytest.fixture(scope="module")
def model():
    params = init_params(_cfg("kernel"), seed=21, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(22).integers(0, 256, (3, 8)))
    return params, toks


def test_mxu_equals_kernel_through_the_model(model):
    params, toks = model
    with torch.inference_mode():
        lk, _ = prefill(params, {"tokens": toks}, _cfg("kernel"), max_cache_len=16)
        lm, _ = prefill(params, {"tokens": toks}, _cfg("mxu"), max_cache_len=16)
    assert torch.equal(lk, lm)
    tk = generate(params, {"tokens": toks}, _cfg("kernel"), ServeConfig(max_new_tokens=5))
    tm = generate(params, {"tokens": toks}, _cfg("mxu"), ServeConfig(max_new_tokens=5))
    assert torch.equal(tk, tm)


@pytest.mark.parametrize("backend", ["mxu", "kernel"])
def test_adaptive_mxu_equals_kernel_through_the_model(model, backend):
    """The dynamic path in tile mode, with drift: both backends re-tune the
    same way and give the same tokens."""
    params, toks = model
    runs = {}
    for be in ("kernel", backend):
        cfg = _cfg(be)
        ctrl = TR.AdaptiveController(
            TR.SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
            TR.AdaptiveConfig(min_observe_steps=2, cooldown_steps=2, drift_threshold=0.02,
                              tile_rows=2), device="cpu")
        out = generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=8),
                       adaptive=ctrl, param_hook=drift_hook(2, 0.05))
        runs[be] = (out, [e.describe() for e in ctrl.retunes + ctrl.tile_retunes])
    assert torch.equal(runs["kernel"][0], runs[backend][0])
    assert runs["kernel"][1] == runs[backend][1]


def _observed(ctrl):
    seen = []
    orig = ctrl.observe

    def observe(records):
        seen.append({t: {k: np.array(v) for k, v in r.items()} for t, r in records.items()})
        return orig(records)

    ctrl.observe = observe
    return seen


@pytest.mark.parametrize("fused", [True, False])
def test_weight_cache_changes_no_token_and_no_record(model, fused):
    params, toks = model
    cfg = _cfg("mxu")
    runs = []
    for enabled in (True, False):
        ctrl = TR.AdaptiveController(TR.SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                     TR.AdaptiveConfig(tile_rows=2), device="cpu")
        seen = _observed(ctrl)
        with TQ.weight_cache(enabled):
            misses = TQ.WEIGHT_CACHE["misses"]
            out = generate(params, {"tokens": toks}, cfg,
                           ServeConfig(max_new_tokens=6, fused=fused), adaptive=ctrl)
            misses = TQ.WEIGHT_CACHE["misses"] - misses
        runs.append((out, seen, misses))
    (t_on, r_on, _), (t_off, r_off, m_off) = runs
    assert m_off == 0
    assert torch.equal(t_on, t_off)
    assert len(r_on) == len(r_off) == 5
    for a, b in zip(r_on, r_off):
        assert a.keys() == b.keys()
        for t in a:
            for k in a[t]:
                np.testing.assert_array_equal(a[t][k], b[t][k], err_msg=f"{t}.{k}")


def test_weight_cache_quantizes_each_weight_once(model):
    params, toks = model
    cfg = _cfg("kernel")
    fresh = init_params(cfg, seed=23, device="cpu")
    m0, h0 = TQ.WEIGHT_CACHE["misses"], TQ.WEIGHT_CACHE["hits"]
    generate(fresh, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=4))
    # 4 ax weights (o, mlp in, gate, out) x 2 layers coded once; q, k, v and
    # the lm_head are f32 = the compute dtype, so they need no cast
    assert TQ.WEIGHT_CACHE["misses"] - m0 == 8
    assert TQ.WEIGHT_CACHE["hits"] - h0 == 8 * 4 - 8        # 4 forwards
    with torch.inference_mode():
        w = fresh["layers"][0]["mlp"]["in"]["w"]
        wq, sw = TQ.weight_codes(w, torch.float32)
        want = TQ.quantize_rows(w.float(), axis=0)
    assert torch.equal(wq, want[0]) and torch.equal(sw, want[1])


def test_weight_cache_requantizes_after_drift_hook(model):
    params, toks = model
    cfg = _cfg("kernel")
    hook = drift_hook(1, 0.05)
    m0 = TQ.WEIGHT_CACHE["misses"]
    with torch.inference_mode():
        drifted = hook(1, params)
        w_old = params["layers"][1]["mlp"]["out"]["w"]
        w_new = drifted["layers"][1]["mlp"]["out"]["w"]
        old = TQ.weight_codes(w_old, torch.float32)
        new = TQ.weight_codes(w_new, torch.float32)
        assert TQ.WEIGHT_CACHE["misses"] - m0 >= 1
        assert not torch.equal(old[0], new[0])
        assert torch.equal(new[0], TQ.quantize_rows(w_new.float(), axis=0)[0])
        # the cached codes of the old weight stay its own
        assert torch.equal(TQ.weight_codes(w_old, torch.float32)[0], old[0])
    # a stepwise serve with the hook gives the tokens of the uncached serve
    runs = []
    for enabled in (True, False):
        with TQ.weight_cache(enabled):
            runs.append(generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=5),
                                 param_hook=drift_hook(1, 0.05)))
    assert torch.equal(*runs)


def test_weight_cache_sees_an_in_place_update_and_skips_grad_mode(model):
    w = torch.randn(16, 8)
    with torch.no_grad():
        a = TQ.weight_codes(w, torch.bfloat16)[0].clone()
        w.mul_(-1.0)
        b = TQ.weight_codes(w, torch.bfloat16)[0]
    assert torch.equal(b, -a)
    m0 = TQ.WEIGHT_CACHE["misses"]
    TQ.weight_codes(w, torch.bfloat16)                      # grad mode: no cache
    assert TQ.WEIGHT_CACHE["misses"] == m0
