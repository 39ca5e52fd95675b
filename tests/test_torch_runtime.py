"""The port's adaptive runtime (repro_torch.runtime) against the JAX
package's (repro.runtime) on the same inputs, made with numpy:

* telemetry records (``operand_summary``, ``tile_summary``, with and
  without the kernel's histogram) are equal field for field, integer
  fields exactly and with the JAX package's types;
* policies round-trip through each other's JSON and give the same triples
  and grids;
* the drift detector, the quarantine and the controller, fed the same
  operand streams, give the same scores, reasons and re-tune events.

Re-tune scores: the port divides exact integer error sums at the end, the
JAX package takes an f32 mean.  The two agree to f32 rounding (stated
``SCORE_RTOL = 1e-6``); the winners are compared exactly.  A stream whose
best two configs tie to within f32 rounding could pick different winners;
these streams have no such tie.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as C
import repro.runtime as JR
import repro_torch.core as TC
import repro_torch.runtime as TR
from repro.core.metrics import ErrorStats as JStats
from repro.runtime.telemetry import TelemetryQuarantine as JQuar
from repro.runtime.telemetry import combine_records as j_combine
from repro_torch.core.metrics import ErrorStats as TStats
from repro_torch.runtime.telemetry import TelemetryQuarantine as TQuar
from repro_torch.runtime.telemetry import combine_records as t_combine
from repro_torch.runtime.telemetry import records_to_host

SCORE_RTOL = 1e-6


def _int8(shape, seed, lo=-127, hi=128):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int8)


def _host(rec):
    return records_to_host({"t": rec})["t"]


def _assert_records_equal(j, t):
    assert set(j) == set(t)
    for k in j:
        jv = np.asarray(j[k])
        assert t[k].dtype == jv.dtype, (k, t[k].dtype, jv.dtype)
        np.testing.assert_array_equal(t[k], jv, err_msg=k)


# ---------------------------------------------------------------------------
# metrics and scope
# ---------------------------------------------------------------------------

def test_error_stats_recombines_limbs_like_jax():
    j, t = JStats(), TStats()
    for args in ((2048, 65535 * 7, 12, 70000, 300, 4.5, 0.25), (512, 3, 0, 3, 2, 9.0, 0.5)):
        j.add_limbs(*args)
        t.add_limbs(*args)
    for m in ("mae", "wce", "mse", "ep", "are"):
        assert t.metric(m) == j.metric(m)
    assert (t.n, t.sum_abs, t.max_abs, t.count_neq) == (j.n, j.sum_abs, j.max_abs, j.count_neq)


def test_scope_lookup_gate_and_nesting():
    assert TR.fallback_chain("layer3/mlp") == JR.fallback_chain("layer3/mlp")
    dyn = {"mlp": torch.tensor([1, 3, 0]), "*": torch.tensor([1, 0, 2])}
    assert TR.active_scope() is None
    with TR.ax_scope(dyn, collect=True, gate=False) as outer:
        assert not outer.observing
        assert torch.equal(outer.triple_for("layer0/mlp"), dyn["mlp"])
        assert torch.equal(outer.triple_for("attn_out"), dyn["*"])
        with TR.ax_scope({}, collect=True) as inner:
            assert TR.active_scope() is inner and inner.observing
            assert inner.triple_for("mlp") is None
        assert TR.active_scope() is outer
    assert TR.active_scope() is None


# ---------------------------------------------------------------------------
# telemetry records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xshape,wshape", [((2, 3, 64), (64, 48)), ((40, 128), (128, 96))])
@pytest.mark.parametrize("name", ["mul8s_trunc0_4", "mul8s_drum3_4"])
@pytest.mark.parametrize("triple", [(1, 3, 0), (0, 6, 1), (1, 0, 2)])
def test_operand_summary_equals_jax(xshape, wshape, name, triple):
    xq, wq = _int8(xshape, 1), _int8(wshape, 2)
    j = JR.operand_summary(jnp.asarray(xq), jnp.asarray(wq), C.get(name),
                           jnp.asarray(triple, jnp.int32))
    t = TR.operand_summary(torch.from_numpy(xq), torch.from_numpy(wq), TC.get(name),
                           torch.tensor(triple, dtype=torch.int32))
    _assert_records_equal(j, _host(t))


@pytest.mark.parametrize("rows,gm", [(12, 2), (10, 3), (1, 2)])
@pytest.mark.parametrize("dyn", [None, (0, 4, 1), "grid"])
def test_tile_summary_equals_jax(rows, gm, dyn):
    xq, wq = _int8((rows, 96), 3), _int8((96, 40), 4)
    if dyn == "grid":
        dyn = np.stack([np.ones(gm), np.arange(gm) % 8, np.arange(gm) % 3], -1)[:, None]
    dj = None if dyn is None else jnp.asarray(np.asarray(dyn, np.int32))
    dt = None if dyn is None else torch.from_numpy(np.asarray(dyn, np.int32))
    mname = "mul8s_bam_v2_h1"
    j = JR.tile_summary(jnp.asarray(xq), jnp.asarray(wq), C.get(mname), gm, dyn=dj)
    t = TR.tile_summary(torch.from_numpy(xq), torch.from_numpy(wq), TC.get(mname), gm, dyn=dt)
    _assert_records_equal(j, _host(t))


def test_tile_summary_from_the_kernel_histogram_equals_jax():
    from repro.quant.ax import ax_matmul_int_dyn_hist as j_hist
    from repro.configs.base import AxPolicy as JPolicy
    from repro_torch.configs.base import AxPolicy as TPolicy
    from repro_torch.quant.ax import ax_matmul_int_dyn_hist as t_hist
    xq, wq = _int8((10, 64), 5), _int8((64, 32), 6)
    grid = np.asarray([[[1, 2, 0]], [[1, 5, 1]], [[1, 0, 2]]], np.int32)
    mname = "mul8s_trunc0_4"
    _, jb = j_hist(jnp.asarray(xq), jnp.asarray(wq), JPolicy(backend="kernel", mult_name=mname),
                   jnp.asarray(grid))
    _, tb = t_hist(torch.from_numpy(xq), torch.from_numpy(wq),
                   TPolicy(backend="kernel", mult_name=mname), torch.from_numpy(grid))
    j = JR.tile_summary(jnp.asarray(xq), jnp.asarray(wq), C.get(mname), 3,
                        dyn=jnp.asarray(grid), bits_from=jb)
    t = TR.tile_summary(torch.from_numpy(xq), torch.from_numpy(wq), TC.get(mname), 3,
                        dyn=torch.from_numpy(grid), bits_from=tb)
    _assert_records_equal(j, _host(t))
    assert int(_host(t)["tile_n"].sum()) == 10 * 64


def test_combine_records_equals_jax():
    wq = _int8((64, 32), 8)
    tm = TC.get("mul8s_trunc0_4")
    recs = []
    for seed in (9, 10):
        x = _int8((8, 64), seed)
        rec = _host(TR.operand_summary(torch.from_numpy(x), torch.from_numpy(wq), tm,
                                       torch.tensor([1, 3, 0], dtype=torch.int32)))
        recs.append({k: v[None] for k, v in rec.items()})        # one call each
    j = j_combine([{"mlp": r} for r in recs])
    t = t_combine([{"mlp": r} for r in recs])
    _assert_records_equal(j["mlp"], t["mlp"])


def test_telemetry_accumulators_equal_jax():
    jt, tt = JR.Telemetry(8, 0.3), TR.Telemetry(8, 0.3)
    tm = TC.get("mul8s_drum3_4")
    for seed in range(4):
        x, w = _int8((6, 64), 20 + seed, -40 + 10 * seed, 60), _int8((64, 32), 30 + seed)
        dyn = torch.tensor([1, 3, 0], dtype=torch.int32)
        rec = _host(TR.operand_summary(torch.from_numpy(x), torch.from_numpy(w), tm, dyn))
        trec = _host(TR.tile_summary(torch.from_numpy(x), torch.from_numpy(w), tm, 2, dyn=dyn))
        step = {"mlp": {k: v[None] for k, v in rec.items()},
                "mlp@tiles": {k: v[None] for k, v in trec.items()}}
        jt.update(step)
        tt.update(step)
    js, ts = jt.snapshot(), tt.snapshot()
    for key in ("mlp", "mlp@tiles"):
        for k, v in js[key].items():
            np.testing.assert_array_equal(np.asarray(ts[key][k]), np.asarray(v), err_msg=k)
    assert tt.describe() == jt.describe()


def test_quarantine_reasons_equal_jax():
    tm = TC.get("mul8s_trunc0_4")
    rec = _host(TR.operand_summary(torch.from_numpy(_int8((4, 64), 11)),
                                   torch.from_numpy(_int8((64, 32), 12)), tm,
                                   torch.tensor([1, 3, 0], dtype=torch.int32)))
    nan = dict(rec, bits_a=rec["bits_a"] + np.nan)
    big = dict(rec, bits_b=rec["bits_b"] + 10 ** 6)
    zero = {k: np.zeros_like(v) for k, v in rec.items()}
    for records in ({"mlp": rec}, {"mlp": nan}, {"mlp": big}, {"mlp": zero}):
        recs = {t: {k: v[None] for k, v in r.items()} for t, r in records.items()}
        j_adm, j_drop = JQuar(8).filter(recs)
        t_adm, t_drop = TQuar(8).filter(recs)
        assert t_drop == j_drop and set(t_adm) == set(j_adm)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

def _policies():
    j = JR.SwapPolicy("mul8s_trunc0_4", configs={"*": C.SwapConfig("A", 3, 0),
                                                 "mlp": None,
                                                 "layer1/attn_out": C.SwapConfig("B", 5, 1)},
                      meta={"note": "x", "arr": np.arange(3)})
    t = TR.SwapPolicy("mul8s_trunc0_4", configs={"*": TC.SwapConfig("A", 3, 0),
                                                 "mlp": None,
                                                 "layer1/attn_out": TC.SwapConfig("B", 5, 1)},
                      meta={"note": "x", "arr": np.arange(3)})
    grid = np.asarray([[[1, 2, 0]], [[1, 0, 2]], [[0, 4, 1]]], np.int32)
    j.set_tile_grid("mlp", grid)
    t.set_tile_grid("mlp", grid)
    return j, t


def test_policy_json_is_the_same_text_and_loads_across_packages():
    j, t = _policies()
    assert t.to_json() == j.to_json()
    tj = TR.SwapPolicy.from_json(j.to_json())
    jt = JR.SwapPolicy.from_json(t.to_json())
    assert tj.configs_equal(TR.SwapPolicy.from_json(t.to_json()))
    assert jt.configs_equal(j) and tj.version == j.version == 1
    assert tj.describe() == j.describe()


@pytest.mark.parametrize("tile_rows", [0, 2, 6])
def test_dyn_tree_and_tile_grids_equal_jax(tile_rows):
    j, t = _policies()
    keys = ("mlp", "attn_out", "layer1/attn_out")
    jd = j.dyn_tree(keys, tile_rows)
    td = t.dyn_tree(keys, tile_rows, device="cpu")
    for k in keys:
        assert td[k].dtype == torch.int32
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    for gm, gn in ((1, 1), (2, 3), (5, 2)):
        np.testing.assert_array_equal(t.tile_grid("mlp", gm, gn), j.tile_grid("mlp", gm, gn))
        np.testing.assert_array_equal(t.tile_grid("attn_out", gm, gn),
                                      j.tile_grid("attn_out", gm, gn))


def test_set_tile_grid_refuses_mixed_bside_triples():
    _, t = _policies()
    with pytest.raises(ValueError, match="B-side"):
        t.set_tile_grid("attn_out", np.asarray([[[0, 1, 0]], [[0, 2, 1]]], np.int32))
    t.set_tile_grid("attn_out", np.asarray([[[0, 1, 0]], [[1, 2, 1]], [[0, 1, 0]]], np.int32))


# ---------------------------------------------------------------------------
# drift and the controller
# ---------------------------------------------------------------------------

def test_drift_detector_scores_equal_jax():
    rng = np.random.default_rng(13)
    jd = JR.DriftDetector(JR.DriftConfig(threshold=0.05, min_steps=2))
    td = TR.DriftDetector(TR.DriftConfig(threshold=0.05, min_steps=2))
    for i in range(6):
        snap = {"mlp": {"bit_probs": rng.uniform(0, 1, (2, 9)) * (0.2 if i < 3 else 1.0)}}
        assert td.check(snap) == jd.check(snap)
    assert TR.drift_score(np.ones(3), np.zeros(3)) == JR.drift_score(np.ones(3), np.zeros(3))


def _controllers(start, mname, **kw):
    cfg = dict(decay=0.4, drift_threshold=0.05, min_observe_steps=2, cooldown_steps=2,
               buffer_size=1024)
    cfg.update(kw)
    jstart = None if start is None else C.SwapConfig(*start)
    tstart = None if start is None else TC.SwapConfig(*start)
    j = JR.AdaptiveController(JR.SwapPolicy(mname, configs={"*": jstart}), ("stream",),
                              cfg=JR.AdaptiveConfig(**cfg))
    t = TR.AdaptiveController(TR.SwapPolicy(mname, configs={"*": tstart}), ("stream",),
                              cfg=TR.AdaptiveConfig(**cfg), device="cpu")
    j.warmup()
    t.warmup()
    return j, t


def _short(cfg):
    return None if cfg is None else cfg.short()


def _assert_same_events(j, t):
    assert len(t.retunes) == len(j.retunes)
    for a, b in zip(t.retunes, j.retunes):
        assert (a.step, a.target, _short(a.old), _short(a.new)) == \
            (b.step, b.target, _short(b.old), _short(b.new))
        assert a.drift == pytest.approx(b.drift, abs=1e-12)
        assert a.old_score == pytest.approx(b.old_score, rel=SCORE_RTOL)
        assert a.new_score == pytest.approx(b.new_score, rel=SCORE_RTOL)
    assert len(t.tile_retunes) == len(j.tile_retunes)
    for a, b in zip(t.tile_retunes, j.tile_retunes):
        assert (a.step, a.target) == (b.step, b.target)
        np.testing.assert_array_equal(a.grid, b.grid)
        assert a.new_score == pytest.approx(b.new_score, rel=SCORE_RTOL)
        assert a.old_score == pytest.approx(b.old_score, rel=SCORE_RTOL)
    assert t.policy.to_json() == j.policy.to_json()


@pytest.mark.parametrize("mname,start", [("mul8u_trunc0_4", ("A", 7, 1)),
                                         ("mul8s_drum3_4", ("A", 3, 0))])
def test_controller_scalar_stream_retunes_like_jax(mname, start):
    """The drift stream of the JAX package's controller tests: a tuned-on
    regime, then low-A traffic; both controllers re-tune at the same steps
    to the same configs."""
    j, t = _controllers(start, mname)
    rng = np.random.default_rng(6)
    signed = mname.startswith("mul8s")
    for step in range(20):
        if step < 8:
            a = rng.integers(64 if signed else 128, 128 if signed else 256, 2048)
        else:
            a = rng.integers(-20 if signed else 0, 20 if signed else 96, 2048)
        b = rng.integers(-128 if signed else 0, 128 if signed else 256, 2048)
        assert t.observe_operands("stream", a, b) == j.observe_operands("stream", a, b)
    assert len(t.retunes) >= 1
    _assert_same_events(j, t)
    snap_j, snap_t = j.telemetry.snapshot()["stream"], t.telemetry.snapshot()["stream"]
    assert snap_t["n"] == snap_j["n"] and snap_t["mae"] == snap_j["mae"]


def test_controller_tile_stream_retunes_like_jax():
    """tile_rows=2 on a 2-D stream whose drift is confined to the second
    row tile: the same scalar and per-tile re-tunes and published grids."""
    j, t = _controllers(("A", 3, 0), "mul8u_trunc0_4", tile_rows=2, drift_threshold=0.03,
                        tile_buffer_size=512)
    rng = np.random.default_rng(7)
    for step in range(16):
        a = rng.integers(128, 256, (8, 256))
        if step >= 6:
            a[4:] = rng.integers(0, 40, (4, 256))
        b = rng.integers(0, 256, 2048)
        assert t.observe_operands("stream", a, b) == j.observe_operands("stream", a, b)
    assert len(t.tile_retunes) >= 1
    _assert_same_events(j, t)


def test_controller_refuses_what_is_not_ported():
    pol = TR.SwapPolicy("mul8s_trunc0_4")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        TR.AdaptiveController(pol, ("mlp",), TR.AdaptiveConfig(canary=True), device="cpu")
    with pytest.raises(NotImplementedError, match="policy store and rollout"):
        TR.AdaptiveController(pol, ("mlp",), store=object(), device="cpu")
    ctrl = TR.AdaptiveController(pol, ("mlp",), device="cpu")
    with pytest.raises(NotImplementedError, match="observability"):
        ctrl.attach_slo(object())
    assert TR.all_triples(8).tolist() == JR.all_triples(8).tolist()
    assert TR.tile_triples(8).tolist() == JR.tile_triples(8).tolist()
