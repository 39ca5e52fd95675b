"""The port's tuning framework (repro_torch.core.tuning, the sweep kernel's
plain version, component_sweep_kernel) against the JAX package: the
operand sets value for value, the sweep's row statistics against
``tuning_sweep_pallas`` in interpret mode, ``ComponentResult`` integer
fields and ``best()`` against ``repro.core.component_sweep``, two-bit and
application-level tuning, the array metrics, and the kernel descriptors
and build hashing the CUDA kernel relies on.  Inputs are made with numpy
and handed to both packages.

Tolerance: the float32 ``sq``/``rel`` sums agree to 1e-6 relative.  Every
float32 term is rounded identically; the port sums them in float64 and
rounds once, XLA sums in float32 (measured differences below 5e-7)."""
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as C
import repro.kernels as K
import repro_torch.core as T
import repro_torch.kernels  # noqa: F401  (loads the submodules below)
from repro.kernels.tuning_sweep import tuning_sweep_pallas
from repro_torch.kernels import _build
from repro_torch.kernels.ops import component_sweep_kernel
from repro_torch.kernels.ref import tuning_sweep_ref

TS = sys.modules["repro_torch.kernels.tuning_sweep"]
RTOL = 1e-6


def _jcfg(tcfg):
    return C.SwapConfig(tcfg.operand, tcfg.bit, tcfg.value)


@pytest.mark.parametrize("bits,signed,sample_bits,seed", [
    (8, False, None, 0), (8, True, None, 0), (12, False, None, 0), (12, True, 9, 3),
    (16, True, 9, 11), (16, False, 10, 0), (8, True, 6, 7), (16, True, None, 0)])
def test_operand_values_identical(bits, signed, sample_bits, seed):
    want = C.operand_values(bits, signed, sample_bits, seed)
    got = T.operand_values(bits, signed, sample_bits, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _lut_pair(name):
    jt = C.make_lut(C.get(name))
    return (C.lut_mult("lut_" + name, jt, C.get(name).signed),
            T.lut_mult("lut_" + name, T.make_lut(T.get(name)).numpy(), T.get(name).signed))


SWEEP_CASES = ["mul8u_exact", "mul8s_exact", "mul8u_trunc0_4", "mul8s_trunc2_4",
               "mul8u_perf0_1", "mul8s_perf1_3", "mul8u_bam_v2_h1", "mul8s_bam_v4_h0",
               "mul8u_mitch13_0", "mul8s_mitch10_13", "mul8u_drum2_6", "mul8s_drum3_4",
               "lut:mul8u_drum3_4", "lut:mul8s_bam_v2_h1"]


def _pair(name):
    if name.startswith("lut:"):
        return _lut_pair(name[4:])
    return C.get(name), T.get(name)


def _assert_stats_match(js, ts, n):
    for surf in TS.SURF_NAMES:
        for st in TS.STAT_NAMES:
            want = np.asarray(js[surf][st])
            got = ts[surf][st]
            assert got.shape == (n,), (surf, st)
            if st in ("sq", "rel"):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0,
                                           err_msg=f"{surf}.{st}")
            else:
                assert got.dtype == (torch.int32 if st == "cnt" else torch.int64)
                np.testing.assert_array_equal(got.numpy(), want.astype(np.int64),
                                              err_msg=f"{surf}.{st}")


@pytest.mark.parametrize("name", SWEEP_CASES)
def test_plain_sweep_matches_pallas(name):
    """The kernel's plain version == ``tuning_sweep_pallas`` (interpret),
    8-bit exhaustive, one multiplier of each family, signed and unsigned.
    A LUT multiplier is held to ``tile_stats_jnp`` over the full grid: the
    Pallas kernel refuses the table its body would capture."""
    jm, tm = _pair(name)
    vals = C.operand_values(8, jm.signed)
    if name.startswith("lut:"):
        js = C.tile_stats_jnp(jm, jnp.asarray(vals), jnp.asarray(vals))
    else:
        js = tuning_sweep_pallas(jm, jnp.asarray(vals), tile=128, interpret=True)
    ts = TS.tuning_sweep(tm, torch.from_numpy(vals))
    _assert_stats_match(js, ts, len(vals))


def test_plain_sweep_matches_pallas_sampled_16bit():
    jm, tm = C.get("mul16s_drum5_8"), T.get("mul16s_drum5_8")
    vals = C.operand_values(16, True, 9, 11)
    js = tuning_sweep_pallas(jm, jnp.asarray(vals), tile=128, interpret=True)
    _assert_stats_match(js, tuning_sweep_ref(tm, torch.from_numpy(vals)), len(vals))


def test_plain_sweep_rows_and_ragged_n():
    """A row subset equals those rows of the full sweep; a ragged N (not a
    multiple of any block) is a plain vector length."""
    tm = T.get("mul12u_drum4_6")
    vals = torch.from_numpy(T.operand_values(12, False, 9, 5)[:300].copy())
    full = tuning_sweep_ref(tm, vals)
    rows = torch.tensor([0, 7, 299, 150])
    part = tuning_sweep_ref(tm, vals, rows=rows)
    for surf in TS.SURF_NAMES:
        for st in TS.STAT_NAMES:
            assert torch.equal(part[surf][st], full[surf][st][rows])
    jm = C.get("mul12u_drum4_6")
    js = C.tile_stats_jnp(jm, jnp.asarray(vals.numpy()), jnp.asarray(vals.numpy()))
    _assert_stats_match(js, full, 300)


def _assert_results_equal(rj, rt, bits):
    for jstats, tstats in [(rj.noswap, rt.noswap), (rj.oracle, rt.oracle)]:
        assert (jstats.n, jstats.sum_abs, jstats.max_abs, jstats.count_neq) == \
            (tstats.n, tstats.sum_abs, tstats.max_abs, tstats.count_neq)
    assert len(rt.per_config) == 4 * bits
    for tcfg, ts in rt.per_config.items():
        js = rj.per_config[_jcfg(tcfg)]
        assert (js.n, js.sum_abs, js.max_abs, js.count_neq) == \
            (ts.n, ts.sum_abs, ts.max_abs, ts.count_neq), tcfg
        assert ts.sum_sq == pytest.approx(js.sum_sq, rel=RTOL), tcfg
        assert ts.sum_rel == pytest.approx(js.sum_rel, rel=RTOL), tcfg
    for metric in ("mae", "wce", "are", "mse", "ep"):
        assert _jcfg(rt.best(metric)) == rj.best(metric), metric
    assert rt.reduction("mae") == rj.reduction("mae")
    assert rt.theoretical_reduction("mae") == rj.theoretical_reduction("mae")


@pytest.mark.parametrize("name,sample_bits,seed", [
    ("mul8u_trunc0_4", None, 0), ("mul8s_drum3_4", None, 0), ("mul8u_mitch13_0", None, 0),
    ("mul8s_bam_v2_h1", None, 0), ("mul8u_trunc2_2", None, 0), ("mul8u_drum2_6", None, 0),
    ("mul8u_bam_v2_h1", None, 0), ("mul8u_perf0_1", None, 0), ("mul8u_drum2_6", 6, 7),
    ("mul12u_bam_v3_h1", None, 0), ("mul16s_drum5_8", 9, 11)])
def test_component_sweep_matches_jax(name, sample_bits, seed):
    """``component_sweep`` on the CPU (the sweep's plain version) against
    ``repro.core.component_sweep``: NoSwap, oracle and all 4M configs."""
    jm, tm = C.get(name), T.get(name)
    tile = 64 if sample_bits == 6 else 256
    rj = C.component_sweep(jm, tile=tile, sample_bits=sample_bits, seed=seed)
    rt = T.component_sweep(tm, tile=tile, sample_bits=sample_bits, seed=seed, device="cpu")
    _assert_results_equal(rj, rt, jm.bits)


def test_component_sweep_kernel_matches_pallas_driver():
    jm, tm = C.get("mul16s_drum5_8"), T.get("mul16s_drum5_8")
    rp = K.component_sweep_pallas(jm, tile=128, sample_bits=9, seed=11)
    rk = component_sweep_kernel(tm, sample_bits=9, seed=11, device="cpu")
    _assert_results_equal(rp, rk, 16)
    assert rk.reduction("mae") > 0.01


def test_component_sweep_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="cuda or cpu"):
        T.component_sweep(T.get("mul8u_trunc0_4"), device="meta")
    # ``tile`` is the JAX driver's argument and no constraint here
    m = T.get("mul8u_trunc0_4")
    assert T.component_sweep(m, tile=96, device="cpu").per_config == \
        T.component_sweep(m, device="cpu").per_config


def _two_bit_key(cfg):
    return (cfg.op_p, cfg.bit_p, cfg.op_q, cfg.bit_q, cfg.table)


@pytest.mark.parametrize("name", ["mul8u_trunc0_4", "mul8u_bam_v2_h1", "mul8u_perf0_1"])
@pytest.mark.parametrize("metric", ["mae", "mse", "ep", "are"])
def test_two_bit_sweep_matches_jax(name, metric):
    """Same best config and value (float32 block sums agree to 1e-5
    relative).  For ``are`` two truth tables tie to float32 rounding on two
    of these multipliers, so the port may name the other one of the tie:
    there the values are held, not the config."""
    jcfg, jval, jst = C.two_bit_sweep(C.get(name), metric)
    tcfg, tval, tst = T.two_bit_sweep(T.get(name), metric, device="cpu")
    assert tval == pytest.approx(jval, rel=1e-5)
    assert tst["noswap"] == pytest.approx(jst["noswap"], rel=1e-5)
    assert tst["reduction"] == pytest.approx(jst["reduction"], rel=1e-5)
    if metric != "are":
        assert _two_bit_key(tcfg) == _two_bit_key(jcfg)


def test_two_bit_closed_form_matches_direct():
    m = T.get("mul8u_trunc0_4")
    cfg, val, _ = T.two_bit_sweep(m, "mae", device="cpu")
    vals = torch.from_numpy(T.operand_values(8, False)).to(torch.int64)
    A, B = vals[:, None], vals[None, :]
    out = T.apply_swapper_two_bit(m, A, B, cfg)
    direct = float(T.abs_err(out, m.exact_product(A, B), False).to(torch.float64).mean())
    assert val == pytest.approx(direct, rel=1e-9)
    jout = C.apply_swapper_two_bit(C.get("mul8u_trunc0_4"), jnp.asarray(A.numpy()),
                                   jnp.asarray(B.numpy()), C.TwoBitConfig(*_two_bit_key(cfg)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout).astype(np.int64))


def test_tune_application_toy_table():
    """The same table on a toy run_app: the swapped products' mean error
    on seeded operands, the triple as device scalars."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, 4096).astype(np.int32)
    b = rng.integers(0, 256, 4096).astype(np.int32)
    jm, tm = C.get("mul8u_bam_v2_h1"), T.get("mul8u_bam_v2_h1")
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)

    def jrun(op, bit, val):
        p = C.apply_swapper_dyn(jm, ja, jb, op, bit, val)
        return jnp.mean(C.abs_err(p, jm.exact_product(ja, jb), False).astype(jnp.float32))

    seen = []

    def trun(op, bit, val):
        seen.append((op.dtype, op.dim(), op.device.type))
        p = T.apply_swapper_dyn(tm, ta, tb, op, bit, val)
        return T.abs_err(p, tm.exact_product(ta, tb), False).to(torch.float32).mean()

    jbest, jval, jtab = C.tune_application(jrun, bits=8)
    tbest, tval, ttab = T.tune_application(trun, bits=8, device="cpu")
    assert set(seen) == {(torch.int32, 0, "cpu")}
    assert (tbest is None) == (jbest is None) and _jcfg(tbest) == jbest
    assert len(ttab) == len(jtab) == 33
    for tcfg, v in ttab.items():
        assert v == pytest.approx(jtab[None if tcfg is None else _jcfg(tcfg)], rel=1e-6)
    tb2, _, _ = T.tune_application(trun, bits=8, minimize=False, include_noswap=False,
                                   device="cpu")
    jb2, _, _ = C.tune_application(jrun, bits=8, minimize=False, include_noswap=False)
    assert _jcfg(tb2) == jb2


@pytest.mark.parametrize("name", ["mul8u_trunc0_4", "mul8s_bam_v2_h1", "mul12s_mitch10_13"])
def test_array_metrics_match_jax(name):
    jm, tm = C.get(name), T.get(name)
    rng = np.random.default_rng(4)
    lo, hi = (-(1 << (jm.bits - 1)), 1 << (jm.bits - 1)) if jm.signed else (0, 1 << jm.bits)
    a = rng.integers(lo, hi, 5000).astype(np.int32)
    b = rng.integers(lo, hi, 5000).astype(np.int32)
    pj, ej = jm.fn(jnp.asarray(a), jnp.asarray(b)), jm.exact_product(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pt, et = tm.fn(ta, tb), tm.exact_product(ta, tb)
    assert sorted(T.METRICS) == sorted(C.METRICS)
    for k in C.METRICS:
        assert T.METRICS[k](pt, et, tm.signed) == pytest.approx(
            C.METRICS[k](pj, ej, jm.signed), rel=1e-12), k


def test_swapped_mult_and_is_commutative():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, 3000).astype(np.int32)
    b = rng.integers(0, 256, 3000).astype(np.int32)
    cfg = ("A", 5, 1)
    jm = C.swapped_mult(C.get("mul8u_trunc0_4"), C.SwapConfig(*cfg))
    tm = T.swapped_mult(T.get("mul8u_trunc0_4"), T.SwapConfig(*cfg))
    assert tm.name == jm.name and tm.desc is None
    np.testing.assert_array_equal(tm.fn(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(jm.fn(jnp.asarray(a), jnp.asarray(b))).astype(np.int64))
    assert T.swapped_mult(T.get("mul8u_trunc0_4"), None) is T.get("mul8u_trunc0_4")
    for name in ["mul8u_trunc0_4", "mul8u_trunc2_2", "mul12s_drum6_6", "mul16s_bam_v8_h0",
                 "mul16u_perf1_3_5_7", "mul8s_mitch13_0"]:
        assert T.is_commutative(T.get(name), device="cpu") == C.is_commutative(C.get(name)), name


# ---------------------------------------------------------------------------
# kernel descriptors, the wrapper's checks, the build's header hashing
# ---------------------------------------------------------------------------

def test_every_registry_multiplier_has_a_descriptor():
    for name, m in T.REGISTRY.items():
        family, bits, signed, params = m.desc
        assert family in TS.FAMILIES and family != "lut", name
        assert (bits, signed) == (m.bits, m.signed), name
        hash(m.desc)
    assert T.get("mul8u_trunc0_4").desc == ("trunc", 8, False, (0, 4))
    assert T.get("mul8s_perf1_3").desc == ("perforate", 8, True, (0b1010,))
    assert T.get("mul16s_bam_v4_h1").desc == ("broken_array", 16, True, (4, 1))
    _, lut = _lut_pair("mul8s_drum3_4")
    assert lut.desc[:3] == ("lut", 8, True)
    np.testing.assert_array_equal(np.frombuffer(lut.desc[3][0], "<i4"),
                                  T.make_lut(T.get("mul8s_drum3_4")).numpy())
    assert T.oracle_mult(T.get("mul8u_trunc0_4")).desc is None


def test_kernel_args_and_wrapper_checks():
    m = T.get("mul8s_mitch10_13")
    assert TS._kernel_args(m, torch.device("cpu")) == (TS.FAMILIES["mitchell"], 10, 13, None)
    fam, _, _, tbl = TS._kernel_args(_lut_pair("mul8u_drum3_4")[1], torch.device("cpu"))
    assert fam == TS.FAMILIES["lut"] and tbl.dtype == torch.int32 and tbl.numel() == 65536
    with pytest.raises(ValueError, match="no kernel descriptor"):
        TS._kernel_args(T.oracle_mult(m), torch.device("cpu"))
    vals = torch.from_numpy(T.operand_values(8, True))
    with pytest.raises(ValueError, match="int32"):
        TS.tuning_sweep(m, vals.to(torch.int64))
    with pytest.raises(ValueError, match="1..65536"):
        TS.tuning_sweep(m, torch.zeros(65537, dtype=torch.int32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        TS.tuning_sweep(m, vals.to("meta"))
    before = TS.LAUNCHES["tuning_sweep"]
    TS.tuning_sweep(m, vals)                      # CPU: the plain version, no launch
    assert TS.LAUNCHES["tuning_sweep"] == before


def test_pair_ops_counts_from_the_family():
    """Per pair only what depends on both operands; one operand's work
    (masks, envelope, msb, segment) is counted once per value."""
    assert TS.pair_ops(T.get("mul8u_trunc0_4")) == (2 * 1 + 1 + 8 + 1 + 21, 17, 2)
    assert TS.pair_ops(T.get("mul16s_bam_v4_h1")) == (2 * (15 + 3) + 31, 18, 4 * 15 + 6)
    assert TS.pair_ops(T.get("mul16s_drum5_8")) == (2 * (5 + 3) + 31, 18, 20 + 6)
    assert TS.pair_ops(T.get("mul8s_exact")) == (2 + 31, 18, 0)
    for m in T.REGISTRY.values():
        i, f, o = TS.pair_ops(m)
        # the per-evaluation total is the family's whole definition
        total = (i - 31) // 2 + o
        assert 31 < i < 80 and f in (17, 18) and 0 <= o <= 100, m.name
        if m.desc[0] == "drum":
            assert total == 25 + (9 if m.signed else 0), m.name


def test_build_target_hashes_included_headers(tmp_path, monkeypatch):
    """A changed header (or a header it includes) names a new library; an
    unrelated file does not."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    (src / "extra.cuh").write_text("#pragma once\n")
    main = src / "tuning_sweep.cu"
    monkeypatch.setattr(_build, "SOURCES", {"tuning_sweep": main})
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    first = _build._target("tuning_sweep")
    assert first.parent == tmp_path / "build"
    assert [p.name for p in _build._with_headers(main)] == ["tuning_sweep.cu", "ax_families.cuh"]
    (src / "unrelated.cuh").write_text("// not included\n")
    assert _build._target("tuning_sweep") == first
    hdr = src / "ax_families.cuh"
    hdr.write_text(hdr.read_text() + "\n// edit\n")
    second = _build._target("tuning_sweep")
    assert second != first
    hdr.write_text(hdr.read_text() + '#include "extra.cuh"\n')
    third = _build._target("tuning_sweep")
    (src / "extra.cuh").write_text("#pragma once\n// edit\n")
    assert len({first, second, third, _build._target("tuning_sweep")}) == 4
    assert set(_build.SOURCES) == {"tuning_sweep"}
