"""The port's kernel API (repro_torch.kernels) against the JAX package's
Pallas kernel (interpret mode), bit for bit: int32 outputs and tile
histograms over the shapes, blocks, families, unsigned and property cases
of tests/test_kernels.py, plus K padding, ragged edges, grid orders and the
16-bit product tables the CUDA kernel takes.  On the CPU the port runs the
kernel's plain version; the card runs the kernel (tests/test_torch_gpu.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st

import repro.core as C
import repro.kernels as K
import repro_torch.core as TC
import repro_torch.kernels as TK
from repro.quant.ax import _pad_for_kernel as jax_pad_for_kernel
from repro_torch.kernels.ax_matmul import ax_matmul_blocks, product_table
from repro_torch.kernels.ref import tile_hist_blocks
from repro_torch.kernels.schedule import KernelSchedule
from repro_torch.quant.ax import _pad_for_kernel


def _ops(shape, lo, hi, seed, dtype):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def _swaps(cfg):
    if cfg is None:
        return None, None
    return C.SwapConfig(*cfg), TC.SwapConfig(*cfg)


def _both(a, b, mname, cfg, blocks, tile_hist=True, order="mn"):
    """(jax out, jax hist), (port out, port hist) as numpy."""
    js, ts = _swaps(cfg)
    bm, bn, bk = blocks
    j = K.ax_matmul(jnp.asarray(a), jnp.asarray(b), C.get(mname), js,
                    schedule=K.KernelSchedule(bm=bm, bn=bn, bk=bk, grid_order=order),
                    tile_hist=tile_hist)
    t = TK.ax_matmul(torch.from_numpy(a), torch.from_numpy(b), TC.get(mname), ts,
                     schedule=KernelSchedule(bm, bn, bk, order), tile_hist=tile_hist)
    if not tile_hist:
        return (np.asarray(j),), (t.numpy(),)
    return tuple(np.asarray(x) for x in j), tuple(x.numpy() for x in t)


def _assert_same(j, t):
    for x, y in zip(j, t):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(y, x)


SHAPES = [(8, 8, 8), (32, 64, 16), (128, 128, 128), (256, 64, 32), (64, 256, 128)]
BLOCKS = [(8, 8, 8), (32, 32, 32), (64, 64, 64), (128, 128, 128)]


@pytest.mark.parametrize("shape", SHAPES)
def test_ax_matmul_shapes(shape):
    M, K_, N = shape
    a = _ops((M, K_), -128, 128, 0, np.int8)
    b = _ops((K_, N), -128, 128, 1, np.int8)
    _assert_same(*_both(a, b, "mul8s_bam_v2_h1", ("A", 5, 1), (32, 32, 8)))


@pytest.mark.parametrize("blocks", BLOCKS)
def test_ax_matmul_block_invariance(blocks):
    a = _ops((128, 128), -128, 128, 2, np.int8)
    b = _ops((128, 128), -128, 128, 3, np.int8)
    j, t = _both(a, b, "mul8s_drum3_4", ("B", 2, 0), blocks)
    _assert_same(j, t)
    ref = TK.ax_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                           TC.get("mul8s_drum3_4"), TC.SwapConfig("B", 2, 0))
    np.testing.assert_array_equal(t[0], ref.numpy())


@pytest.mark.parametrize(
    "mname", ["mul8s_exact", "mul8s_trunc0_4", "mul8s_mitch13_0", "mul8s_perf0_1"])
def test_ax_matmul_multiplier_families(mname):
    a = _ops((64, 32), -128, 128, 4, np.int8)
    b = _ops((32, 64), -128, 128, 5, np.int8)
    for cfg in (None, ("A", 7, 0)):
        _assert_same(*_both(a, b, mname, cfg, (32, 32, 16)))


def test_ax_matmul_unsigned_dtype():
    a = _ops((32, 32), 0, 256, 6, np.uint8)
    b = _ops((32, 32), 0, 256, 7, np.uint8)
    _assert_same(*_both(a, b, "mul8u_trunc0_4", ("A", 3, 0), (32, 32, 32)))


def test_ax_matmul_exact_equals_int_matmul():
    a = _ops((64, 64), -128, 128, 8, np.int8)
    b = _ops((64, 64), -128, 128, 9, np.int8)
    got = TK.ax_matmul(torch.from_numpy(a), torch.from_numpy(b), TC.get("mul8s_exact"),
                       None, schedule=KernelSchedule(32, 32, 32))
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int32) @ b.astype(np.int32))


def test_ax_matmul_dequant_epilogue():
    a = _ops((32, 64), -128, 128, 10, np.int8)
    b = _ops((64, 32), -128, 128, 11, np.int8)
    sa = np.random.default_rng(12).uniform(0.001, 0.1, (32, 1)).astype(np.float32)
    sb = np.random.default_rng(13).uniform(0.001, 0.1, (1, 32)).astype(np.float32)
    sched = (32, 32, 32)
    j = K.ax_matmul_dequant(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa), jnp.asarray(sb),
                            C.get("mul8s_trunc0_4"), C.SwapConfig("A", 3, 0),
                            schedule=K.KernelSchedule(bm=32, bn=32, bk=32))
    t = TK.ax_matmul_dequant(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(sa),
                             torch.from_numpy(sb), TC.get("mul8s_trunc0_4"),
                             TC.SwapConfig("A", 3, 0), schedule=KernelSchedule(*sched))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@settings(max_examples=20, deadline=None)
@given(
    m=st.sampled_from([8, 16, 32]),
    k=st.sampled_from([8, 16, 64]),
    n=st.sampled_from([8, 32]),
    bit=st.integers(0, 7),
    value=st.integers(0, 1),
)
def test_ax_matmul_property(m, k, n, bit, value):
    a = _ops((m, k), -128, 128, m * k + bit, np.int8)
    b = _ops((k, n), -128, 128, k * n + value, np.int8)
    _assert_same(*_both(a, b, "mul8s_trunc1_5", ("B", bit, value), (8, 8, 8)))


def test_grid_order_is_bit_exact():
    a = _ops((96, 64), -128, 128, 14, np.int8)
    b = _ops((64, 80), -128, 128, 15, np.int8)
    j, t_mn = _both(a, b, "mul8s_mitch10_13", ("A", 1, 1), (32, 16, 32), order="mn")
    _, t_nm = _both(a, b, "mul8s_mitch10_13", ("A", 1, 1), (32, 16, 32), order="nm")
    _assert_same(j, t_mn)
    _assert_same(t_mn, t_nm)


def test_k_padding_sums_pad_products_of_a_lut_circuit():
    """K zero-padded to a multiple of bk, as the JAX quant layer pads it: a
    LUT circuit with m(0, 0) != 0 sums the same pad products (and the
    16-bit table carries m(0, 0) to the kernel)."""
    table = C.make_lut(C.get("mul8s_drum3_4")).copy()
    table[0] = 5                                     # m(0, 0) = 5
    jm = C.lut_mult("lut_m00", table, True)
    tm = TC.lut_mult("lut_m00", table, True)
    a = _ops((20, 50), -128, 128, 16, np.int8)
    b = _ops((50, 24), -128, 128, 17, np.int8)
    js = K.KernelSchedule(bm=16, bn=16, bk=32)
    ja, jb, _, m0, n0, (bm, bn, bk) = jax_pad_for_kernel(jnp.asarray(a), jnp.asarray(b), js)
    ta, tb, _, tm0, tn0, tblocks = _pad_for_kernel(torch.from_numpy(a), torch.from_numpy(b),
                                                   KernelSchedule(16, 16, 32))
    assert (m0, n0, (bm, bn, bk)) == (tm0, tn0, tblocks) and tuple(ta.shape) == ja.shape
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # this jax's Pallas refuses a captured table, so the LUT reference is
    # the JAX package's own oracle on the padded operands
    j = K.ax_matmul_ref(ja, jb, jm, C.SwapConfig("B", 4, 1))
    t = TK.ax_matmul(ta, tb, tm, TC.SwapConfig("B", 4, 1),
                     schedule=KernelSchedule(*tblocks))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    unpadded = TK.ax_matmul_ref(torch.from_numpy(a), torch.from_numpy(b), tm,
                                TC.SwapConfig("B", 4, 1))
    assert not np.array_equal(t.numpy()[:m0, :n0], unpadded.numpy())   # pads counted
    assert int(product_table(tm, torch.int8)[0]) == 5


@pytest.mark.parametrize("shape,blocks", [((37, 64, 45), (16, 32, 32)),
                                          ((5, 96, 130), (4, 128, 32))])
def test_ragged_edges_match_zero_padded_jax(shape, blocks):
    """The port masks ragged M/N tiles; results equal the JAX kernel on the
    zero-padded operands, cropped (pads add no histogram counts)."""
    M, K_, N = shape
    bm, bn, bk = blocks
    a = _ops((M, K_), -128, 128, 18, np.int8)
    b = _ops((K_, N), -128, 128, 19, np.int8)
    Mp, Np = -(-M // bm) * bm, -(-N // bn) * bn
    ap = np.zeros((Mp, K_), np.int8)
    ap[:M] = a
    bp = np.zeros((K_, Np), np.int8)
    bp[:, :N] = b
    jo, jh = K.ax_matmul(jnp.asarray(ap), jnp.asarray(bp), C.get("mul8s_bam_v4_h0"),
                         C.SwapConfig("A", 0, 0), tile_hist=True,
                         schedule=K.KernelSchedule(bm=bm, bn=bn, bk=bk))
    to, th = ax_matmul_blocks(torch.from_numpy(a), torch.from_numpy(b),
                              TC.get("mul8s_bam_v4_h0"), TC.SwapConfig("A", 0, 0),
                              bm=bm, bn=bn, bk=bk, tile_hist=True)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo)[:M, :N])
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("gm,gn,bits", [(1, 1, 8), (2, 4, 8), (4, 2, 12)])
def test_tile_hist_ref_matches_jax(gm, gn, bits):
    from repro.kernels.ref import tile_hist_ref as jref
    a = _ops((32, 24), -128, 128, 20, np.int8)
    b = _ops((24, 16), -128, 128, 21, np.int8)
    want = jref(a, b, bits, gm, gn)
    got = TK.tile_hist_ref(torch.from_numpy(a), torch.from_numpy(b), bits, gm, gn)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tile_hist_blocks(torch.from_numpy(a), torch.from_numpy(b), bits, 32 // gm, 16 // gn).numpy(),
        want)


@pytest.mark.parametrize("name", sorted(C.REGISTRY))
def test_product_table_fits_or_raises(name):
    """8-bit entries: the 16-bit table builds on the multiplier's own operand
    type (int8 for mul8s_*, uint8 for mul8u_*) and holds make_lut's values.
    12- and 16-bit entries on 8-bit operands fit or raise ValueError."""
    jm, tm = C.get(name), TC.get(name)
    dtype = torch.int8 if tm.signed else torch.uint8
    if tm.bits != 8:
        try:
            tbl = product_table(tm, dtype)
        except ValueError as e:
            assert "16-bit table range" in str(e)
            return
        vals = TC.operand_table(tm, tm.signed)
    else:
        tbl = product_table(tm, dtype)
        vals = torch.from_numpy(C.make_lut(jm).astype(np.int64))
    assert tbl.dtype == torch.int16 and tuple(tbl.shape) == (65536,)
    decoded = tbl.to(torch.int64) if tm.signed else tbl.to(torch.int64) & 0xFFFF
    np.testing.assert_array_equal(decoded.numpy(), vals.numpy())


def test_product_table_rejects_mismatched_operand_type():
    with pytest.raises(ValueError, match="16-bit table range"):
        product_table(TC.get("mul8s_exact"), torch.uint8)      # 255 * 255
    with pytest.raises(ValueError, match="16-bit table range"):
        product_table(TC.get("mul8u_exact"), torch.int8)       # uint32 wrap


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((8, 50), dtype=torch.int8)
    b = torch.zeros((50, 8), dtype=torch.int8)
    m = TC.get("mul8s_trunc0_4")
    with pytest.raises(ValueError, match="multiple of bk"):
        ax_matmul_blocks(a, b, m, bm=8, bn=8, bk=32)
    with pytest.raises(ValueError, match="int8 or uint8"):
        ax_matmul_blocks(a.to(torch.int32), b.to(torch.int32), m, bm=8, bn=8, bk=50)
    with pytest.raises(ValueError, match="int8 or uint8"):
        ax_matmul_blocks(a, b.to(torch.uint8), m, bm=8, bn=8, bk=50)
    with pytest.raises(ValueError, match="blocks"):
        ax_matmul_blocks(a, b, m, bm=256, bn=8, bk=50)
    with pytest.raises(ValueError):
        KernelSchedule(bm=0)
    with pytest.raises(ValueError):
        KernelSchedule(grid_order="km")


# ---------------------------------------------------------------------------
# ax_matmul_grid: a swap triple per output tile
# ---------------------------------------------------------------------------

def _mixed_grid(gm, gn, seed, bits=8):
    """(gm, gn, 3) int32 grid mixing NoSwap, A-side and B-side triples."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 2, (gm, gn)), rng.integers(0, bits, (gm, gn)),
                     rng.integers(0, 3, (gm, gn))], axis=-1).astype(np.int32)


@pytest.mark.parametrize("mname,lo,hi,dtype", [
    ("mul8s_trunc0_4", -128, 128, np.int8), ("mul8s_bam_v2_h1", -128, 128, np.int8),
    ("mul8s_drum3_4", -128, 128, np.int8), ("mul8s_mitch13_0", -128, 128, np.int8),
    ("mul8u_trunc0_4", 0, 256, np.uint8)])
@pytest.mark.parametrize("order", ["mn", "nm"])
def test_ax_matmul_grid_matches_jax(mname, lo, hi, dtype, order):
    """The grid kernel's plain version equals the JAX grid kernel (interpret
    mode) and both references, with tile histograms, on a grid that mixes
    NoSwap, A-side and B-side triples."""
    from repro.kernels.ref import ax_matmul_grid_ref as j_grid_ref
    a = _ops((32, 64), lo, hi, 30, dtype)
    b = _ops((64, 48), lo, hi, 31, dtype)
    grid = _mixed_grid(4, 3, 32)
    jo, jh = K.ax_matmul_grid(jnp.asarray(a), jnp.asarray(b), C.get(mname), jnp.asarray(grid),
                              schedule=K.KernelSchedule(bm=8, bn=16, bk=32, grid_order=order),
                              tile_hist=True)
    to, th = TK.ax_matmul_grid(torch.from_numpy(a), torch.from_numpy(b), TC.get(mname),
                               torch.from_numpy(grid), schedule=KernelSchedule(8, 16, 32, order),
                               tile_hist=True)
    assert to.dtype == th.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(
        to.numpy(), np.asarray(j_grid_ref(jnp.asarray(a), jnp.asarray(b), C.get(mname),
                                          jnp.asarray(grid))))
    ref = TK.ax_matmul_grid_ref(torch.from_numpy(a), torch.from_numpy(b), TC.get(mname),
                                torch.from_numpy(grid))
    np.testing.assert_array_equal(ref.numpy(), to.numpy())
    plain = TK.ax_matmul_grid(torch.from_numpy(a), torch.from_numpy(b), TC.get(mname),
                              torch.from_numpy(grid), schedule=KernelSchedule(8, 16, 32, order))
    np.testing.assert_array_equal(plain.numpy(), to.numpy())


def test_ax_matmul_grid_uniform_equals_static():
    a = _ops((16, 32), -128, 128, 33, np.int8)
    b = _ops((32, 24), -128, 128, 34, np.int8)
    m = TC.get("mul8s_drum3_4")
    for cfg in (TC.SwapConfig("A", 3, 0), TC.SwapConfig("B", 5, 1), None):
        grid = torch.tensor(TC.cfg_to_triple(cfg), dtype=torch.int32).expand(2, 3, 3)
        got = TK.ax_matmul_grid(torch.from_numpy(a), torch.from_numpy(b), m,
                                grid.contiguous(), schedule=KernelSchedule(8, 8, 32))
        want = TK.ax_matmul(torch.from_numpy(a), torch.from_numpy(b), m, cfg,
                            schedule=KernelSchedule(8, 8, 32))
        assert torch.equal(got, want)


def test_ax_matmul_grid_ragged_edges_match_zero_padded_jax():
    """Ragged M/N tiles read the last grid row/column; results equal the JAX
    grid kernel on the zero-padded operands, cropped."""
    M, K_, N, bm, bn, bk = 37, 64, 45, 16, 32, 32
    a = _ops((M, K_), -128, 128, 35, np.int8)
    b = _ops((K_, N), -128, 128, 36, np.int8)
    grid = _mixed_grid(3, 2, 37)
    ap = np.zeros((48, K_), np.int8)
    ap[:M] = a
    bp = np.zeros((K_, 64), np.int8)
    bp[:, :N] = b
    jo, jh = K.ax_matmul_grid(jnp.asarray(ap), jnp.asarray(bp), C.get("mul8s_bam_v4_h0"),
                              jnp.asarray(grid), tile_hist=True,
                              schedule=K.KernelSchedule(bm=bm, bn=bn, bk=bk))
    to, th = TK.ax_matmul_grid(torch.from_numpy(a), torch.from_numpy(b),
                               TC.get("mul8s_bam_v4_h0"), torch.from_numpy(grid),
                               schedule=KernelSchedule(bm, bn, bk), tile_hist=True)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo)[:M, :N])
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_ax_matmul_grid_wrapper_rejects_a_bad_grid():
    from repro_torch.kernels.ax_matmul import ax_matmul_grid_blocks
    a = torch.zeros((8, 32), dtype=torch.int8)
    b = torch.zeros((32, 16), dtype=torch.int8)
    m = TC.get("mul8s_trunc0_4")
    grid = torch.from_numpy(_mixed_grid(2, 1, 38))
    kw = dict(bm=4, bn=16, bk=32)
    assert ax_matmul_grid_blocks(a, b, m, grid, **kw).shape == (8, 16)
    with pytest.raises(ValueError, match="shape"):
        ax_matmul_grid_blocks(a, b, m, grid[:1], **kw)
    with pytest.raises(ValueError, match="int32"):
        ax_matmul_grid_blocks(a, b, m, grid.to(torch.int64), **kw)
    with pytest.raises(ValueError, match="cfg_grid on"):
        ax_matmul_grid_blocks(a, b, m, torch.zeros((2, 1, 3), dtype=torch.int32,
                                                   device="meta"), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ax_matmul_grid_blocks(a, b, m, torch.zeros((2, 1, 6), dtype=torch.int32)[..., ::2],
                              **kw)


# ---------------------------------------------------------------------------
# tuning_sweep (the CUDA kernel's wrapper; on the CPU its plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,sample_bits", [("mul8u_trunc0_4", None), ("mul8s_mitch10_13", None),
                                              ("mul12s_drum6_6", 8), ("mul16u_bam_v8_h0", 7)])
def test_tuning_sweep_wrapper_matches_jax_ref(name, sample_bits):
    """``tuning_sweep`` on a CPU tensor == ``repro.kernels.ref.tuning_sweep_ref``
    over the full grid: integer stats exact, float32 sums within 1e-6
    relative (float64 summation of the same float32 terms)."""
    import repro.kernels.ref as JR
    from repro_torch.kernels.tuning_sweep import STAT_NAMES, SURF_NAMES, tuning_sweep

    jm, tm = C.get(name), TC.get(name)
    vals = C.operand_values(jm.bits, jm.signed, sample_bits, 3)
    js = JR.tuning_sweep_ref(jm, jnp.asarray(vals), jnp.asarray(vals))
    ts = tuning_sweep(tm, torch.from_numpy(vals))
    for surf in SURF_NAMES:
        for stat in STAT_NAMES:
            want, got = np.asarray(js[surf][stat]), ts[surf][stat].numpy()
            if stat in ("sq", "rel"):
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(got, want.astype(np.int64))


def test_tuning_sweep_kernel_module_is_not_shadowed():
    """``kernels/__init__`` re-exports ``ax_matmul`` (a function shadowing the
    module) but not the ``tuning_sweep`` function."""
    import sys
    import types

    assert isinstance(TK.tuning_sweep, types.ModuleType)
    assert TK.tuning_sweep is sys.modules["repro_torch.kernels.tuning_sweep"]
    assert callable(TK.tuning_sweep.tuning_sweep)
    assert TK.tuning_sweep.LAUNCHES is not TK.LAUNCHES
    assert set(TK.LAUNCHES) == {"ax_matmul", "ax_matmul_grid"}
    assert "tuning_sweep" in TK._build.SOURCES
