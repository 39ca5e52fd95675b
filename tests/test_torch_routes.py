"""The two routes of the port's ``ax_matmul`` kernels, on the CPU.

The CUDA kernel runs only on the card, but what its route T implements can
run here: ``kernels/ref.py::ax_matmul_route_t_ref`` models it (limbs from
the 256-entry f/g tables, per-row-tile A-side masks, one B-form pass per
distinct B-side triple, column segments, K split into wrapped int32 partial
sums).  These tests hold that model bit for bit against the plain version
and against the JAX package (the Pallas kernels in interpret mode, and the
``mxu`` backend's ``_mxu_limbs`` / ``_stacked_mm``), check the route choice
over the whole REGISTRY, and check the launch plan's shapes.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as C
import repro.quant.ax as JQ
import repro_torch.core as TC
import repro_torch.kernels  # noqa: F401  (loads the submodules below)
from repro.kernels.ax_matmul import ax_matmul_grid_pallas, ax_matmul_pallas
from repro_torch.kernels.ref import (ax_matmul_grid_blocks_ref, ax_matmul_ref,
                                     ax_matmul_route_t_ref)

AXM = sys.modules["repro_torch.kernels.ax_matmul"]
DTYPES = {"int8": torch.int8, "uint8": torch.uint8}
SEPARABLE_8 = sorted(n for n, m in TC.REGISTRY.items()
                     if m.bits == 8 and m.desc[0] in ("trunc", "perforate"))


def _ops(shape, dtype, seed):
    lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int8 if dtype == torch.int8 else np.uint8)


def _tabs(name, dtype=None):
    m = TC.get(name)
    dtype = dtype or (torch.int8 if m.signed else torch.uint8)
    fg = AXM.fg_table(m, dtype)
    assert fg is not None, name
    return m, dtype, fg & 0xFF, (fg >> 8) & 0xFF


def _signed_tabs(name, dtype):
    """The f/g limb values (sign-extended for int8 operands)."""
    m, dtype, f, g = _tabs(name, dtype)
    if dtype == torch.int8:
        f, g = (torch.where(t > 127, t - 256, t) for t in (f, g))
    return m, dtype, f, g


def _mixed_grid(gm, gn, seed, bits=8):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 2, (gm, gn)), rng.integers(0, bits, (gm, gn)),
                     rng.integers(0, 3, (gm, gn))], axis=-1).astype(np.int32)


def _jax_route(name, dtype):
    """The expected route from the JAX package alone: separable in
    ``repro.quant.ax``, limbs fitting the operand type, and f(a) * g(b)
    equal to the JAX multiplier on all 65536 pairs."""
    fg = JQ.separable_transforms(name)
    if fg is None:
        return "C"
    jm = C.get(name)
    v = np.arange(256)
    v = np.where(v < 128, v, v - 256) if dtype == torch.int8 else v
    f, g = (np.asarray(t(jnp.asarray(v, jnp.int32))).astype(np.int64) for t in fg)
    lo, hi = (-128, 127) if dtype == torch.int8 else (0, 255)
    if min(f.min(), g.min()) < lo or max(f.max(), g.max()) > hi:
        return "C"
    a, b = np.repeat(v, 256), np.tile(v, 256)
    want = np.asarray(jm.fn(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32))).astype(np.int64)
    if not jm.signed:
        want &= 0xFFFFFFFF
    return "T" if np.array_equal(np.repeat(f, 256) * np.tile(g, 256), want) else "C"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(TC.REGISTRY))
def test_route_choice(name, dtype):
    """Route T exactly for the pairs the JAX package's factorization covers;
    a pair without a 16-bit product table has no route."""
    dt = DTYPES[dtype]
    m = TC.get(name)
    try:
        AXM.product_table(m, dt)
    except ValueError:
        with pytest.raises(ValueError, match="16-bit table range"):
            AXM.route_of(m, dt)
        return
    route = AXM.route_of(m, dt)
    assert route == _jax_route(name, dt)
    if m.bits == 8 and m.desc[0] in ("trunc", "perforate") and dt == (
            torch.int8 if m.signed else torch.uint8):
        assert route == "T"
    if route == "C":
        assert AXM.fg_table(m, dt) is None


def test_route_of_names_that_only_look_separable():
    """A swapped or LUT multiplier keeps route C however it is named, and
    a LUT named like a truncation takes route T only if its table
    factorizes."""
    base = TC.get("mul8s_trunc0_4")
    assert AXM.route_of(TC.swapped_mult(base, TC.SwapConfig("A", 3, 0)), torch.int8) == "C"
    lut = TC.lut_mult("lut_trunc0_4", TC.make_lut(base), True)
    assert AXM.route_of(lut, torch.int8) == "T"
    bad = TC.make_lut(base).clone()
    bad[5] += 1
    assert AXM.route_of(TC.lut_mult("lut_trunc0_4", bad, True), torch.int8) == "C"


CONFIGS = [None, ("A", 3, 0), ("A", 7, 1), ("B", 2, 1), ("B", 6, 0)]


@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=lambda c: "noswap" if c is None else "".join(map(str, c)))
@pytest.mark.parametrize("name", SEPARABLE_8)
def test_route_t_model_equals_plain_and_jax(name, cfg):
    """Static triples: the model (two row blocks, split K) == the plain
    version == ``ax_matmul_pallas`` (interpret mode) == the ``mxu``
    backend's stacked limbs."""
    m, dtype, f, g = _signed_tabs(name, None)
    a = _ops((40, 192), dtype, 1)
    b = _ops((192, 72), dtype, 2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    swap = TC.SwapConfig(*cfg) if cfg else None
    grid = torch.tensor([[TC.cfg_to_triple(swap)]], dtype=torch.int32)
    got = ax_matmul_route_t_ref(ta, tb, f, g, grid, 40, 72, block_rows=32, block_cols=32,
                                splits=2)
    want = ax_matmul_ref(ta, tb, m, swap)
    assert torch.equal(got, want)
    j = ax_matmul_pallas(jnp.asarray(a), jnp.asarray(b), C.get(name),
                         C.SwapConfig(*cfg) if cfg else None, block_m=8, block_n=24,
                         block_k=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))
    if cfg is not None and dtype == torch.int8:
        jf, jg = JQ.separable_transforms(name)
        limbs = JQ._mxu_limbs(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32), jf, jg,
                              C.SwapConfig(*cfg))
        np.testing.assert_array_equal(got.numpy(), np.asarray(JQ._stacked_mm(*limbs)))


@pytest.mark.parametrize("blocks", [(16, 128), (32, 32), (8, 16)])
@pytest.mark.parametrize("bm,bn", [(8, 24), (5, 7), (40, 72)])
@pytest.mark.parametrize("name", ["mul8s_trunc0_4", "mul8u_perf0_1", "mul8s_trunc1_5"])
def test_route_t_model_mixed_grid(name, bm, bn, blocks):
    """Grids mixing NoSwap, A-side and distinct B-side triples per row
    tile (which the JAX ``mxu`` backend rejects): model == plain ==
    ``ax_matmul_grid_pallas`` on the zero-padded operands, at CUDA blocks
    that cross logical tiles and logical tiles that cross CUDA blocks."""
    m, dtype, f, g = _signed_tabs(name, None)
    M, K, N = 40, 128, 72
    a = _ops((M, K), dtype, 3)
    b = _ops((K, N), dtype, 4)
    grid = _mixed_grid(-(-M // bm), -(-N // bn), 5)
    ta, tb, tg = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(grid)
    got = ax_matmul_route_t_ref(ta, tb, f, g, tg, bm, bn, block_rows=blocks[0],
                                block_cols=blocks[1], splits=3)
    assert torch.equal(got, ax_matmul_grid_blocks_ref(ta, tb, m, tg, bm, bn))
    Mp, Np = grid.shape[0] * bm, grid.shape[1] * bn
    ap = np.zeros((Mp, K), a.dtype)
    ap[:M] = a
    bp = np.zeros((K, Np), b.dtype)
    bp[:, :N] = b
    j = ax_matmul_grid_pallas(jnp.asarray(ap), jnp.asarray(bp), C.get(name),
                              jnp.asarray(grid), block_m=bm, block_n=bn, block_k=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j)[:M, :N])


def test_route_t_model_uint8_operands_of_a_signed_multiplier():
    """A signed multiplier whose table fits uint8 operands takes route T
    with u8 limbs."""
    name = next(n for n in sorted(TC.REGISTRY) if TC.get(n).signed and _fits_u8(n))
    m, dtype, f, g = _signed_tabs(name, torch.uint8)
    a, b = (torch.from_numpy(_ops(s, torch.uint8, 6 + i)) for i, s in
            enumerate([(20, 64), (64, 24)]))
    grid = torch.from_numpy(_mixed_grid(4, 3, 7))
    got = ax_matmul_route_t_ref(a, b, f, g, grid, 5, 8, block_rows=16, splits=1)
    assert torch.equal(got, ax_matmul_grid_blocks_ref(a, b, m, grid, 5, 8))


def _fits_u8(name):
    try:
        return AXM.route_of(TC.get(name), torch.uint8) == "T"
    except ValueError:
        return False


def test_route_t_model_sums_wrap_mod_2_32():
    """Partial sums of split K wrap as the plain version's int32 sum does."""
    m, dtype, f, g = _signed_tabs("mul8s_trunc0_4", torch.int8)
    K = 196608                                  # 16384 * K > 2^31
    a = torch.full((1, K), -128, dtype=torch.int8)
    b = torch.full((K, 8), -128, dtype=torch.int8)
    grid = torch.tensor([[[2, 0, 2]]], dtype=torch.int32)
    want = ax_matmul_ref(a, b, m, None)
    assert int(want[0, 0]) == (16384 * K) - (1 << 32)
    for splits in (1, 5):
        got = ax_matmul_route_t_ref(a, b, f, g, grid, 1, 8, splits=splits)
        assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["T", "C"])
@pytest.mark.parametrize("M,K,N", [(4, 8192, 29568), (4, 29568, 8192), (4, 8192, 8192),
                                   (128, 8192, 29568), (128, 29568, 8192), (128, 8192, 8192)])
def test_plan_fills_the_card_at_the_main_shapes(route, M, K, N):
    """At least 2 x 132 blocks at every main-path shape; route T covers all
    M <= 128 rows in one block row (B read once per call); every split has
    a K step; atomic sums wherever blocks or slots share an element."""
    p = AXM.plan(route, M, N, K, sms=132)
    rows = 16 * p.tile if route == "T" else p.slots * p.tile
    blocks = -(-M // rows) * -(-N // AXM.BLOCK_N) * p.splits
    assert blocks >= 2 * 132
    if route == "T":
        assert rows >= M
    steps = -(-K // AXM.K_STEP)
    kps = -(-steps // p.splits)
    assert (p.splits - 1) * kps < steps
    assert p.atomic == (p.splits > 1 or p.slots < 8)


@pytest.mark.parametrize("M", [1, 3, 4, 8, 17, 37, 128, 300])
def test_plan_shapes(M):
    t, c = AXM.plan("T", M, 45, 50), AXM.plan("C", M, 45, 50)
    assert t.tile in (1, 2, 4, 8) and 16 * t.tile >= min(M, 128)
    assert c.slots * c.tile >= min(M, 64) and c.slots in (1, 2, 4, 8)
    assert t.splits == c.splits == 1                  # one K step
    with pytest.raises(ValueError, match="route"):
        AXM.plan("X", M, 45, 50)


def test_forced_route_t_on_an_inseparable_multiplier_raises():
    a = torch.zeros((4, 64), dtype=torch.int8)
    b = torch.zeros((64, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="route T takes separable"):
        AXM.launch_args("ax_matmul", a, b, TC.get("mul8s_drum3_4"), None, (2, 0, 2), 4, 8, 64,
                        "mn", False, "T", 132)


@pytest.mark.parametrize("route,name", [("T", "mul8s_trunc0_4"), ("C", "mul8s_drum3_4"),
                                        ("C", "mul8s_trunc0_4")])
@pytest.mark.parametrize("grid", [False, True])
def test_launch_args_layout(route, name, grid):
    """The C argument list: pointers, then the ints in the order of
    ``csrc/ax_matmul.cu``; the table of the route only; the output zeroed
    when sums are atomic; a histogram workspace of (gm + gn) x 9."""
    m = TC.get(name)
    a = torch.zeros((4, 128), dtype=torch.int8)
    b = torch.zeros((128, 200), dtype=torch.int8)
    cfg = torch.zeros((2, 2, 3), dtype=torch.int32) if grid else None
    nm = "ax_matmul_grid" if grid else "ax_matmul"
    args, out, hist, work = AXM.launch_args(nm, a, b, m, cfg, () if grid else (1, 3, 0), 2, 128,
                                            64, "nm", True, route, 132)
    n_ptr = 8 if grid else 7
    assert len(args) == n_ptr + (16 if grid else 19) + 1 and args[-1] is None
    table, fg = args[2], args[3]
    assert (table is None) == (route == "T") and (fg is None) == (route == "C")
    ints = args[n_ptr:-1]
    p = AXM.plan(route, 4, 200, 128, 132)
    assert ints[:6] == [4, 200, 128, 2, 128, 64]
    assert ints[-7:] == [1, AXM.ROUTES.index(route), p.tile, p.slots, p.splits, int(p.atomic), 0]
    assert tuple(hist.shape) == (2, 2, 2, 9) and tuple(work.shape) == (36,)
    assert not work.any() and (not p.atomic or not out.any())
