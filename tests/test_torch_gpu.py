"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA device: it carries the ``gpu`` marker and
skips through the ``cuda`` fixture where there is none (decided when the
test runs, never at import, so every pytest-xdist worker collects the same
tests).  On the machine with the card:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the card's machine has none.
"""
import dataclasses
import math
import sys

import pytest
import torch

import repro_torch.core as TC
import repro_torch.kernels  # noqa: F401  (loads the submodules below)
from repro_torch.configs import qwen2_72b, reduced
from repro_torch.configs.base import AxPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ax_matmul_grid_blocks_ref, ax_matmul_ref, tile_hist_blocks
from repro_torch.kernels.schedule import KernelSchedule
from repro_torch.launch.serve import drift_hook
from repro_torch.models import init_params, prefill
from repro_torch.quant.ax import ax_dense
from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy
from repro_torch.serve import ServeConfig, generate

AXM = sys.modules["repro_torch.kernels.ax_matmul"]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    return torch.device("cuda", 0)


def _ops(shape, signed, seed, dev):
    g = torch.Generator().manual_seed(seed)
    lo, hi = (-128, 128) if signed else (0, 256)
    return torch.randint(lo, hi, shape, generator=g).to(
        torch.int8 if signed else torch.uint8).to(dev)


@pytest.mark.parametrize("name", ["mul8s_trunc0_4", "mul8s_bam_v2_h1", "mul8u_mitch13_0",
                                  "mul8s_drum3_4", "mul16s_exact"])
@pytest.mark.parametrize("swap", [None, ("A", 3, 1), ("B", 6, 0)])
def test_kernel_equals_plain(cuda, name, swap):
    m = TC.get(name)
    sw = TC.SwapConfig(*swap) if swap else None
    a = _ops((37, 96), m.signed, 1, cuda)
    b = _ops((96, 45), m.signed, 2, cuda)
    sched = KernelSchedule(16, 32, 32, "nm")
    out, hist = ops.ax_matmul(a, b, m, sw, schedule=sched, tile_hist=True)
    torch.cuda.synchronize()
    assert torch.equal(out, ax_matmul_ref(a, b, m, sw))
    assert torch.equal(hist, tile_hist_blocks(a, b, m.bits, 16, 32))


def test_cuda_call_launches_the_kernel_and_never_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version taken for a CUDA tensor")

    monkeypatch.setattr(AXM, "ax_matmul_plain", refuse)
    monkeypatch.setattr(AXM, "ax_matmul_ref", refuse)
    a = _ops((4, 128), True, 3, cuda)
    b = _ops((128, 256), True, 4, cuda)
    before = AXM.LAUNCHES["ax_matmul"]
    out = ops.ax_matmul(a, b, TC.get("mul8s_trunc0_4"), TC.SwapConfig("A", 3, 0))
    torch.cuda.synchronize()
    assert AXM.LAUNCHES["ax_matmul"] == before + 1
    assert out.device.type == "cuda" and out.dtype == torch.int32


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    a = _ops((8, 64), True, 5, cuda)
    b = _ops((64, 32), True, 6, cuda)
    m = TC.get("mul8s_trunc0_4")
    with pytest.raises(ValueError, match="contiguous"):
        AXM.ax_matmul_blocks(a, b.t().contiguous().t(), m, bm=8, bn=32, bk=32)
    with pytest.raises(ValueError, match="16-bit table range"):
        AXM.ax_matmul_blocks(a.to(torch.uint8), b.to(torch.uint8), m, bm=8, bn=32, bk=32)
    with pytest.raises(ValueError, match="multiple of bk"):
        AXM.ax_matmul_blocks(a, b, m, bm=8, bn=32, bk=48)


def test_ax_dense_on_the_card_equals_the_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(7)
    x = torch.randn((3, 5, 192), generator=g)
    w = torch.randn((192, 160), generator=g) * 0.05
    pol = AxPolicy(backend="kernel", mult_name="mul8s_bam_v2_h1")
    want = ax_dense(x, w, pol)
    got = ax_dense(x.to(cuda), w.to(cuda), pol).cpu()
    assert torch.equal(got, want)


def test_reduced_model_on_the_card_matches_the_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(qwen2_72b), n_layers=2, compute_dtype="float32",
                              ax=AxPolicy(backend="kernel"))
    p_cpu = init_params(cfg, seed=5, device="cpu")

    def to(t):
        if isinstance(t, dict):
            return {k: to(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to(v) for v in t]
        return t.to(cuda)

    p_gpu = to(p_cpu)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(6))
    with torch.inference_mode():
        lc, _ = prefill(p_cpu, {"tokens": toks}, cfg, max_cache_len=16)
        lg, _ = prefill(p_gpu, {"tokens": toks.to(cuda)}, cfg, max_cache_len=16)
    # f32 sums in another order; an int8 rounding flip moves a logit by ~1e-2
    assert (lc - lg.cpu()).abs().max().item() <= 5e-2
    before = AXM.LAUNCHES["ax_matmul"]
    generate(p_gpu, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=3))
    assert AXM.LAUNCHES["ax_matmul"] - before == cfg.n_layers * 4 * 3


def _mixed_grid(gm, gn, seed, bits=8):
    """A (gm, gn, 3) int32 grid mixing NoSwap, A-side and B-side triples."""
    g = torch.Generator().manual_seed(seed)
    op = torch.randint(0, 2, (gm, gn), generator=g)
    bit = torch.randint(0, bits, (gm, gn), generator=g)
    val = torch.randint(0, 3, (gm, gn), generator=g)            # 2 = NoSwap
    return torch.stack([op, bit, val], dim=-1).to(torch.int32).contiguous()


@pytest.mark.parametrize("name", ["mul8s_trunc0_4", "mul8s_bam_v2_h1", "mul8u_mitch13_0",
                                  "mul8s_drum3_4", "mul16s_exact"])
@pytest.mark.parametrize("order", ["mn", "nm"])
def test_grid_kernel_equals_plain(cuda, name, order):
    m = TC.get(name)
    a = _ops((37, 96), m.signed, 11, cuda)
    b = _ops((96, 45), m.signed, 12, cuda)
    bm, bn = 16, 32
    grid = _mixed_grid(3, 2, 13).to(cuda)
    sched = KernelSchedule(bm, bn, 32, order)
    out, hist = ops.ax_matmul_grid(a, b, m, grid, schedule=sched, tile_hist=True)
    plain = ops.ax_matmul_grid(a, b, m, grid, schedule=sched)
    torch.cuda.synchronize()
    assert torch.equal(out, ax_matmul_grid_blocks_ref(a, b, m, grid, bm, bn))
    assert torch.equal(plain, out)
    assert torch.equal(hist, tile_hist_blocks(a, b, m.bits, bm, bn))


def test_grid_cuda_call_launches_the_kernel_and_never_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version taken for a CUDA tensor")

    for fn in ("ax_matmul_grid_plain", "ax_matmul_grid_blocks_ref", "tile_hist_blocks"):
        monkeypatch.setattr(AXM, fn, refuse)
    a = _ops((4, 128), True, 14, cuda)
    b = _ops((128, 256), True, 15, cuda)
    before = AXM.LAUNCHES["ax_matmul_grid"]
    out = ops.ax_matmul_grid(a, b, TC.get("mul8s_trunc0_4"), _mixed_grid(1, 2, 16).to(cuda))
    torch.cuda.synchronize()
    assert AXM.LAUNCHES["ax_matmul_grid"] == before + 1
    assert out.device.type == "cuda" and out.dtype == torch.int32


def test_grid_wrapper_raises_on_a_bad_grid(cuda):
    a = _ops((8, 64), True, 17, cuda)
    b = _ops((64, 32), True, 18, cuda)
    m = TC.get("mul8s_trunc0_4")
    good = _mixed_grid(2, 1, 19).to(cuda)
    kw = dict(bm=4, bn=32, bk=32)
    with pytest.raises(ValueError, match="shape"):
        AXM.ax_matmul_grid_blocks(a, b, m, good[:1].contiguous(), **kw)
    with pytest.raises(ValueError, match="int32"):
        AXM.ax_matmul_grid_blocks(a, b, m, good.to(torch.int64), **kw)
    with pytest.raises(ValueError, match="cfg_grid on"):
        AXM.ax_matmul_grid_blocks(a, b, m, good.cpu(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        AXM.ax_matmul_grid_blocks(a, b, m, good.repeat(1, 1, 2)[..., ::2], **kw)


def test_grid_launch_does_not_synchronise(cuda):
    a = _ops((4, 256), True, 20, cuda)
    b = _ops((256, 384), True, 21, cuda)
    m = TC.get("mul8s_trunc0_4")
    grid = _mixed_grid(2, 3, 22).to(cuda)
    other = _mixed_grid(2, 3, 23).to(cuda)
    sched = KernelSchedule(2, 128, 128)
    ops.ax_matmul_grid(a, b, m, grid, schedule=sched)          # table, library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, hist = ops.ax_matmul_grid(a, b, m, grid, schedule=sched, tile_hist=True)
        grid.copy_(other)                                      # a new policy value
        ops.ax_matmul_grid(a, b, m, grid, schedule=sched)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tuple(hist.shape) == (2, 3, 2, 9)


# (M, K, N, bm, bn, bk): decode rows, a split K with the tile mode's bm,
# a ragged N that is no multiple of 16 (byte staging), a full route-T block
ROUTE_CASES = [(1, 256, 200, 1, 128, 128), (4, 4096, 384, 2, 128, 128),
               (17, 192, 45, 16, 32, 64), (128, 512, 256, 64, 128, 128)]
ROUTE_MULTS = [("mul8s_trunc0_4", "T"), ("mul8u_perf0_1", "T"), ("mul8s_drum3_4", "C"),
               ("mul8u_mitch13_0", "C")]


@pytest.mark.parametrize("order", ["mn", "nm"])
@pytest.mark.parametrize("name,route", ROUTE_MULTS)
@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: "x".join(map(str, c[:3])))
def test_both_routes_equal_plain(cuda, case, name, route, order):
    """Each route against the plain version: static NoSwap, A-side and
    B-side triples, and a mixed grid, with and without ``tile_hist``."""
    M, K, N, bm, bn, bk = case
    m = TC.get(name)
    assert AXM.route_of(m, torch.int8 if m.signed else torch.uint8) == route
    a = _ops((M, K), m.signed, 31, cuda)
    b = _ops((K, N), m.signed, 32, cuda)
    kw = dict(bm=bm, bn=bn, bk=bk, grid_order=order)
    for i, swap in enumerate([None, TC.SwapConfig("A", 3, 0), TC.SwapConfig("B", 6, 1)]):
        out = AXM.ax_matmul_blocks(a, b, m, swap, tile_hist=i == 0, **kw)
        torch.cuda.synchronize()
        if i == 0:
            out, hist = out
            assert torch.equal(hist, tile_hist_blocks(a, b, m.bits, bm, bn))
        assert torch.equal(out, ax_matmul_ref(a, b, m, swap)), swap
    grid = _mixed_grid(-(-M // bm), -(-N // bn), 33).to(cuda)
    for hist in (False, True):
        got = AXM.ax_matmul_grid_blocks(a, b, m, grid, tile_hist=hist, **kw)
        torch.cuda.synchronize()
        if hist:
            got, h = got
            assert torch.equal(h, tile_hist_blocks(a, b, m.bits, bm, bn))
        assert torch.equal(got, ax_matmul_grid_blocks_ref(a, b, m, grid, bm, bn))


@pytest.mark.parametrize("name", ["mul8s_trunc0_4", "mul8s_trunc1_5", "mul8u_trunc2_4"])
@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: "x".join(map(str, c[:3])))
def test_route_t_equals_route_c(cuda, case, name):
    """On a separable multiplier the tensor-core route and the table route
    (forced through the wrappers' private ``_route``) give the same bits."""
    M, K, N, bm, bn, bk = case
    m = TC.get(name)
    a = _ops((M, K), m.signed, 34, cuda)
    b = _ops((K, N), m.signed, 35, cuda)
    grid = _mixed_grid(-(-M // bm), -(-N // bn), 36).to(cuda)
    kw = dict(bm=bm, bn=bn, bk=bk)
    t = AXM.ax_matmul_blocks(a, b, m, TC.SwapConfig("A", 5, 1), _route="T", **kw)
    c = AXM.ax_matmul_blocks(a, b, m, TC.SwapConfig("A", 5, 1), _route="C", **kw)
    tg = AXM.ax_matmul_grid_blocks(a, b, m, grid, _route="T", **kw)
    cg = AXM.ax_matmul_grid_blocks(a, b, m, grid, _route="C", **kw)
    torch.cuda.synchronize()
    assert torch.equal(t, c) and torch.equal(tg, cg)


def test_forced_route_t_raises_on_an_inseparable_multiplier(cuda):
    a = _ops((4, 64), True, 37, cuda)
    b = _ops((64, 32), True, 38, cuda)
    with pytest.raises(ValueError, match="route T takes separable"):
        AXM.ax_matmul_blocks(a, b, TC.get("mul8s_drum3_4"), bm=4, bn=32, bk=64, _route="T")


def test_adaptive_generate_on_the_card_equals_the_cpu(cuda):
    """Reduced qwen2 in f32 with synthetic drift, scalar and tile mode: the
    same greedy tokens and the same re-tunes on the card as on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(qwen2_72b), n_layers=2, compute_dtype="float32",
                              ax=AxPolicy(backend="kernel"))
    p_cpu = init_params(cfg, seed=5, device="cpu")
    p_gpu = _to(p_cpu, cuda)
    toks = torch.randint(0, cfg.vocab, (4, 8), generator=torch.Generator().manual_seed(6))
    for tile_rows in (0, 2):
        runs = []
        for params, dev in ((p_cpu, "cpu"), (p_gpu, cuda)):
            ctrl = AdaptiveController(
                SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                AdaptiveConfig(min_observe_steps=2, cooldown_steps=2, drift_threshold=0.02,
                               tile_rows=tile_rows), device=dev)
            before = AXM.LAUNCHES["ax_matmul_grid"]
            out = generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=12),
                           adaptive=ctrl, param_hook=drift_hook(3, 0.05)).cpu()
            events = [e.describe() for e in ctrl.retunes + ctrl.tile_retunes]
            runs.append((out, events, AXM.LAUNCHES["ax_matmul_grid"] - before))
        (tc, ec, _), (tg, eg, launches) = runs
        assert ec, "the drift should re-tune"
        assert torch.equal(tc, tg) and ec == eg
        assert launches == cfg.n_layers * 4 * 11


def _to(t, dev):
    if isinstance(t, dict):
        return {k: _to(v, dev) for k, v in t.items()}
    if isinstance(t, list):
        return [_to(v, dev) for v in t]
    return t.to(dev)


# ---------------------------------------------------------------------------
# tuning_sweep
# ---------------------------------------------------------------------------

TS = sys.modules["repro_torch.kernels.tuning_sweep"]


def _sweep_equal(got, want):
    for surf in TS.SURF_NAMES:
        for st in TS.STAT_NAMES:
            if st in ("sq", "rel"):
                torch.testing.assert_close(got[surf][st], want[surf][st], rtol=1e-6, atol=0)
            else:
                assert torch.equal(got[surf][st], want[surf][st]), (surf, st)


@pytest.mark.parametrize("name,sample_bits,n", [
    ("mul8u_trunc0_4", None, None), ("mul8s_bam_v2_h1", None, None), ("mul8u_perf0_1", None, None),
    ("mul8s_mitch13_0", None, None), ("mul8u_drum2_6", None, None), ("mul8s_exact", None, None),
    ("mul12s_mitch10_13", 9, 300), ("mul16s_drum5_8", 10, None), ("mul16u_bam_v4_h1", 9, 333)])
def test_sweep_kernel_equals_plain(cuda, name, sample_bits, n):
    m = TC.get(name)
    vals = torch.from_numpy(TC.operand_values(m.bits, m.signed, sample_bits, 2)[:n].copy()).to(cuda)
    got = TS.tuning_sweep(m, vals)
    want = TS.tuning_sweep_plain(m, vals)
    torch.cuda.synchronize()
    _sweep_equal(got, want)


@pytest.mark.parametrize("name", ["mul16s_bam_v4_h1", "mul12u_drum4_6", "mul8s_mitch10_13",
                                  "mul16u_trunc0_8"])
@pytest.mark.parametrize("n", [1, 31, 127, 128, 129, 300, 4096])
def test_sweep_kernel_equals_plain_at_every_split(cuda, name, n):
    """N around a warp's and a block's width and the 12-bit width: each N
    takes its own rows per block (``plan``); at N = 4096 the plain version
    runs on 256 sampled rows."""
    m = TC.get(name)
    g = torch.Generator().manual_seed(n)
    lo, hi = (-(1 << (m.bits - 1)), 1 << (m.bits - 1)) if m.signed else (0, 1 << m.bits)
    vals = torch.randint(lo, hi, (n,), generator=g, dtype=torch.int32).to(cuda)
    got = TS.tuning_sweep(m, vals)
    rows = None if n < 4096 else torch.randperm(n, generator=g)[:256].to(cuda)
    want = TS.tuning_sweep_plain(m, vals, rows=rows)
    torch.cuda.synchronize()
    if rows is not None:
        got = {surf: {st: v[rows] for st, v in d.items()} for surf, d in got.items()}
    _sweep_equal(got, want)


@pytest.mark.parametrize("name", ["mul16s_mitch10_13", "mul12s_trunc1_7"])
def test_sweep_kernel_gives_the_same_bits_twice(cuda, name):
    m = TC.get(name)
    vals = torch.from_numpy(TC.operand_values(m.bits, m.signed, 12)).to(cuda)
    first, second = TS.tuning_sweep(m, vals), TS.tuning_sweep(m, vals)
    torch.cuda.synchronize()
    for surf in TS.SURF_NAMES:
        for st in TS.STAT_NAMES:
            assert torch.equal(first[surf][st], second[surf][st]), (surf, st)


@pytest.mark.parametrize("bits,v,h,signed", [(16, 16, 0, False), (16, 12, 1, True),
                                             (8, 10, 0, False), (12, 2, 5, False)])
def test_sweep_kernel_broken_arrays_beyond_the_registry(cuda, bits, v, h, signed):
    """16, 11, 8 and 0 masked rows: BrokenArray<S, R> up to the most a
    16-bit width gives (48 KiB of staged values at 16 rows)."""
    m = TC.broken_array(bits, v, h, signed)
    vals = torch.from_numpy(TC.operand_values(bits, signed, min(bits, 8), 3)).to(cuda)
    got = TS.tuning_sweep(m, vals)
    want = TS.tuning_sweep_plain(m, vals)
    torch.cuda.synchronize()
    assert TS.instance(m) == f"BrokenArray<{str(signed).lower()}, {max(0, min(v, bits) - h)}>"
    _sweep_equal(got, want)


def test_sweep_kernel_lut_equals_plain(cuda):
    base = TC.get("mul8u_mitch13_0")
    m = TC.lut_mult("lut", TC.make_lut(base), False)
    vals = torch.from_numpy(TC.operand_values(8, False)).to(cuda)
    _sweep_equal(TS.tuning_sweep(m, vals), TS.tuning_sweep_plain(base, vals))


def test_sweep_cuda_call_launches_the_kernel_and_never_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version taken for a CUDA tensor")

    monkeypatch.setattr(TS, "tuning_sweep_plain", refuse)
    monkeypatch.setattr(TS, "tuning_sweep_ref", refuse)
    before = TS.LAUNCHES["tuning_sweep"]
    res = TC.component_sweep(TC.get("mul8u_trunc0_4"), device=cuda)
    assert TS.LAUNCHES["tuning_sweep"] == before + 1
    assert res.reduction("mae") > 0.05
    with pytest.raises(ValueError, match="no kernel descriptor"):
        TS.tuning_sweep(TC.oracle_mult(TC.get("mul8u_trunc0_4")),
                        torch.arange(256, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("name,sample_bits", [("mul8s_drum3_4", None), ("mul16s_bam_v4_h1", 9)])
def test_component_sweep_on_the_card_equals_the_cpu(cuda, name, sample_bits):
    m = TC.get(name)
    g = TC.component_sweep(m, sample_bits=sample_bits, device=cuda)
    c = TC.component_sweep(m, sample_bits=sample_bits, device="cpu")
    for x, y in [(g.noswap, c.noswap), (g.oracle, c.oracle)] + \
            [(g.per_config[k], c.per_config[k]) for k in c.per_config]:
        assert (x.n, x.sum_abs, x.max_abs, x.count_neq) == (y.n, y.sum_abs, y.max_abs, y.count_neq)
    assert g.best("mae") == c.best("mae")


def test_sobel_on_the_card_equals_the_cpu(cuda):
    import repro_torch.apps as TA

    app, m = TA.ALL_APPS["sobel"], TC.get("mul16s_drum5_8")
    vg, og = TA.evaluate(app, TC.SwapConfig("A", 2, 1), mult=m, n=40, device=cuda)
    vc, oc = TA.evaluate(app, TC.SwapConfig("A", 2, 1), mult=m, n=40, device="cpu")
    assert torch.equal(og.cpu(), oc)
    assert vg == pytest.approx(vc, rel=1e-6)


# ---------------------------------------------------------------------------
# the serving path: mxu, per-slot decode, CUDA graphs
# ---------------------------------------------------------------------------

def _serve_cfg(backend="mxu"):
    return dataclasses.replace(reduced(qwen2_72b), n_layers=2, compute_dtype="float32",
                               ax=AxPolicy(backend=backend))


@pytest.mark.parametrize("mname", ["mul8s_trunc0_4", "mul8s_perf0_1"])
def test_mxu_equals_kernel_on_the_card(cuda, mname):
    import repro_torch.quant.ax as TQ

    a, b = _ops((4, 96), True, 41, cuda), _ops((96, 40), True, 42, cuda)
    grid = torch.tensor([[[1, 3, 0]], [[0, 5, 1]]], dtype=torch.int32, device=cuda)
    for swap in [dict(swap_enabled=False), dict(), dict(swap_operand="B", swap_bit=6)]:
        mx, kn = AxPolicy(mult_name=mname, backend="mxu", **swap), \
            AxPolicy(mult_name=mname, backend="kernel", **swap)
        before = AXM.LAUNCHES["ax_matmul"]
        got = TQ.ax_matmul_int(a, b, mx)
        assert AXM.LAUNCHES["ax_matmul"] == before + 1          # route T, one launch
        assert torch.equal(got, TQ.ax_matmul_int(a, b, kn))
        assert torch.equal(got.cpu(), TQ.ax_matmul_int(a.cpu(), b.cpu(), mx))
    for dyn in (torch.tensor([0, 2, 1], dtype=torch.int32, device=cuda), grid):
        got = TQ.ax_matmul_int_dyn(a, b, AxPolicy(mult_name=mname, backend="mxu"), dyn)
        assert torch.equal(got.cpu(), TQ.ax_matmul_int_dyn(
            a.cpu(), b.cpu(), AxPolicy(mult_name=mname, backend="mxu"), dyn.cpu()))


def test_mxu_refuses_unsigned_on_int8_on_the_card(cuda):
    import repro_torch.quant.ax as TQ

    a, b = _ops((4, 32), True, 43, cuda), _ops((32, 8), True, 44, cuda)
    with pytest.raises(ValueError, match="refuses"):
        TQ.ax_matmul_int(a, b, AxPolicy(mult_name="mul8u_trunc0_4", backend="mxu"))


def _graph_counts():
    from repro_torch.serve import graph as G

    return sum(G.CAPTURES.values()), sum(G.REPLAYS.values())


@pytest.mark.parametrize("backend", ["mxu", "kernel"])
def test_graph_replay_equals_eager_static(cuda, backend):
    cfg = _serve_cfg(backend)
    params = init_params(cfg, seed=7, device=cuda)
    toks = torch.randint(0, cfg.vocab, (3, 8), generator=torch.Generator().manual_seed(8))
    kw = dict(prompt_lens=[8, 5, 3], slot_new_tokens=[6, 2, 6], max_cache_len=16)
    eager = generate(params, {"tokens": toks}, cfg,
                     ServeConfig(max_new_tokens=6, cuda_graphs=False, eos_id=7), **kw)
    c0, r0 = _graph_counts()
    stats = {}
    g1 = generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=6, eos_id=7),
                  stats=stats, **kw)
    c1, r1 = _graph_counts()
    g2 = generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=6, eos_id=7), **kw)
    c2, r2 = _graph_counts()
    assert stats["path"] == "graph"
    assert torch.equal(eager, g1) and torch.equal(eager, g2)
    assert c1 - c0 == 1 and c2 == c1                  # one capture, then replays only
    assert r1 - r0 == 4 and r2 - r1 == 5
    cpu = generate(_to(params, "cpu"), {"tokens": toks}, cfg,
                   ServeConfig(max_new_tokens=6, eos_id=7), **kw)
    assert torch.equal(eager.cpu(), cpu)


def test_graph_fused_adaptive_equals_eager_and_a_policy_update_recaptures_nothing(cuda):
    cfg = _serve_cfg("kernel")
    params = init_params(cfg, seed=9, device=cuda)
    toks = torch.randint(0, cfg.vocab, (4, 8), generator=torch.Generator().manual_seed(10))

    def ctrl(tile_rows):
        return AdaptiveController(SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                  AdaptiveConfig(min_observe_steps=10 ** 6,
                                                 tile_rows=tile_rows), device=cuda)

    for tile_rows in (0, 2):
        runs = {}
        for graphs in (False, True):
            c = ctrl(tile_rows)
            out = generate(params, {"tokens": toks}, cfg,
                           ServeConfig(max_new_tokens=6, observe_every=2, cuda_graphs=graphs),
                           adaptive=c)
            runs[graphs] = (out, c.telemetry.snapshot())
        assert torch.equal(runs[False][0], runs[True][0])
        for t, snap in runs[False][1].items():
            for f, v in snap.items():
                w = runs[True][1][t][f]
                assert (v == w).all() if hasattr(v, "shape") else v == w, (t, f)
        c = ctrl(tile_rows)
        c.policy.set_config("mlp", TC.SwapConfig("B", 5, 1))
        c0, _ = _graph_counts()
        upd = generate(params, {"tokens": toks}, cfg,
                       ServeConfig(max_new_tokens=6, observe_every=2), adaptive=c)
        assert _graph_counts()[0] == c0                 # a new value, not a new graph
        ce = ctrl(tile_rows)
        ce.policy.set_config("mlp", TC.SwapConfig("B", 5, 1))
        want = generate(params, {"tokens": toks}, cfg,
                        ServeConfig(max_new_tokens=6, observe_every=2, cuda_graphs=False),
                        adaptive=ce)
        assert torch.equal(upd, want)


def test_graph_token_step_equals_eager_and_a_splice_recaptures_nothing(cuda):
    from repro_torch.models import init_cache
    from repro_torch.serve import prefill_one, splice_slot, token_step

    cfg = _serve_cfg("mxu")
    params = init_params(cfg, seed=11, device=cuda)
    g = torch.Generator().manual_seed(12)
    reqs = [torch.randint(0, cfg.vocab, (n,), generator=g) for n in (8, 5, 3, 7)]
    results = {}
    for graphs in (False, True):
        cache = init_cache(cfg, 3, 16, device=cuda)
        tok = torch.zeros(3, dtype=torch.int64, device=cuda)
        pos = torch.zeros(3, dtype=torch.int64, device=cuda)
        for s, p in enumerate(reqs[:3]):
            first, fresh = prefill_one(params, p[None], len(p), cfg, max_cache_len=16)
            splice_slot(cache, fresh, s)
            tok[s], pos[s] = first[0], len(p)
        active = torch.tensor([True, True, True], device=cuda)
        seq, caps = [], []
        for step in range(5):
            if step == 2:                          # a fresh request into slot 1
                first, fresh = prefill_one(params, reqs[3][None], len(reqs[3]), cfg,
                                           max_cache_len=16)
                splice_slot(cache, fresh, torch.tensor(1, device=cuda))
                tok[1], pos[1] = first[0], len(reqs[3])
            if step == 3:
                active[2] = False
            tok, cache = token_step(params, cache, tok, pos, active, cfg, cuda_graphs=graphs)
            pos = pos + active.long()
            seq.append(tok.cpu())
            caps.append(_graph_counts()[0])
        results[graphs] = torch.stack(seq)
        if graphs:
            assert caps[1:] == [caps[0]] * 4           # splices re-capture nothing
    assert torch.equal(results[False], results[True])


def test_replica_adoption_on_the_card_recaptures_nothing(cuda, tmp_path):
    """A PolicyReader on the card serving the fused graph path: each adopted
    version reaches the captured graph as values (no new capture), its tokens
    equal an eager controller serve of ``store.load(version)``, and
    ``repro_retraces_total`` counts exactly the captures."""
    from repro_torch import obs
    from repro_torch.fleet import PolicyReader, PolicyStore
    from repro_torch.serve import graph as G

    cfg = _serve_cfg("kernel")
    params = init_params(cfg, seed=13, device=cuda)
    toks = torch.randint(0, cfg.vocab, (4, 8), generator=torch.Generator().manual_seed(14))
    store = PolicyStore(str(tmp_path))
    store.publish(SwapPolicy.from_ax_policy(cfg.ax))
    replica = PolicyReader(store, cfg.ax.targets, device=cuda)
    generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=6), adaptive=replica)
    c0, _ = _graph_counts()
    for mlp, attn in ((("B", 5, 1), ("A", 6, 1)), (("A", 1, 0), None), (("A", 7, 1), ("B", 2, 0))):
        p = SwapPolicy.from_ax_policy(cfg.ax)
        p.set_config("mlp", TC.SwapConfig(*mlp))
        p.set_config("attn_out", None if attn is None else TC.SwapConfig(*attn))
        v = store.publish(p)
        assert replica.staleness() == 1 and replica.poll() is True and replica.staleness() == 0
        got = generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=6),
                       adaptive=replica)
        assert _graph_counts()[0] == c0
        ref = AdaptiveController(store.load(v), cfg.ax.targets,
                                 AdaptiveConfig(drift_threshold=1e9), device=cuda)
        want = generate(params, {"tokens": toks}, cfg,
                        ServeConfig(max_new_tokens=6, cuda_graphs=False), adaptive=ref)
        assert torch.equal(got, want), v
    by_kind = G.captures_by_kind()
    for kind, n in by_kind.items():
        assert obs.retrace_total(kind) == n, kind


def test_rollback_on_the_card_equals_the_cpu(cuda, tmp_path):
    """The auto-rollback stream scored on the card: the same audit events
    (exact scores) as on the CPU, CURRENT re-pointed to last-good and the
    pre-adoption policy restored byte for byte."""
    import numpy as np

    from repro_torch.fleet import PolicyStore

    ctrls = {}
    for dev in (cuda, "cpu"):
        store = PolicyStore(str(tmp_path / str(dev)))
        c = AdaptiveController(
            SwapPolicy("mul8u_trunc0_4", configs={"*": None}), ("stream",),
            AdaptiveConfig(decay=0.4, drift_threshold=10.0, min_observe_steps=1,
                           cooldown_steps=0, buffer_size=1024, canary=True,
                           rollback_guard=0.5, rollback_min_steps=2, rollback_window=32),
            store=store, device=dev)
        c.warmup()
        c.resume_from_store()
        rng = np.random.default_rng(6)
        for _ in range(4):
            c.observe_operands("stream", rng.integers(0, 64, 2048), rng.integers(0, 64, 2048))
        assert c.retune("stream").promoted
        for _ in range(12):
            c.observe_operands("stream", rng.integers(128, 256, 2048),
                               rng.integers(128, 256, 2048))
        ctrls[str(dev)] = c
    g, h = ctrls[str(cuda)], ctrls["cpu"]
    strip = lambda c: [{k: v for k, v in e.items() if k != "unix_time"} for e in c.audit.read()]
    assert strip(g) == strip(h)
    assert len(g.rollbacks) == 1 and g.store.current_version() == 1
    assert g.policy.to_json() == g.store.load(1).to_json()


def _fleet_trace(cfg, n=7, seed=21):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, cfg.vocab, int(rng.integers(3, 17))).astype(np.int32),
             int(rng.integers(1, 6))) for rid in range(n)]


def _fleet_drain(params, cfg, trace, offset=0, bat=None, **kw):
    from repro_torch.fleet import BatcherConfig, ContinuousBatcher, Request

    if bat is None:
        bat = ContinuousBatcher(params, cfg, BatcherConfig(
            n_slots=3, prompt_buckets=(8, 16), new_token_bucket=5, **kw))
    for rid, p, n in trace:
        bat.submit(Request(rid + offset, p.copy(), n))
    return {c.rid - offset: c.tokens.tolist() for c in bat.run()}, bat


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_batcher_token_drain_equals_wave_and_async_equals_sync(cuda, temperature):
    cfg = _serve_cfg("mxu")
    params = init_params(cfg, seed=15, device=cuda)
    trace = _fleet_trace(cfg)
    wave, _ = _fleet_drain(params, cfg, trace, temperature=temperature, seed=2)
    sync, sbat = _fleet_drain(params, cfg, trace, temperature=temperature, seed=2,
                              token_granular=True)
    asyn, abat = _fleet_drain(params, cfg, trace, temperature=temperature, seed=2,
                              token_granular=True, async_admission=True)
    assert sorted(wave) == list(range(len(trace)))
    assert sync == wave and asyn == wave
    for bat in (sbat, abat):
        assert bat.stats["decode_retraces_post_warmup"] == 0 and bat.stats["splices"] > 0
        assert all(t.device == cuda for layer in bat._cache for t in layer.values())


def test_batcher_second_drain_captures_nothing(cuda):
    """The slot cache is kept across drains, so a second drain on the same
    batcher replays the step graph captured by the first (adaptive: one
    graph per observe gate)."""
    from repro_torch.fleet import BatcherConfig, ContinuousBatcher
    from repro_torch.serve import graph as G

    cfg = _serve_cfg("mxu")
    params = init_params(cfg, seed=16, device=cuda)
    trace = _fleet_trace(cfg, seed=22)
    ctrl = AdaptiveController(SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                              AdaptiveConfig(drift_threshold=1e9), device=cuda)
    bat = ContinuousBatcher(params, cfg, BatcherConfig(
        n_slots=3, prompt_buckets=(8, 16), new_token_bucket=5, token_granular=True,
        observe_every=2), adaptive=ctrl)
    first, _ = _fleet_drain(params, cfg, trace, bat=bat)
    c0 = sum(G.CAPTURES.values())
    second, _ = _fleet_drain(params, cfg, trace, offset=200, bat=bat)
    assert sum(G.CAPTURES.values()) == c0 and second == first
    assert bat.stats["decode_retraces_post_warmup"] == 0
    assert {False, True} <= {k[-1] for k in G.CAPTURES if k[0] == "token_step"}


def test_prefill_one_reads_nothing_from_the_card(cuda):
    import numpy as np

    from repro_torch.serve import graph as G
    from repro_torch.serve import prefill_one

    cfg = _serve_cfg("mxu")
    params = init_params(cfg, seed=17, device=cuda)
    p = np.random.default_rng(23).integers(0, cfg.vocab, 11).astype(np.int32)
    padded = np.concatenate([p, np.full(5, p[-1], np.int32)])[None]
    want, _ = prefill_one(params, padded, 11, cfg, max_cache_len=24)      # warm
    with G.no_sync():
        first, fresh = prefill_one(params, padded, 11, cfg, max_cache_len=24)
        sampled, _ = prefill_one(params, padded, 11, cfg, max_cache_len=24,
                                 temperature=0.8, seed=5)
    torch.cuda.synchronize()
    assert torch.equal(first, want) and fresh[0]["k"].shape[1] == 24
    assert sampled.device == cuda


FAMILIES = ["gemma3-27b", "starcoder2-15b", "qwen1.5-110b", "qwen2-vl-72b", "deepseek-moe-16b",
            "granite-moe-1b-a400m", "recurrentgemma-2b", "mamba2-370m"]


def _ends(n, cap, dev):
    """All of 0..n-1 up to ``cap``, else the first and the last 128."""
    idx = torch.arange(n, device=dev)
    return idx if n <= cap else torch.cat([idx[:128], idx[-128:]])


@pytest.mark.parametrize("name", FAMILIES)
def test_family_shapes_equal_plain_and_graph_serve_equals_eager(cuda, name):
    """Every approximate projection of the family at its published widths
    (``transformer.ax_projections``), as ``chip_smoke.py``'s families phase
    serves it — 4 rows at decode, 128 at prefill, 4080 in gemma3's
    1020-token serve — through the dense path's integer matmul (padded as
    the path pads) equals the plain version (at prefill on the first and
    last 128 columns, beyond 512 rows on the first and last 128 rows); the
    decode shapes of recurrentgemma and deepseek, whose no-drift adaptive
    serve runs them, also through ``ax_matmul_grid`` with the serve's
    (3,) triple and with a 2-row-tile grid.  The reduced config serves the same greedy tokens eagerly and
    as a CUDA graph (embeds and 3-stream positions for the vlm)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.transformer import ax_projections
    from repro_torch.quant.ax import ax_matmul_int, ax_matmul_int_dyn
    from repro_torch.serve import graph as G

    policy = AxPolicy(backend="kernel")
    m = TC.get(policy.mult_name)
    assert AXM.route_of(m, torch.int8) == "T"
    kn = sorted({(K, N) for _, _, K, N in
                 ax_projections(dataclasses.replace(ARCHS[name], ax=policy))})
    Ms = (4, 128) + ((4080,) if name == "gemma3-27b" else ())
    grid = torch.tensor([[[1, 3, 0]], [[1, 5, 1]]], dtype=torch.int32, device=cuda)
    for i, (M, (K, N)) in enumerate((M, s) for M in Ms for s in kn):
        a = _ops((M, K), True, 40 + i, cuda)
        b = _ops((K, N), True, 60 + i, cuda)
        ri, ci = _ends(M, 512, cuda), _ends(N, N if M <= 4 else 256, cuda)
        got = ax_matmul_int(a, b, policy).index_select(0, ri).index_select(1, ci)
        want = ax_matmul_ref(a.index_select(0, ri), b.index_select(1, ci), m, policy.swap)
        assert torch.equal(got, want), (M, K, N)
        if M == 4 and name in ("recurrentgemma-2b", "deepseek-moe-16b"):
            emul = dataclasses.replace(policy, backend="emul")
            for dyn in (grid[0, 0], grid):         # the serve's triple, a tile grid
                assert torch.equal(ax_matmul_int_dyn(a, b, policy, dyn),
                                   ax_matmul_int_dyn(a, b, emul, dyn)), (M, K, N, dyn.shape)
        del a, b
    cfg = dataclasses.replace(reduced(ARCHS[name]), ax=AxPolicy(backend="kernel"))
    params = init_params(cfg, seed=3, device=cuda)
    g = torch.Generator().manual_seed(4)
    if cfg.family == "vlm":
        t = torch.arange(16)
        batch = {"embeds": torch.randn((2, 16, cfg.d_model), generator=g),
                 "pos": torch.stack([t, t // 4, t % 4], -1)[None].expand(2, 16, 3)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
    eager = generate(params, batch, cfg, ServeConfig(max_new_tokens=6, cuda_graphs=False))
    stats = {}
    graph = generate(params, batch, cfg, ServeConfig(max_new_tokens=6), stats=stats)
    assert stats["path"] == "graph" and torch.equal(graph, eager)
    G.clear_programs()


def test_whisper_shapes_equal_plain_and_graph_serve_equals_eager(cuda):
    """whisper-base's approximate projections at its published widths
    (``models.whisper.ax_projections``) through the dense path's integer
    matmul equal the plain version at the rows ``chip_smoke.py``'s whisper
    phase gives them (4 at decode, 32 decoder-prompt rows, 6000 encoder
    rows: the first and last 128 of those); the reduced whisper with 40
    frames serves the same greedy tokens eagerly and as a CUDA graph, with
    the reckoned launches, and again with a captured program replayed."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.models import whisper
    from repro_torch.quant.ax import ax_matmul_int
    from repro_torch.serve import graph as G

    policy = AxPolicy(backend="kernel")
    m = TC.get(policy.mult_name)
    full = dataclasses.replace(ARCHS["whisper-base"], ax=policy)
    rows = {"enc": 6000, "cross": 6000, "dec": 32}
    shapes = {(rows[st], K, N) for st, _, _, K, N in whisper.ax_projections(full)}
    shapes |= {(4, K, N) for *_, K, N in whisper.ax_projections(full, "decode")}
    for i, (M, K, N) in enumerate(sorted(shapes)):
        a = _ops((M, K), True, 70 + i, cuda)
        b = _ops((K, N), True, 90 + i, cuda)
        ri, ci = _ends(M, 512, cuda), _ends(N, N if M <= 4 else 256, cuda)
        got = ax_matmul_int(a, b, policy).index_select(0, ri).index_select(1, ci)
        want = ax_matmul_ref(a.index_select(0, ri), b.index_select(1, ci), m, policy.swap)
        assert torch.equal(got, want), (M, K, N)
    cfg = dataclasses.replace(reduced(ARCHS["whisper-base"]), ax=policy)
    params = init_params(cfg, seed=3, device=cuda)
    g = torch.Generator().manual_seed(4)
    batch = {"frames": torch.randn((2, 40, cfg.d_model), generator=g).to(torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab, (2, 8), generator=g)}
    T = 6
    reset_launches()
    eager = generate(params, batch, cfg, ServeConfig(max_new_tokens=T, cuda_graphs=False))
    n_pre, n_dec = len(whisper.ax_projections(cfg)), len(whisper.ax_projections(cfg, "decode"))
    assert dict(LAUNCHES) == {"ax_matmul": n_pre + n_dec * (T - 1), "ax_matmul_grid": 0}
    for run in range(2):
        before = G.counts()
        caps = sum(G.CAPTURES.values())
        stats = {}
        reset_launches()
        graph = generate(params, batch, cfg, ServeConfig(max_new_tokens=T), stats=stats)
        assert stats["path"] == "graph" and torch.equal(graph, eager), run
        assert sum(G.CAPTURES.values()) - caps == (1 if run == 0 else 0)
        assert G.executed_launches(before, dict(LAUNCHES))["ax_matmul"] == \
            n_pre + n_dec * (T - 1)
    G.clear_programs()


def test_one_train_step_on_the_card(cuda):
    """One static and one adaptive AdamW step of reduced deepseek-moe (its
    dense layer and a MoE layer) with the SWAPPER projection (``mxu``,
    route T) on the card: the loss, the grad norm and each leaf's update
    near the CPU's (the same weights and batch, f32; the bounds of
    ``chip_smoke.py``'s train card-vs-CPU check), the approximate
    projections launched once per forward and never in the backward pass, the adaptive step through the grid kernel
    with telemetry, and new parameters that a serve quantizes afresh."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.ax_matmul import LAUNCHES, reset_launches
    from repro_torch.models.transformer import ax_projections
    from repro_torch.quant.ax import WEIGHT_CACHE
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticStream, fresh_train_state,
                                   make_train_step)
    from repro_torch.configs import ParallelConfig
    from repro_torch.train.optimizer import tree_leaves, tree_map

    cfg = dataclasses.replace(reduced(ARCHS["deepseek-moe-16b"]), n_layers=2,
                              compute_dtype="float32", ax=AxPolicy(backend="mxu"))
    opt = AdamWConfig(lr=1e-3, warmup=1)
    state = fresh_train_state(cfg, opt, seed=0, device="cpu")
    batch = SyntheticStream(DataConfig(cfg.vocab, 32, 4, seed=1, mode="arith")).next()
    n_ax = len(ax_projections(cfg))
    par = ParallelConfig(remat="none")
    cpu_state, cpu_m = make_train_step(cfg, par, opt)(state, batch)
    gstate = tree_map(lambda t: t.to(cuda), state)
    reset_launches()
    new, m = make_train_step(cfg, par, opt)(gstate, batch)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"ax_matmul": n_ax, "ax_matmul_grid": 0}
    loss = float(m["loss"])
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) / float(cpu_m[k]) - 1) <= 1e-4, k
    for a, b, p in zip(tree_leaves(new["params"]), tree_leaves(cpu_state["params"]),
                       tree_leaves(state["params"])):
        da, db = a.float().cpu() - p.float(), b.float() - p.float()
        assert ((da - db).norm() / db.norm()).item() <= 0.1
    assert int(new["opt"]["step"]) == 1 and new["params"]["embed"]["w"].device == cuda

    ctrl = AdaptiveController(SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                              AdaptiveConfig(), device=cuda)
    reset_launches()
    _, am = make_train_step(cfg, par, opt, adaptive=True)(gstate, batch, ctrl.dyn_tree())
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"ax_matmul": 0, "ax_matmul_grid": n_ax}
    assert float(am["loss"]) == pytest.approx(loss, abs=1e-4)
    assert all(int(r["n"].sum()) > 0 for r in am["ax_telemetry"].values())

    # a serve after the step quantizes the new weights, not the old codes
    misses = WEIGHT_CACHE["misses"]
    prompt = {"tokens": torch.from_numpy(batch["tokens"][:, :8]).to(cuda)}
    generate(gstate["params"], prompt, cfg, ServeConfig(max_new_tokens=2, cuda_graphs=False))
    generate(new["params"], prompt, cfg, ServeConfig(max_new_tokens=2, cuda_graphs=False))
    assert WEIGHT_CACHE["misses"] - misses == 2 * n_ax


# ---------------------------------------------------------------------------
# the kernel-schedule autotuner on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("name", ["mul8s_trunc0_4", "mul8s_drum3_4"])
def test_every_autotune_candidate_equals_plain_and_builds_nothing(cuda, M, name):
    """Each candidate of the full sweep, through the production dispatch of
    every op its route takes, gives the plain version's bits, and its
    ``tile_hist`` the plain histogram of its tiles; nothing is built."""
    from repro_torch.kernels import _build, autotune as TA

    K, N = 1280, 384
    a, b = TA.operands(M, K, N, seed=5, device=cuda)
    m = TC.get(name)
    want = ax_matmul_ref(a, b, m, TC.SwapConfig("A", 3, 0))
    route = AXM.route_of(m, torch.int8)
    ops_ = ("matmul", "matmul_grid") + (("int_static", "int_dyn") if route == "T" else ())
    ops.ax_matmul(a, b, m, None)                     # built and loaded before counting
    runs = _build.NVCC_RUNS["count"]
    n = 0
    for op in ops_:
        backend = "kernel" if op.startswith("matmul") else "mxu"
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        for s in TA.candidate_schedules(backend, M, K, N, op=op, route=route, sms=sms):
            got = TA.dispatch_fn(op, a, b, name, s)()
            out, hist = ops.ax_matmul(a, b, m, None, schedule=s, tile_hist=True)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (op, s.short())
            bm, bn = min(s.bm, M), min(s.bn, N)
            assert torch.equal(hist, tile_hist_blocks(a, b, m.bits, bm, bn)), (op, s.short())
            n += 1
    assert n >= 10 and _build.NVCC_RUNS["count"] == runs


def test_autotune_install_keeps_captured_graphs_and_builds_nothing(cuda, tmp_path):
    """A graph captured before a table is installed replays its own launches
    (the same tokens, no capture); the table, tuned on the card as CUDA
    graphs and adopted through a store, resolves the eager prefill's
    dispatches (hits) and builds nothing."""
    from repro_torch import obs
    from repro_torch.kernels import _build, autotune as TA, clear_table, installed_table
    from repro_torch.serve import graph as G

    cfg = _serve_cfg("mxu")
    params = init_params(cfg, seed=7, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(9))
    before = generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=4))
    runs = _build.NVCC_RUNS["count"]
    try:
        shapes = sorted({(r, cfg.d_model, cfg.d_ff) for r in (2, 16)} |
                        {(r, cfg.d_ff, cfg.d_model) for r in (2, 16)})
        table, reports = TA.tune_table(shapes, cfg.ax.mult_name, backends=("mxu",),
                                       device=cuda)
        assert all("CUDA graph" in r["timer"] for r in reports)
        assert all(r["best_us"] <= r["default_us"] for r in reports)
        assert table.meta["device"] == torch.cuda.get_device_name(cuda)
        store = TA.ScheduleStore(str(tmp_path / "sched"))
        store.publish(table)
        reader = TA.ScheduleReader(store)
        assert reader.version == 1 and installed_table() is reader.table
        caps = sum(G.CAPTURES.values())
        hits = obs.default_registry().get("repro_sched_lookups_total").value(result="hit")
        after = generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=4))
        torch.cuda.synchronize()
        assert torch.equal(after, before)
        assert sum(G.CAPTURES.values()) == caps
        assert obs.default_registry().get("repro_sched_lookups_total").value(
            result="hit") > hits
        assert _build.NVCC_RUNS["count"] == runs
    finally:
        clear_table()
        G.clear_programs()


# ---------------------------------------------------------------------------
# the fleet mesh on the card
# ---------------------------------------------------------------------------

def _card_world(n, backend):
    import _torch_mesh_ranks as RK
    from repro_torch.launch.mesh import spawn

    return RK, spawn(RK.card_serve_rank, n, device="cuda", backend=backend, timeout_s=600)


def _same_records(got, want):
    assert set(got) == set(want)
    for t in want:
        for k, v in want[t].items():
            assert got[t][k].dtype == v.dtype and (got[t][k] == v).all(), (t, k)


def test_mesh_serve_on_one_nccl_rank_equals_the_serve_without_a_mesh(cuda):
    RK, (r,) = _card_world(1, "nccl")
    assert r["path"] == "graph"
    assert (r["tokens"] == r["solo_tokens"]).all()
    assert len(r["records"]) == RK.T - 1
    for got, want in zip(r["records"], r["solo_records"]):
        _same_records(got, want)


def test_mesh_serve_on_two_gloo_ranks_sharing_the_card(cuda):
    from repro_torch.runtime.telemetry import combine_records

    RK, res = _card_world(2, "gloo")
    solo = [r["solo_tokens"] for r in res]
    for r in res:
        assert (r["tokens"] == res[0]["tokens"]).all()
        for rank, s in enumerate(solo):
            assert (r["tokens"][RK.block(rank, 2)] == s).all()
        for i, got in enumerate(r["records"]):
            _same_records(got, combine_records([q["solo_records"][i] for q in res]))
