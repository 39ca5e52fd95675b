"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA device: it carries the ``gpu`` marker and
skips through the ``cuda`` fixture where there is none (decided when the
test runs, never at import, so every pytest-xdist worker collects the same
tests).  On the machine with the card:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the card's machine has none.
"""
import dataclasses
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
