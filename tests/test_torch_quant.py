"""The port's quantized projection (repro_torch.quant.ax) against the JAX
package's: identical int8 codes and f32 scales, identical int32 matmuls
(kernel and emul backends, padded shapes), bit-identical f32 ``ax_dense``
outputs, and straight-through gradients equal to the exact-matmul ones.

The JAX side runs under ``jax.jit``, as every model and serving path of
the JAX package runs it (XLA turns ``amax / 127`` into a multiply by the
f32 reciprocal there; the port does the same)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AxPolicy as JPolicy
from repro.quant import ax as JQ
from repro_torch.configs.base import AxPolicy as TPolicy
from repro_torch.quant import ax as TQ

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale * rng.uniform(0.05, 20)).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_rows_identical(seed, axis):
    x = _x((3, 7, 96), seed) if axis == -1 else _x((96, 40), seed)
    x.flat[:5] = 0.0
    for jd, td in DTYPES:
        xj = jnp.asarray(x).astype(jd)
        xt = torch.from_numpy(x).to(td)
        qj, sj = jax.jit(lambda v: JQ.quantize_rows(v.astype(jnp.float32), axis=axis))(xj)
        qt, st = TQ.quantize_rows(xt.to(torch.float32), axis=axis)
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_rows_zero_row():
    q, s = TQ.quantize_rows(torch.zeros((2, 8)))
    assert not q.any() and torch.all(s > 0)


@pytest.mark.parametrize("name", ["mul8s_trunc0_4", "mul8s_trunc2_4", "mul8s_perf1_3",
                                  "mul8s_mitch0_0"])
def test_separable_transforms(name):
    jt, tt = JQ.separable_transforms(name), TQ.separable_transforms(name)
    assert (jt is None) == (tt is None)
    if jt is None:
        return
    v = np.arange(-128, 128, dtype=np.int32)
    for fj, ft in zip(jt, tt):
        np.testing.assert_array_equal(ft(torch.from_numpy(v)).numpy(),
                                      np.asarray(fj(jnp.asarray(v))))


@pytest.mark.parametrize("backend", ["kernel", "emul"])
@pytest.mark.parametrize("shape", [((2, 3, 64), 48), ((5, 200), 72), ((130, 96), 160)])
def test_ax_matmul_int_identical(backend, shape):
    """int32 accumulators, leading dims flattened, K/M/N padded to blocks."""
    (a_shape, n) = shape
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, a_shape).astype(np.int8)
    b = rng.integers(-127, 128, (a_shape[-1], n)).astype(np.int8)
    for swap in [dict(), dict(swap_operand="B", swap_bit=6, swap_value=1),
                 dict(swap_enabled=False)]:
        jp = JPolicy(backend=backend, mult_name="mul8s_drum3_4", **swap)
        tp = TPolicy(backend=backend, mult_name="mul8s_drum3_4", **swap)
        j = jax.jit(lambda x, y: JQ.ax_matmul_int(x, y, jp))(jnp.asarray(a), jnp.asarray(b))
        t = TQ.ax_matmul_int(torch.from_numpy(a), torch.from_numpy(b), tp)
        assert t.dtype == torch.int32 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_mxu_backend_is_not_ported_yet():
    """The ``mxu`` backend is ported now: the default policy equals JAX's
    ``mxu`` on its int32 accumulators, and a non-separable multiplier still
    raises (tests/test_torch_mxu.py covers the rest)."""
    rng = np.random.default_rng(11)
    a = rng.integers(-127, 128, (2, 8)).astype(np.int8)
    b = rng.integers(-127, 128, (8, 6)).astype(np.int8)
    j = jax.jit(lambda x, y: JQ.ax_matmul_int(x, y, JPolicy(backend="mxu")))(
        jnp.asarray(a), jnp.asarray(b))
    t = TQ.ax_matmul_int(torch.from_numpy(a), torch.from_numpy(b), TPolicy(backend="mxu"))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    with pytest.raises(ValueError, match="not separable"):
        TQ.ax_matmul_int(torch.from_numpy(a), torch.from_numpy(b),
                         TPolicy(backend="mxu", mult_name="mul8s_drum3_4"))


@pytest.mark.parametrize("backend", ["kernel", "emul"])
@pytest.mark.parametrize("mult", ["mul8s_trunc0_4", "mul8s_bam_v2_h1"])
def test_ax_dense_bit_identical(backend, mult):
    x = _x((2, 6, 96), 7)
    w = _x((96, 80), 8, scale=0.1)
    for jd, td in DTYPES:
        jp, tp = JPolicy(backend=backend, mult_name=mult), TPolicy(backend=backend, mult_name=mult)
        yj = jax.jit(lambda a, b: JQ.ax_dense(a, b, jp))(jnp.asarray(x).astype(jd),
                                                          jnp.asarray(w).astype(jd))
        yt = TQ.ax_dense(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), tp)
        assert yt.dtype == td
        np.testing.assert_array_equal(yt.to(torch.float32).numpy(),
                                      np.asarray(yj.astype(jnp.float32)))


def test_ax_dense_ste_gradients_equal_exact():
    """Backward is the exact matmul's gradient (straight-through): within
    1e-6 of the gradient's largest magnitude from the JAX custom_vjp and
    from autograd on x @ w (f32 sums in another order differ in the last
    bits, elementwise up to ~1e-4 relative where terms cancel)."""
    x = _x((3, 5, 64), 9)
    w = _x((64, 48), 10, scale=0.1)
    gy = _x((3, 5, 48), 11)
    tp = TPolicy(backend="kernel")
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    TQ.ax_dense(xt, wt, tp).backward(torch.from_numpy(gy))
    xe = torch.from_numpy(x).requires_grad_()
    we = torch.from_numpy(w).requires_grad_()
    (xe @ we).backward(torch.from_numpy(gy))
    jp = JPolicy(backend="kernel")
    _, vjp = jax.vjp(lambda a, b: JQ.ax_dense(a, b, jp), jnp.asarray(x), jnp.asarray(w))
    gxj, gwj = vjp(jnp.asarray(gy))
    for got, exact, jax_g in ((xt.grad, xe.grad, gxj), (wt.grad, we.grad, gwj)):
        scale = float(np.abs(exact.numpy()).max())
        assert np.abs(got.numpy() - exact.numpy()).max() <= 1e-6 * scale
        assert np.abs(got.numpy() - np.asarray(jax_g)).max() <= 1e-6 * scale


# ---------------------------------------------------------------------------
# the dynamic-config path (adaptive runtime)
# ---------------------------------------------------------------------------

def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8)


def _grid(gm, gn, seed):
    """(gm, gn, 3) grid mixing NoSwap and A-side triples with one B-side
    triple (the family ``SwapPolicy.set_tile_grid`` admits)."""
    rng = np.random.default_rng(seed)
    g = np.stack([np.ones((gm, gn)), rng.integers(0, 8, (gm, gn)),
                  rng.integers(0, 3, (gm, gn))], axis=-1).astype(np.int32)
    g[0, -1] = (0, 5, 1)
    return g


def _jit_dyn(jp):
    return jax.jit(lambda x, y, d: JQ.ax_matmul_int_dyn(x, y, jp, d))


@pytest.mark.parametrize("backend", ["kernel", "emul"])
def test_ax_matmul_int_dyn_scalar_triples_identical(backend):
    """A sample of the 4M+1 triples (NoSwap, both operands, both values)."""
    from repro.runtime.controller import all_triples
    a = _int8((2, 3, 64), 20)
    b = _int8((64, 48), 21)
    jp = JPolicy(backend=backend, mult_name="mul8s_bam_v2_h1")
    tp = TPolicy(backend=backend, mult_name="mul8s_bam_v2_h1")
    fn = _jit_dyn(jp)
    triples = all_triples(8)
    for t in triples[::4]:
        j = fn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))
        got = TQ.ax_matmul_int_dyn(torch.from_numpy(a), torch.from_numpy(b), tp,
                                   torch.from_numpy(t))
        assert got.dtype == torch.int32 and tuple(got.shape) == j.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(j))


@pytest.mark.parametrize("backend", ["kernel", "emul"])
@pytest.mark.parametrize("gm,gn", [(3, 1), (2, 2), (4, 3)])
def test_ax_matmul_int_dyn_grids_identical(backend, gm, gn):
    """Row-tile and row-by-column grids over a row count the tiles do not
    divide (the last tile absorbs the remainder; the kernel's blocks align
    to the tile spans)."""
    a = _int8((10, 64), 22)
    b = _int8((64, 40), 23)
    grid = _grid(gm, gn, 24)
    jp = JPolicy(backend=backend, mult_name="mul8s_drum3_4")
    tp = TPolicy(backend=backend, mult_name="mul8s_drum3_4")
    j = _jit_dyn(jp)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(grid))
    got = TQ.ax_matmul_int_dyn(torch.from_numpy(a), torch.from_numpy(b), tp,
                               torch.from_numpy(grid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))


@pytest.mark.parametrize("gm", [2, 3])
def test_ax_matmul_int_dyn_hist_identical(gm):
    """The kernel's tile histogram aggregated to logical row tiles: counts,
    negatives and element counts equal the JAX package's."""
    a = _int8((2, 5, 64), 25)
    b = _int8((64, 48), 26)
    grid = _grid(gm, 1, 27)
    jp = JPolicy(backend="kernel", mult_name="mul8s_trunc0_4")
    tp = TPolicy(backend="kernel", mult_name="mul8s_trunc0_4")
    jo, (jb, jn, jc) = jax.jit(lambda x, y, d: JQ.ax_matmul_int_dyn_hist(x, y, jp, d))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(grid))
    to, (tb, tn, tc) = TQ.ax_matmul_int_dyn_hist(torch.from_numpy(a), torch.from_numpy(b),
                                                 tp, torch.from_numpy(grid))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    for got, want, dt in ((tb, jb, torch.float32), (tn, jn, torch.float32),
                          (tc, jc, torch.int32)):
        assert got.dtype == dt
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="grid"):
        TQ.ax_matmul_int_dyn_hist(torch.from_numpy(a), torch.from_numpy(b), tp,
                                  torch.tensor([1, 3, 0]))


def test_dyn_mxu_backend_is_not_ported_yet():
    """The dynamic ``mxu`` path is ported now: a triple equals JAX's, and a
    grid with column tiles still raises (tests/test_torch_mxu.py covers the
    rest)."""
    rng = np.random.default_rng(12)
    a = rng.integers(-127, 128, (2, 8)).astype(np.int8)
    b = rng.integers(-127, 128, (8, 6)).astype(np.int8)
    dyn = np.asarray([1, 3, 0], np.int32)
    j = jax.jit(lambda x, y, d: JQ.ax_matmul_int_dyn(x, y, JPolicy(backend="mxu"), d))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(dyn))
    t = TQ.ax_matmul_int_dyn(torch.from_numpy(a), torch.from_numpy(b),
                             TPolicy(backend="mxu"), torch.from_numpy(dyn))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    with pytest.raises(ValueError, match="gn must be 1"):
        TQ.ax_matmul_int_dyn(torch.from_numpy(a), torch.from_numpy(b), TPolicy(backend="mxu"),
                             torch.from_numpy(np.tile(dyn, (1, 2, 1))))


@pytest.mark.parametrize("backend", ["kernel", "emul"])
@pytest.mark.parametrize("dyn", [np.asarray([1, 3, 0], np.int32), np.asarray([0, 6, 1], np.int32),
                                 _grid(2, 1, 28)])
def test_ax_dense_dyn_bit_identical(backend, dyn):
    x = _x((2, 6, 96), 29)
    w = _x((96, 80), 30, scale=0.1)
    jp = JPolicy(backend=backend, mult_name="mul8s_trunc0_4")
    tp = TPolicy(backend=backend, mult_name="mul8s_trunc0_4")
    for jd, td in DTYPES:
        yj = jax.jit(lambda a, b, d: JQ.ax_dense_dyn(a, b, jp, d))(
            jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd), jnp.asarray(dyn))
        yt = TQ.ax_dense_dyn(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), tp,
                             torch.from_numpy(dyn))
        assert yt.dtype == td
        np.testing.assert_array_equal(yt.to(torch.float32).numpy(),
                                      np.asarray(yj.astype(jnp.float32)))


def test_ax_dense_dyn_equals_static_for_the_same_config():
    x = torch.from_numpy(_x((3, 4, 64), 31))
    w = torch.from_numpy(_x((64, 48), 32, scale=0.1))
    pol = TPolicy(backend="kernel", swap_operand="B", swap_bit=2, swap_value=1)
    assert torch.equal(TQ.ax_dense_dyn(x, w, pol, torch.tensor([0, 2, 1])),
                       TQ.ax_dense(x, w, pol))


@pytest.mark.parametrize("kernel_hist", [False, True])
def test_ax_dense_dyn_ste_gradients_equal_exact(kernel_hist):
    """Straight-through gradients, with and without the kernel-histogram
    core (whose statistic takes no gradient), within 1e-6 of the largest
    magnitude of the exact matmul's (f32 sums in another order)."""
    from repro_torch.runtime import ax_scope
    x = _x((3, 5, 64), 33)
    w = _x((64, 48), 34, scale=0.1)
    gy = _x((3, 5, 48), 35)
    tp = TPolicy(backend="kernel")
    dyn = torch.from_numpy(_grid(2, 1, 36))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    with ax_scope({"mlp": dyn}, collect=True, tile_rows=2, kernel_hist=kernel_hist) as sc:
        y = TQ.ax_dense_dyn(xt, wt, tp, dyn, scope=sc, target="mlp")
    y.backward(torch.from_numpy(gy))
    rec = sc.collected()["mlp@tiles"]
    assert int(rec["tile_n"].sum()) == (15 * 64 if kernel_hist else 2 * 512)
    xe = torch.from_numpy(x).requires_grad_()
    we = torch.from_numpy(w).requires_grad_()
    (xe @ we).backward(torch.from_numpy(gy))
    for got, exact in ((xt.grad, xe.grad), (wt.grad, we.grad)):
        scale = float(np.abs(exact.numpy()).max())
        assert np.abs(got.numpy() - exact.numpy()).max() <= 1e-6 * scale
