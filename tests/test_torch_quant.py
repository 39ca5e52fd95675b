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
    a = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        TQ.ax_matmul_int(a, a.T.contiguous(), TPolicy(backend="mxu"))


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
