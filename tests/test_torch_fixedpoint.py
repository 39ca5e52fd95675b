"""The port's Eq. 6 modular multiply and Q16.16 math library
(repro_torch.core.modular / fixedpoint) against the JAX package, bit for
bit, on seeded int32 pairs and float grids made with numpy: every part
configuration, ``lsb_fix``, static and run-time swaps, and ``FxpMath``'s
div, sqrt, exp, log, sin, cos, atan2 and acos, precise and approximate.
The float32 seeds of FxpMath are IEEE operations on both sides and agree
everywhere on these inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st

import repro.core as C
import repro_torch.core as T

I32 = st.integers(-(2**31), 2**31 - 1)


def _mul_cfgs(mname="mul16s_drum5_8"):
    """(label, JAX AxMul32Config or None, port AxMul32Config or None)."""
    jm, tm = C.get(mname), T.get(mname)
    sw = ("B", 11, 1)
    return [
        ("none", None, None),
        ("PART_NONE", C.AxMul32Config(jm, parts=C.PART_NONE), T.AxMul32Config(tm, parts=T.PART_NONE)),
        ("MD_LO", C.AxMul32Config(jm), T.AxMul32Config(tm)),
        ("ALL", C.AxMul32Config(jm, parts=C.PART_ALL), T.AxMul32Config(tm, parts=T.PART_ALL)),
        ("lsb_fix", C.AxMul32Config(jm, parts=C.PART_ALL, lsb_fix=True),
         T.AxMul32Config(tm, parts=T.PART_ALL, lsb_fix=True)),
        ("swap", C.AxMul32Config(jm, swap=C.SwapConfig(*sw)),
         T.AxMul32Config(tm, swap=T.SwapConfig(*sw))),
        ("swap_fix", C.AxMul32Config(jm, parts=C.PART_ALL, swap=C.SwapConfig("A", 3, 0), lsb_fix=True),
         T.AxMul32Config(tm, parts=T.PART_ALL, swap=T.SwapConfig("A", 3, 0), lsb_fix=True)),
    ]


def _i32_pairs(seed, n=4000):
    rng = np.random.default_rng(seed)
    a = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    b = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    a[:4], b[:4] = [0, -(2**31), 2**31 - 1, -1], [-(2**31), -(2**31), 2**31 - 1, 65535]
    a[4:2000] >>= 8        # Q16.16 magnitudes the apps see
    b[4:2000] >>= 10
    return a, b


@pytest.mark.parametrize("mname", ["mul16s_drum5_8", "mul16s_bam_v4_h1", "mul16s_mitch10_13"])
def test_ax_fxp_mul_bit_exact(mname):
    a, b = _i32_pairs(1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for label, jc, tc in _mul_cfgs(mname):
        want = np.asarray(C.ax_fxp_mul(jnp.asarray(a), jnp.asarray(b), jc))
        got = T.ax_fxp_mul(ta, tb, tc)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=label)


def test_ax_fxp_mul_dyn_bit_exact_all_triples():
    a, b = _i32_pairs(2, 1500)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    jm, tm = C.get("mul16s_bam_v4_h1"), T.get("mul16s_bam_v4_h1")
    jc, tc = C.AxMul32Config(jm, parts=C.PART_ALL), T.AxMul32Config(tm, parts=T.PART_ALL)
    triples = [T.cfg_to_triple(c) for c in T.all_configs(16)] + [T.NO_SWAP_TRIPLE]
    for trip in triples[::3] + [triples[-1]]:
        want = np.asarray(C.ax_fxp_mul_dyn(jnp.asarray(a), jnp.asarray(b), jc,
                                           *(jnp.int32(v) for v in trip)))
        got = T.ax_fxp_mul_dyn(ta, tb, tc, *(torch.tensor(v, dtype=torch.int32) for v in trip))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(trip))


@settings(max_examples=150, deadline=None)
@given(a=I32, b=I32)
def test_precise_modular_matches_int64(a, b):
    got = int(T.ax_fxp_mul(torch.tensor([a], dtype=torch.int32),
                           torch.tensor([b], dtype=torch.int32))[0])
    want = ((a * b) >> 16) & 0xFFFFFFFF
    assert got == want - (1 << 32) * (want >> 31)


def test_axmul32config_takes_a_16bit_signed_multiplier():
    with pytest.raises(ValueError, match="16-bit signed"):
        T.AxMul32Config(T.get("mul16u_trunc0_8"))


def _fxp_inputs():
    rng = np.random.default_rng(4)
    return {
        "div": (rng.uniform(-1000, 1000, 700), rng.uniform(-100, 100, 700)),
        "sqrt": (np.linspace(0.0, 3000, 700),),
        "exp": (np.linspace(-6, 9, 400),),
        "log": (np.concatenate([np.linspace(-1, 5000, 400), [0.0, 1e-5]]),),
        "sin": (np.linspace(-7, 7, 500),),
        "cos": (np.linspace(-7, 7, 500),),
        "atan2": (np.linspace(-5, 5, 121), np.concatenate([np.linspace(-5, 5, 120), [0.0]])),
        "acos": (np.linspace(-1.2, 1.2, 301),),
    }


@pytest.mark.parametrize("mname", [None, "mul16s_mitch10_13"])
def test_fxpmath_bit_exact(mname):
    """div, sqrt, exp, log, sin, cos, atan2, acos: the same Q16.16 bits as
    JAX's, precise and through an approximate multiply (the float32 seeds
    agree everywhere on these inputs)."""
    if mname is None:
        jF, tF = C.FxpMath(C.make_mul(None)), T.FxpMath(T.make_mul(None))
    else:
        jF = C.FxpMath(C.make_mul(C.AxMul32Config(C.get(mname))))
        tF = T.FxpMath(T.make_mul(T.AxMul32Config(T.get(mname))))
    for op, args in _fxp_inputs().items():
        jx = [C.to_fxp(np.asarray(x, np.float32)) for x in args]
        tx = [T.to_fxp(torch.from_numpy(np.asarray(x, np.float32))) for x in args]
        for j, t in zip(jx, tx):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        want = np.asarray(getattr(jF, op)(*jx))
        got = getattr(tF, op)(*tx)
        assert got.dtype == torch.int32, op
        np.testing.assert_array_equal(got.numpy(), want, err_msg=op)
        np.testing.assert_array_equal(T.from_fxp(got).numpy(), np.asarray(C.from_fxp(jnp.asarray(want))))


def test_to_fxp_saturates_and_rounds_half_even():
    x = np.array([0.5 / 65536, 1.5 / 65536, -2.5 / 65536, 1e6, -1e6, 32767.9], np.float32)
    np.testing.assert_array_equal(T.to_fxp(torch.from_numpy(x)).numpy(), np.asarray(C.to_fxp(x)))
