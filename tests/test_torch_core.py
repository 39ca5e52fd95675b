"""The port's core (repro_torch.core) against the JAX package's core, bit
for bit: every REGISTRY multiplier, the swap masks and swapper for every
configuration, the oracle and the tiling helpers.  Inputs are made with
numpy and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as C
from repro.core.swapper import NO_SWAP_TRIPLE, cfg_to_triple
import repro_torch.core as T

NAMES = sorted(C.REGISTRY)


def _operands(bits: int, signed: bool):
    """The full (a, b) grid for 8 bits, a seeded 4096-pair sample (with
    zero operands forced in) for 12 and 16 bits."""
    lo, hi = ((-(1 << (bits - 1)), 1 << (bits - 1)) if signed else (0, 1 << bits))
    if bits == 8:
        v = np.arange(lo, hi, dtype=np.int32)
        return np.repeat(v, v.size), np.tile(v, v.size)
    rng = np.random.default_rng(bits * 2 + signed)
    a = rng.integers(lo, hi, 4096).astype(np.int32)
    b = rng.integers(lo, hi, 4096).astype(np.int32)
    a[:8], b[8:16] = 0, 0
    a[16:24], b[16:24] = lo, hi - 1
    return a, b


def _jax(fn, a, b):
    return np.asarray(jax.jit(fn)(jnp.asarray(a), jnp.asarray(b))).astype(np.int64)


def _torch(fn, a, b):
    return fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def test_registry_names_match():
    assert sorted(T.REGISTRY) == NAMES
    for n in NAMES:
        j, t = C.REGISTRY[n], T.REGISTRY[n]
        assert (j.bits, j.signed, j.commutative) == (t.bits, t.signed, t.commutative), n


@pytest.mark.parametrize("name", NAMES)
def test_multiplier_bit_exact(name):
    """fn over the full 8-bit grid / a 12- and 16-bit sample, plus the exact
    product, equal to the JAX multiplier's lanes."""
    jm, tm = C.REGISTRY[name], T.REGISTRY[name]
    a, b = _operands(jm.bits, jm.signed)
    np.testing.assert_array_equal(_torch(tm.fn, a, b), _jax(jm.fn, a, b))
    np.testing.assert_array_equal(_torch(tm.exact_product, a, b),
                                  _jax(jm.exact_product, a, b))


@pytest.mark.parametrize("name", ["mul8s_trunc0_4", "mul8u_mitch13_0", "mul8s_drum3_4"])
def test_make_lut_and_lut_mult(name):
    jm, tm = C.REGISTRY[name], T.REGISTRY[name]
    jt = C.make_lut(jm)
    tt = T.make_lut(tm).numpy()
    np.testing.assert_array_equal(tt, jt.astype(np.int64))
    jl = C.lut_mult("lut", jt, jm.signed)
    tl = T.lut_mult("lut", tt, tm.signed)
    a, b = _operands(8, jm.signed)
    np.testing.assert_array_equal(_torch(tl.fn, a, b), _jax(jl.fn, a, b))


def _all_triples(bits: int):
    return [cfg_to_triple(c) for c in C.all_configs(bits)] + [NO_SWAP_TRIPLE]


@pytest.mark.parametrize("signed", [True, False])
def test_swap_mask_dyn_all_triples(signed):
    """swap_mask_dyn and apply_swapper_dyn for all 4M+1 triples (8-bit)."""
    m = "mul8s_trunc0_4" if signed else "mul8u_trunc0_4"
    jm, tm = C.REGISTRY[m], T.REGISTRY[m]
    rng = np.random.default_rng(5)
    lo, hi = (-128, 128) if signed else (0, 256)
    a = rng.integers(lo, hi, 2048).astype(np.int32)
    b = rng.integers(lo, hi, 2048).astype(np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    jmask = jax.jit(C.swap_mask_dyn)
    japply = jax.jit(lambda x, y, o, bt, v: C.apply_swapper_dyn(jm, x, y, o, bt, v))
    triples = _all_triples(8)
    assert len(triples) == 4 * 8 + 1
    for op, bit, val in triples:
        args = (jnp.int32(op), jnp.int32(bit), jnp.int32(val))
        want = np.asarray(jmask(jnp.asarray(a), jnp.asarray(b), *args))
        got = T.swap_mask_dyn(ta, tb, op, bit, val).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str((op, bit, val)))
        got_t = T.swap_mask_dyn(ta, tb, torch.tensor(op), torch.tensor(bit),
                                torch.tensor(val)).numpy()
        np.testing.assert_array_equal(got_t, want)
        np.testing.assert_array_equal(
            T.apply_swapper_dyn(tm, ta, tb, op, bit, val).numpy(),
            np.asarray(japply(jnp.asarray(a), jnp.asarray(b), *args)).astype(np.int64))


@pytest.mark.parametrize("name", ["mul8s_bam_v2_h1", "mul8u_trunc0_4", "mul16s_drum2_14"])
def test_static_swapper_matches_dyn_and_jax(name):
    """apply_swapper / swap_mask for every static config equal the JAX
    swapper and the port's dyn form with the same triple."""
    jm, tm = C.REGISTRY[name], T.REGISTRY[name]
    a, b = _operands(jm.bits, jm.signed)
    a, b = a[:4096], b[:4096]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for jc, tc in zip(C.all_configs(jm.bits), T.all_configs(tm.bits)):
        assert cfg_to_triple(jc) == T.cfg_to_triple(tc)
        np.testing.assert_array_equal(
            T.swap_mask(ta, tb, tc).numpy(),
            np.asarray(C.swap_mask(jnp.asarray(a), jnp.asarray(b), jc)))
        got = T.apply_swapper(tm, ta, tb, tc).numpy()
        np.testing.assert_array_equal(
            got, _jax(lambda x, y: C.apply_swapper(jm, x, y, jc), a, b))
        np.testing.assert_array_equal(
            got, T.apply_swapper_dyn(tm, ta, tb, *T.cfg_to_triple(tc)).numpy())
    np.testing.assert_array_equal(T.apply_swapper(tm, ta, tb, None).numpy(),
                                  _jax(jm.fn, a, b))
    assert T.cfg_to_triple(None) == cfg_to_triple(None) == T.NO_SWAP_TRIPLE


@pytest.mark.parametrize("name", ["mul8s_trunc0_4", "mul8u_bam_v2_h1", "mul12s_mitch10_13"])
def test_oracle_and_abs_err(name):
    jm, tm = C.REGISTRY[name], T.REGISTRY[name]
    a, b = _operands(jm.bits, jm.signed)
    np.testing.assert_array_equal(_torch(T.oracle_mult(tm).fn, a, b),
                                  _jax(C.oracle_mult(jm).fn, a, b))
    pj, pe = _jax(jm.fn, a, b), _jax(jm.exact_product, a, b)
    want = np.asarray(C.abs_err(jnp.asarray(pj).astype(jnp.int32 if jm.signed else jnp.uint32),
                                jnp.asarray(pe).astype(jnp.int32 if jm.signed else jnp.uint32),
                                jm.signed)).astype(np.int64)
    got = T.abs_err(torch.from_numpy(pj), torch.from_numpy(pe), tm.signed).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M,gm", [(1, 1), (7, 3), (16, 4), (5, 9), (128, 7)])
def test_tiling_helpers(M, gm):
    assert T.rowtile_count(M, gm) == C.rowtile_count(M, gm)
    assert T.rowtile_span(M, gm) == C.rowtile_span(M, gm)
    np.testing.assert_array_equal(T.rowtile_index(M, gm), C.rowtile_index(M, gm))
    from repro.core.tiling import largest_divisor_leq as jl
    for cap in (1, 3, 8, 128):
        assert T.largest_divisor_leq(M, cap) == jl(M, cap)
