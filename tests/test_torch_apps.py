"""The port's AxBench-style applications (repro_torch.apps) against the JAX
package's, on the same numpy inputs: inputs and references, every app's
output under each evaluation mode, application-level tuning and SSIM.

Tolerances: every application output is bit-exact (the Q16.16 pipeline is
the same integer arithmetic, tests/test_torch_fixedpoint.py).  The metrics
are float32 reductions taken in another order: ARE and miss rate agree to
1e-6 relative; SSIM to 1e-4, because E[x^2] - mu^2 over 0..255 windows
cancels about 12 bits in float32 (kmeans' flat regions show 2e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps as A
import repro.core as C
import repro_torch.apps as TA
import repro_torch.core as T

FAST_N = {"ssim": 48, "are": 128, "miss_rate": 128}
METRIC_RTOL = {"ssim": 1e-4, "are": 1e-6, "miss_rate": 1e-6}


@pytest.mark.parametrize("name", sorted(A.ALL_APPS))
def test_app_inputs_and_reference_match(name):
    ja, ta = A.ALL_APPS[name], TA.ALL_APPS[name]
    assert (ta.metric_name, ta.minimize, ta.kind) == (ja.metric_name, ja.minimize, ja.kind)
    n = FAST_N[ja.metric_name]
    for seed in (1234, 42):
        ji, ti = ja.gen_inputs(n, seed), ta.gen_inputs(n, seed)
        assert sorted(ji) == sorted(ti)
        for k in ji:
            np.testing.assert_array_equal(ti[k], ji[k])
        np.testing.assert_array_equal(ta.reference(ti), np.asarray(ja.reference(ji)))


@pytest.mark.parametrize("name", sorted(A.ALL_APPS))
@pytest.mark.parametrize("mode", ["fp", "fxp", "noswap", "swap", "oracle"])
def test_app_outputs_match_jax(name, mode):
    """Every app under each evaluation mode at the small sizes of
    tests/test_apps.py: outputs bit-exact, the metric within its stated
    tolerance."""
    ja, ta = A.ALL_APPS[name], TA.ALL_APPS[name]
    n = FAST_N[ja.metric_name]
    jm, tm = C.get("mul16s_drum5_8"), T.get("mul16s_drum5_8")
    jmode = {"noswap": None, "swap": C.SwapConfig("B", 11, 1)}.get(mode, mode)
    tmode = {"noswap": None, "swap": T.SwapConfig("B", 11, 1)}.get(mode, mode)
    vj, oj = A.evaluate(ja, jmode, mult=jm, n=n, seed=1234)
    vt, ot = TA.evaluate(ta, tmode, mult=tm, n=n, seed=1234, device="cpu")
    ot = ot.numpy() if isinstance(ot, torch.Tensor) else ot
    np.testing.assert_array_equal(ot, np.asarray(oj))
    assert np.isfinite(vt)
    assert vt == pytest.approx(vj, rel=METRIC_RTOL[ja.metric_name], abs=1e-12)


def test_tune_app_picks_the_same_config():
    """blackscholes / mul16s_drum5_8 (tests/test_apps.py): the same tuned
    config, and the whole 65-entry table within the ARE tolerance."""
    ja, ta = A.ALL_APPS["blackscholes"], TA.ALL_APPS["blackscholes"]
    jcfg, jval, jtab = A.tune_app(ja, C.get("mul16s_drum5_8"), n=128, seed=42)
    tcfg, tval, ttab = TA.tune_app(ta, T.get("mul16s_drum5_8"), n=128, seed=42, device="cpu")
    assert C.SwapConfig(tcfg.operand, tcfg.bit, tcfg.value) == jcfg
    assert tval == pytest.approx(jval, rel=1e-6)
    assert len(ttab) == len(jtab) == 4 * 16 + 1
    for k, v in ttab.items():
        jk = None if k is None else C.SwapConfig(k.operand, k.bit, k.value)
        assert v == pytest.approx(jtab[jk], rel=1e-6), k
    v, _ = TA.evaluate(ta, tcfg, mult=T.get("mul16s_drum5_8"), n=128, seed=42, device="cpu")
    assert v == pytest.approx(tval, rel=1e-6)


def test_ssim_properties_and_smooth_image():
    img = TA.smooth_image(64, 64, 0)
    np.testing.assert_array_equal(img, A.smooth_image(64, 64, 0))
    np.testing.assert_array_equal(TA.smooth_image(40, 48, 3, channels=3),
                                  A.smooth_image(40, 48, 3, channels=3))
    t = torch.from_numpy(img)
    assert float(TA.ssim(t, t)) == pytest.approx(1.0, abs=1e-6)
    noisy = img + np.random.default_rng(0).normal(0, 25, img.shape)
    v = float(TA.ssim(t, torch.from_numpy(noisy)))
    assert 0.0 < v < 0.95
    assert v == pytest.approx(float(A.ssim(jnp.asarray(img), jnp.asarray(noisy))), rel=1e-4)
