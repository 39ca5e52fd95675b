"""AxBench `fft`: radix-2 DIT FFT, Q16.16 butterflies, ARE metric."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fixedpoint import FxpMath, from_fxp, to_fxp

from .common import AxApp

N_DEFAULT = 1024


def gen_inputs(n, seed):
    n = int(n) if int(n) >= 64 else N_DEFAULT
    n = 1 << int(np.log2(n))
    rng = np.random.default_rng(seed)
    # bounded, structured signal (sum of tones + noise), |x| < 1
    t = np.arange(n)
    sig = np.zeros(n)
    for _ in range(4):
        sig += rng.uniform(0.05, 0.2) * np.sin(2 * np.pi * rng.uniform(1, n / 4) * t / n)
    sig += rng.normal(0, 0.02, n)
    return {"re": sig.astype(np.float64), "im": np.zeros(n)}


def _bitrev_perm(n):
    bits = int(np.log2(n))
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def run_fxp(inputs, mul):
    F = FxpMath(mul)
    dev = inputs["re"].device
    n = inputs["re"].shape[0]
    rev = torch.from_numpy(_bitrev_perm(n)).to(dev)
    re = to_fxp(inputs["re"])[rev]
    im = to_fxp(inputs["im"])[rev]

    stages = int(np.log2(n))
    for s in range(1, stages + 1):
        m = 1 << s
        half = m >> 1
        # twiddles for this stage, replicated across groups (precise constants)
        k = np.arange(n // 2) % half
        ang = -2.0 * np.pi * k / m
        wr = to_fxp(torch.from_numpy(np.cos(ang).astype(np.float32)).to(dev))
        wi = to_fxp(torch.from_numpy(np.sin(ang).astype(np.float32)).to(dev))
        # butterfly index sets
        idx = np.arange(n // 2)
        top_np = (idx // half) * m + idx % half
        top = torch.from_numpy(top_np).to(dev)
        bot = torch.from_numpy(top_np + half).to(dev)
        ur, ui = re[top], im[top]
        vr, vi = re[bot], im[bot]
        # t = w * v (4 fxp multiplies)
        tr = F.mul(wr, vr) - F.mul(wi, vi)
        ti = F.mul(wr, vi) + F.mul(wi, vr)
        re, im = re.clone(), im.clone()
        re[top], re[bot] = ur + tr, ur - tr
        im[top], im[bot] = ui + ti, ui - ti
    return torch.stack([from_fxp(re), from_fxp(im)])


def reference(inputs):
    x = np.asarray(inputs["re"]) + 1j * np.asarray(inputs["im"])
    X = np.fft.fft(x)
    return np.stack([X.real, X.imag]).astype(np.float32)


def metric(out, ref):
    """ARE with the AxBench qos convention: zero-reference entries still
    count (denominator clamped to 1e-3)."""
    err = torch.abs(out - ref)
    den = torch.clamp(torch.abs(ref), min=1e-3)
    return torch.mean(err / den)


APP = AxApp(name="fft", metric_name="are", minimize=True, kind="fxp32",
            gen_inputs=gen_inputs, reference=reference, run_fxp=run_fxp, metric=metric)
