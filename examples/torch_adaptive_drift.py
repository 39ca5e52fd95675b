"""The adaptive SWAPPER runtime of the PyTorch port on a drifting synthetic
operand stream (``examples/adaptive_drift.py`` with ``repro_torch``).

    PYTHONPATH=src python examples/torch_adaptive_drift.py [--device cpu] [--smoke]

The controller starts from an offline-tuned config, watches streaming
bit-occupancy telemetry, detects the distribution shift and re-tunes from
its live operand buffer; the re-tune scorers run on ``--device``.
"""
import argparse

import numpy as np
import torch

import repro_torch.core as C
from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="12 steps of 512 operand pairs (else 24 of 2048)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    dev = torch.device(args.device)
    steps, width = (12, 512) if args.smoke else (24, 2048)
    mult = C.get("mul8u_trunc0_4")

    # offline tuning on the deployment-time distribution: high operand A
    res = C.component_sweep(mult, tile=256, device=dev)
    policy = SwapPolicy(mult.name, configs={"*": res.best("mae")})
    print(f"offline-tuned: {policy.describe()}")

    ctrl = AdaptiveController(
        policy, targets=("stream",),
        cfg=AdaptiveConfig(decay=0.3, min_observe_steps=2, cooldown_steps=2,
                           buffer_size=1024),
        log_fn=print, device=dev)
    ctrl.warmup()

    rng = np.random.default_rng(0)
    for step in range(steps):
        if step < steps // 2:     # tuned-on regime
            a = rng.integers(128, 256, width)
        else:                     # drifted regime: low-A traffic
            a = rng.integers(0, 96, width)
        b = rng.integers(0, 256, width)
        ctrl.observe_operands("stream", a, b)

    print(f"final: {ctrl.policy.describe()}")
    print(ctrl.telemetry.describe())
    print(f"re-tunes: {len(ctrl.retunes)}")
    return ctrl


if __name__ == "__main__":
    main()
