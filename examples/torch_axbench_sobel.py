"""AxBench application demo on the PyTorch port: sobel under an approximate
multiplier, NoSwap -> SWAPPER (application-tuned) -> oracle
(``examples/axbench_sobel.py`` with ``repro_torch``).

    PYTHONPATH=src python examples/torch_axbench_sobel.py [--device cpu] [--smoke]
"""
import argparse

import numpy as np
import torch

import repro_torch.apps as A
import repro_torch.core as C


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="a 24-pixel image instead of 96")
    ap.add_argument("--out", default="sobel_outputs.npz", help="where the outputs go")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    dev = torch.device(args.device)
    n = 24 if args.smoke else 96
    app = A.ALL_APPS["sobel"]
    mult = C.get("mul16s_mitch10_13")

    v_fxp, _ = A.evaluate(app, "fxp", n=n, seed=1234, device=dev)
    v_nosw, out_ns = A.evaluate(app, None, mult=mult, n=n, seed=1234, device=dev)
    cfg, _, _ = A.tune_app(app, mult, n=n, seed=42, device=dev)
    v_app, out_sw = A.evaluate(app, cfg, mult=mult, n=n, seed=1234, device=dev)
    v_orc, _ = A.evaluate(app, "oracle", mult=mult, n=n, seed=1234, device=dev)

    print(f"sobel SSIM (higher better), multiplier={mult.name}, {n}x{n} on {dev}")
    print(f"  precise FxP       : {v_fxp:.4f}")
    print(f"  NoSwap            : {v_nosw:.4f}")
    print(f"  SWAPPER app-tuned : {v_app:.4f}   (chose {cfg.short() if cfg else 'NoSwap'})")
    print(f"  oracle            : {v_orc:.4f}")
    np.savez(args.out, noswap=np.asarray(torch.as_tensor(out_ns).cpu()),
             swapper=np.asarray(torch.as_tensor(out_sw).cpu()))
    print(f"outputs saved to {args.out}")
    return v_fxp, v_nosw, v_app, v_orc


if __name__ == "__main__":
    main()
