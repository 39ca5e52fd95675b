"""Fig. 1 analog on the PyTorch port: error-surface maps (text rendering and
an .npz dump) of a non-commutative multiplier without swap, with SWAPPER and
for the oracle (``examples/error_profile.py`` with ``repro_torch``).

    PYTHONPATH=src python examples/torch_error_profile.py [--device cpu] [--out FILE]
"""
import argparse

import numpy as np
import torch

import repro_torch.core as C


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--out", default="error_profile.npz", help="where the surfaces go")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    dev = torch.device(args.device)
    mult = C.get("mul8u_drum2_6")
    best = C.component_sweep(mult, tile=256, device=dev).best("mae")

    vals = torch.arange(256, dtype=torch.int32, device=dev)
    A, B = torch.meshgrid(vals, vals, indexing="ij")
    exact = mult.exact_product(A, B)
    surfaces = {
        "noswap": mult.fn(A, B),
        "swapper": C.apply_swapper(mult, A, B, best),
        "oracle": C.oracle_mult(mult).fn(A, B),
    }
    errs = {k: C.abs_err(v, exact, mult.signed).cpu().numpy() for k, v in surfaces.items()}
    np.savez(args.out, **errs)
    print(f"{mult.name}, best bit {best.short()} - coarse error maps (16x16 blocks,"
          " '.' low error .. '#' high):")
    chars = " .:-=+*#%@"
    for name, e in errs.items():
        blk = e.astype(float).reshape(16, 16, 16, 16).mean((1, 3))
        mx = blk.max() or 1.0
        print(f"\n[{name}] MAE={e.astype(float).mean():.1f}")
        for row in blk:
            print("".join(chars[min(int(v / mx * 9.999), 9)] for v in row))
    print(f"\nfull surfaces saved to {args.out}")
    return errs


if __name__ == "__main__":
    main()
