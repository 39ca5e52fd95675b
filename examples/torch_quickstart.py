"""Quickstart on the PyTorch port: the whole SWAPPER pipeline on one
non-commutative multiplier (``examples/quickstart.py`` with ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card the component sweep runs the hand-written ``tuning_sweep``
kernel; ``--device cpu`` runs its plain version.
"""
import argparse

import numpy as np
import torch

import repro_torch.core as C


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    dev = torch.device(_parser().parse_args(argv).device)

    # 1. pick a non-commutative approximate multiplier from the library
    mult = C.get("mul8u_trunc0_4")
    print(f"{mult.name}: commutative={C.is_commutative(mult, device=dev)}")

    # 2. error depends on operand order
    a, b = torch.tensor(200, dtype=torch.int32), torch.tensor(13, dtype=torch.int32)
    print(f"m({int(a)},{int(b)})={int(mult.fn(a, b))}  "
          f"m({int(b)},{int(a)})={int(mult.fn(b, a))}  exact={int(a) * int(b)}")

    # 3. component-level tuning: all 4M single-bit decisions, exhaustively
    res = C.component_sweep(mult, tile=256, device=dev)
    best = res.best("mae")
    print(f"NoSwap MAE={res.noswap.mae:.2f}")
    print(f"SWAPPER best bit {best.short()}: MAE={res.per_config[best].mae:.2f} "
          f"(-{100 * res.reduction('mae'):.1f}%)")
    print(f"Oracle bound: MAE={res.oracle.mae:.2f} "
          f"(-{100 * res.theoretical_reduction('mae'):.1f}%)")

    # 4. deploy: a swapped multiplier is just another AxMult
    swapped = C.swapped_mult(mult, best)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, 10000).astype(np.int32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 256, 10000).astype(np.int32)).to(dev)
    exact = (x * y).double()
    e_base = (mult.fn(x, y).double() - exact).abs().mean().item()
    e_swap = (swapped.fn(x, y).double() - exact).abs().mean().item()
    print(f"random-input MAE: NoSwap={e_base:.2f} SWAPPER={e_swap:.2f}")
    return res


if __name__ == "__main__":
    main()
