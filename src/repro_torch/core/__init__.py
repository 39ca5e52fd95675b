"""SWAPPER core on integer tensors: multipliers, the swapper, metrics,
tiling (counterpart of ``repro.core``)."""
from .metrics import ErrorStats, abs_err
from .multipliers import (
    REGISTRY,
    AxMult,
    broken_array,
    drum,
    exact,
    get,
    lut_mult,
    make_lut,
    mitchell,
    operand_table,
    perforate,
    trunc,
)
from .swapper import (
    NO_SWAP_TRIPLE,
    SwapConfig,
    all_configs,
    apply_swapper,
    apply_swapper_dyn,
    cfg_to_triple,
    oracle_mult,
    swap_mask,
    swap_mask_dyn,
)
from .tiling import largest_divisor_leq, rowtile_count, rowtile_index, rowtile_span

__all__ = [n for n in dir() if not n.startswith("_")]
