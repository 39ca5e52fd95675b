"""SWAPPER core on integer tensors: multipliers, the swapper, metrics,
tiling, the tuning framework, the Eq. 6 modular multiply and the Q16.16
math library (counterpart of ``repro.core``)."""
from .fixedpoint import FX_ONE, FxpMath, from_fxp, make_mul, to_fxp
from .metrics import METRICS, ErrorStats, abs_err, are, ep, mae, mse, wce
from .modular import PART_ALL, PART_MD_LO, PART_NONE, AxMul32Config, ax_fxp_mul, ax_fxp_mul_dyn
from .multipliers import (
    REGISTRY,
    AxMult,
    broken_array,
    drum,
    exact,
    get,
    is_commutative,
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
    swapped_mult,
)
from .tiling import largest_divisor_leq, rowtile_count, rowtile_index, rowtile_span
from .tuning import (
    ComponentResult,
    TwoBitConfig,
    apply_swapper_two_bit,
    component_sweep,
    operand_values,
    swap_mask_two_bit,
    tile_stats,
    tune_application,
    two_bit_sweep,
)

__all__ = [n for n in dir() if not n.startswith("_")]
