"""Models (counterpart of ``repro.models``): the decoder-only families."""
from .registry import decode_step, init_cache, init_params, prefill

__all__ = ["init_params", "init_cache", "prefill", "decode_step"]
