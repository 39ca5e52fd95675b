"""Models (counterpart of ``repro.models``): the dense decoder so far."""
from .registry import decode_step, init_cache, init_params, prefill

__all__ = ["init_params", "init_cache", "prefill", "decode_step"]
