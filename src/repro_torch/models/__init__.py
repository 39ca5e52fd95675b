"""Models (counterpart of ``repro.models``): the decoder-only families and
the encoder-decoder."""
from .registry import decode_step, init_cache, init_params, prefill, train_loss

__all__ = ["init_params", "init_cache", "train_loss", "prefill", "decode_step"]
