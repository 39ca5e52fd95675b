"""Serving (counterpart of ``repro.serve``)."""
from .engine import ServeConfig, generate, prefill_one, slot_sample, splice_slot, token_step

__all__ = ["ServeConfig", "generate", "slot_sample", "token_step", "prefill_one",
           "splice_slot"]
