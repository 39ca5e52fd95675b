"""Serving (counterpart of ``repro.serve``)."""
from .engine import ServeConfig, generate

__all__ = ["ServeConfig", "generate"]
