"""Deterministic synthetic data with checkpointable state
(``repro.train.data``).

Tokens are a position-hashed stream (splitmix64 of the global index, in
numpy, bit for bit the JAX package's): any (step, index) cell is computable
without history, so a restarted job resumes bit-identically from the step
counter alone.  ``FileStream`` reads a flat int32 token file on the local
disk with the same interface.  Batches are numpy int32 arrays; the train
step moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DataConfig", "SyntheticStream", "FileStream", "make_batch_specs"]


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mode: str = "hash"   # 'hash' (uniform) | 'arith' (next = (tok + 1) mod vocab: learnable)


def _hash_tokens(step, cfg: DataConfig) -> np.ndarray:
    """(B, S+1) deterministic pseudo-tokens for a global step (splitmix64;
    the uint64 wraparound is intended)."""
    B, S = cfg.global_batch, cfg.seq_len
    with np.errstate(over="ignore"):
        idx = (np.uint64(step) * np.uint64(B * (S + 1))
               + np.arange(B * (S + 1), dtype=np.uint64)
               + np.uint64(cfg.seed) * np.uint64(0x9E3779B97F4A7C15))
        z = idx + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    toks = (z % np.uint64(cfg.vocab)).astype(np.int32).reshape(B, S + 1)
    if cfg.mode == "arith":
        toks = (toks[:, :1] + np.arange(S + 1, dtype=np.int32)[None]) % cfg.vocab
    return toks


class SyntheticStream:
    """The state is the step counter (kept in checkpoints)."""

    def __init__(self, cfg: DataConfig, step: int = 0):
        self.cfg = cfg
        self.step = step

    def next(self) -> dict:
        toks = _hash_tokens(self.step, self.cfg)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])
        return self


class FileStream:
    """A flat binary int32 token file on the local disk, read in sequential
    epochs; the same interface as :class:`SyntheticStream`."""

    def __init__(self, path: str, cfg: DataConfig, step: int = 0):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.step = step
        self.per_step = cfg.global_batch * (cfg.seq_len + 1)

    def next(self) -> dict:
        n = len(self.tokens) - self.per_step
        off = (self.step * self.per_step) % max(n, 1)
        flat = np.asarray(self.tokens[off:off + self.per_step])
        self.step += 1
        toks = flat.reshape(self.cfg.global_batch, self.cfg.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])
        return self


def make_batch_specs(cfg: DataConfig):
    """``{name: (shape, dtype)}`` of a batch."""
    shp = (cfg.global_batch, cfg.seq_len)
    return {"tokens": (shp, torch.int32), "labels": (shp, torch.int32)}
