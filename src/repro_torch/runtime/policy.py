"""Granular SWAPPER policies (``repro.runtime.policy``): hierarchical maps
from keys to single-bit configs, plus per-row-tile config grids.

* ``"*"``            — global default (the paper's single tuned config)
* ``"mlp"``          — per projection target
* ``"layer3/mlp"``   — per layer (keys fall back ``layer3/mlp`` → ``mlp`` → ``*``)
* tile grids         — (gm, gn, 3) int32 triple grids, the grid kernel's input

Policies serialize to the JAX package's JSON format, key for key: a file
written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import AxPolicy
from repro_torch.core.swapper import NO_SWAP_TRIPLE, SwapConfig, cfg_to_triple

from .scope import GLOBAL_KEY, fallback_chain

__all__ = ["SwapPolicy", "triple_of", "triple_short", "NO_SWAP_TRIPLE"]

triple_of = cfg_to_triple


def _cfg_from_triple(t) -> Optional[SwapConfig]:
    op_is_a, bit, value = (int(v) for v in t)
    if value not in (0, 1):
        return None
    return SwapConfig("A" if op_is_a else "B", bit, value)


def triple_short(t) -> str:
    """``"ns"`` for the NoSwap encoding, else ``"A[b]==v"`` / ``"B[b]==v"``."""
    cfg = _cfg_from_triple(t)
    return "ns" if cfg is None else cfg.short()


@dataclasses.dataclass
class SwapPolicy:
    """A granular, serializable SWAPPER configuration map."""

    mult_name: str
    configs: Dict[str, Optional[SwapConfig]] = dataclasses.field(default_factory=dict)
    tile_grids: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)
    version: int = 0

    # -- lookups ------------------------------------------------------
    def lookup(self, key: str) -> Optional[SwapConfig]:
        for k in fallback_chain(key):
            if k in self.configs:
                return self.configs[k]
        return None

    def set_config(self, key: str, cfg: Optional[SwapConfig]) -> None:
        self.configs[key] = cfg
        self.version += 1

    def dyn_tree(self, keys: Sequence[str], tile_rows: int = 0,
                 device="cuda") -> Dict[str, torch.Tensor]:
        """Per-key int32 tensors on ``device`` for ``runtime.scope.ax_scope``:
        the resolved (op_is_a, bit, value) triple of each key, or in tile
        mode (``tile_rows > 0``) a (tile_rows, 1, 3) per-row-tile grid
        (:meth:`tile_grid`).  Keys and shapes depend on ``(keys,
        tile_rows)`` only; a policy update changes values."""
        if tile_rows > 0:
            vals = {k: self.tile_grid(k, tile_rows, 1) for k in keys}
        else:
            vals = {k: np.asarray(triple_of(self.lookup(k)), np.int32) for k in keys}
        return {k: torch.as_tensor(v, dtype=torch.int32, device=device)
                for k, v in vals.items()}

    # -- per-row-tile grids -------------------------------------------
    def set_tile_grid(self, key: str, grid: np.ndarray) -> None:
        """Install a (gm, gn, 3) int32 per-tile config grid for ``key``
        (bumps the version like :meth:`set_config`).  A grid may mix A-side
        and NoSwap tiles freely, and may hold B-side tiles only if they all
        carry the same triple: heterogeneous B-side decisions are the one
        family the JAX package's single-dispatch ``mxu`` factorization
        cannot express, so they are refused here for portability."""
        grid = np.asarray(grid, np.int32)
        if grid.ndim != 3 or grid.shape[-1] != 3:
            raise ValueError(f"a tile grid is (gm, gn, 3): {grid.shape}")
        b_side = grid.reshape(-1, 3)
        b_side = np.unique(b_side[(b_side[:, 0] == 0) & (b_side[:, 2] <= 1)], axis=0)
        if len(b_side) > 1:
            raise ValueError(
                f"tile grid for {key!r} mixes different B-side triples "
                f"({b_side.tolist()}): use one B-side config uniformly, or "
                f"A-side/NoSwap per tile")
        self.tile_grids[key] = grid
        self.version += 1

    def tile_grid(self, key: str, gm: int, gn: int) -> np.ndarray:
        """(gm, gn, 3) int32 config grid: a stored grid resampled to the
        requested tiling (tile i reads stored tile ``i * stored_gm // gm``),
        else the key's single config broadcast to every tile."""
        if key in self.tile_grids:
            g = self.tile_grids[key]
            ri = (np.arange(gm) * g.shape[0]) // gm
            ci = (np.arange(gn) * g.shape[1]) // gn
            return np.ascontiguousarray(g[ri][:, ci]).astype(np.int32)
        t = np.asarray(triple_of(self.lookup(key)), np.int32)
        return np.broadcast_to(t, (gm, gn, 3)).astype(np.int32).copy()

    # -- constructors --------------------------------------------------
    @classmethod
    def from_ax_policy(cls, ax: AxPolicy) -> "SwapPolicy":
        """Lift the static (globally-tuned) AxPolicy into a policy map."""
        return cls(mult_name=ax.mult_name, configs={GLOBAL_KEY: ax.swap})

    # -- serialization -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dict(
            mult_name=self.mult_name,
            version=self.version,
            configs={k: (None if c is None else list(triple_of(c)))
                     for k, c in self.configs.items()},
            tile_grids={k: g.tolist() for k, g in self.tile_grids.items()},
            meta=_jsonable(self.meta),
        ), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SwapPolicy":
        d = json.loads(text)
        return cls(
            mult_name=d["mult_name"],
            configs={k: (None if t is None else _cfg_from_triple(t))
                     for k, t in d["configs"].items()},
            tile_grids={k: np.asarray(g, np.int32)
                        for k, g in d.get("tile_grids", {}).items()},
            meta=d.get("meta", {}),
            version=int(d.get("version", 0)),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "SwapPolicy":
        with open(path) as f:
            return cls.from_json(f.read())

    def configs_equal(self, other: "SwapPolicy") -> bool:
        """True when both policies resolve identically (multiplier, config
        map, bit-equal tile grids); version and meta are not compared."""
        if self.mult_name != other.mult_name or self.configs != other.configs:
            return False
        if set(self.tile_grids) != set(other.tile_grids):
            return False
        return all(np.array_equal(g, other.tile_grids[k])
                   for k, g in self.tile_grids.items())

    def describe(self) -> str:
        parts = [f"policy[{self.mult_name} v{self.version}]"]
        for k, c in sorted(self.configs.items()):
            parts.append(f"{k}={'noswap' if c is None else c.short()}")
        for k, g in sorted(self.tile_grids.items()):
            short = ",".join(triple_short(t) for t in g.reshape(-1, 3))
            parts.append(f"{k}[tiles {g.shape[0]}x{g.shape[1]}]=({short})")
        return " ".join(parts)


def _jsonable(meta: Dict[str, object]):
    return {k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in meta.items()}
