"""AdamW with warmup, global-norm clipping and decoupled weight decay, all
in f32, with an optional compressed path: ``compress="bf16"`` stores the
moments in bf16 and rounds the gradient to bf16 with an f32 error-feedback
accumulator (``repro.train.optimizer``).

Plain functions on nested dicts and lists of tensors.  ``adamw_update``
returns new tensors (the parameters and state it was given are left as
they were, as the JAX package's functional update leaves them) and runs
under ``torch.no_grad()``.  The step counter is an int32 0-d tensor on the
parameters' device and every scalar of the update (learning rate, clip
scale, bias corrections) stays there, so an update reads nothing back to
the host.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "tree_map", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    compress: str = "none"   # 'none' | 'bf16' (grads+moments in bf16 + error feedback)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of nested dicts and lists, several trees of
    one structure together."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree):
    """The tensors of nested dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def adamw_init(params, cfg: AdamWConfig):
    if cfg.compress not in ("none", "bf16"):
        raise ValueError(f"AdamWConfig.compress: 'none' or 'bf16', not {cfg.compress!r}")
    mdtype = torch.bfloat16 if cfg.compress == "bf16" else torch.float32
    device = tree_leaves(params)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdtype, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=mdtype, device=p.device), params),
    }
    if cfg.compress == "bf16":
        # the error feedback keeps the quantization residual in f32
        state["ef"] = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)
    return state


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 0-d tensor filled on ``like``'s device (no host copy)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def global_norm(tree, replicas=None, group=None) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's f32 sum of squares.
    Over a mesh (the sharded step) each leaf is a rank's block: ``replicas``
    (one count per leaf: the ranks holding the same block) divides its sum,
    and the sums are all-reduced over ``group``, so every element counts
    once."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i, x in enumerate(leaves):
        xf = x.to(torch.float32)
        sq = (xf * xf).sum()
        total = total + (sq if replicas is None or replicas[i] == 1 else sq / replicas[i])
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(total, group=group)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig, replicas=None, group=None):
    """One AdamW step; returns (new params, new state, {"grad_norm", "lr"})
    (module note).  Under the sharded step the trees hold the rank's blocks
    (the moments and ``ef`` follow their parameter's spec; ``step`` is
    replicated) and the grad norm runs over them (``global_norm``'s
    ``replicas`` and ``group``); the update is element-wise."""
    step = state["step"] + 1
    stepf = step.to(torch.float32)
    lr = cfg.lr * torch.minimum(_f32(1.0, stepf), stepf / max(cfg.warmup, 1))

    gnorm = global_norm(grads, replicas, group)
    scale = torch.minimum(_f32(1.0, gnorm),
                          cfg.clip_norm / torch.maximum(gnorm, _f32(1e-9, gnorm)))
    grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)

    new_state = {"step": step}
    if cfg.compress == "bf16":
        # error feedback: g_q = bf16(g + ef); ef' = (g + ef) - g_q
        summed = tree_map(lambda g, e: g + e, grads, state["ef"])
        gq = tree_map(lambda s_: s_.to(torch.bfloat16), summed)
        new_state["ef"] = tree_map(lambda s_, q: s_ - q.to(torch.float32), summed, gq)
        grads = tree_map(lambda q: q.to(torch.float32), gq)

    c1 = 1 - _f32(cfg.b1, stepf) ** stepf
    c2 = 1 - _f32(cfg.b2, stepf) ** stepf

    def upd(g, m, v, p):
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        p_new = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return p_new, m_new.to(m.dtype), v_new.to(v.dtype)

    out = tree_map(upd, grads, state["m"], state["v"], params)
    new_params, new_state["m"], new_state["v"] = (_pick(out, i) for i in range(3))
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def _pick(tree, i: int):
    """Element ``i`` of each tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
