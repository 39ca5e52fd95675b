"""The serve CLI's synthetic drift (``repro.launch.serve._drift_hook``).
The command-line front end itself is the serve CLI item of ROADMAP
queue 1."""
from __future__ import annotations

import torch

__all__ = ["drift_hook"]


def _tree_map(fn, t):
    if isinstance(t, dict):
        return {k: _tree_map(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree_map(fn, v) for v in t]
    return fn(t)


def drift_hook(at_step: int, scale: float):
    """A ``generate`` param_hook that, at ``at_step`` (once), returns new
    params in which every other row of each weight's *input*
    (second-to-last) axis is multiplied by ``scale``.  Weight quantization
    reduces over exactly that axis, so the alternating pattern inside each
    column shifts the int8 code distribution of the quantized weights; a
    uniform scale would be quantization invariant.  The input params are
    left as they are (the JAX package's ``jax.tree.map`` is functional too),
    so for one step both copies are alive."""
    done = {"fired": False}

    def perturb(w):
        if w.dim() < 2:
            return w
        mask = (torch.arange(w.shape[-2], device=w.device) % 2 == 0)[:, None]
        return torch.where(mask, w * scale, w)

    def hook(step, params):
        if step != at_step or done["fired"]:
            return params
        done["fired"] = True
        return _tree_map(perturb, params)

    return hook
