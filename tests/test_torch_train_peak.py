"""The sharded train step's peak memory grows with depth by the added
layers' blocks, not by their whole weights and gradients (the per-layer
gathers, ``train/distributed.py``).

Rank 0's step of the reduced qwen2 at 2 and 4 layers under JAX's default
layout (``fsdp``, ``seq_shard``, ``ep``) on ``("data", "model")`` = (2, 2),
a fake world of four ranks in this process under ``FakeTensorMode``, as
the dry run runs a cell (``launch/dryrun.py``), with ``torch.distributed.
_tools.mem_tracker.MemTracker`` reading the peak, the inputs (the rank's
blocks of the state and the global batch of 8 x 32) included.  The bound
on the growth is the added layers' state blocks (parameters and the two
moments, f32) times 8/3: the state, its gradient, the gradient's clipped
f32 copy (``optimizer.adamw_update``) and the updated state, each held
at once while the update runs.  Measured: 8/3 exactly under ``remat``
"none" and "layer".  The whole-step gather
(``_torch_train_mesh_ranks.whole_gather_step``) grows by 3.33 times the
state blocks there (its whole gradients and whole weights beside the
blocks), so the bound would see it.
"""
import dataclasses

import pytest
import torch

import _torch_train_mesh_ranks as RK
from repro_torch import configs as TC
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, tree_paths
from repro_torch.quant.ax import weight_cache
from repro_torch.train import AdamWConfig, fresh_train_state, make_train_step
from repro_torch.train import distributed as D

B, S = 8, 32
DEPTHS = (2, 4)
# state + gradient + clipped gradient + updated state, over the state: 8 / 3
GROWTH_NUM, GROWTH_DEN = 8, 3


def _peak(n_layers: int, remat: str, whole: bool):
    """(peak bytes, the rank's state bytes) of one fake step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    cfg = dataclasses.replace(TC.reduced(TC.ARCHS["qwen2-72b"]), n_layers=n_layers)
    par = ParallelConfig(fsdp=True, seq_shard=True, ep=True, remat=remat)
    opt = AdamWConfig()
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        specs = D.state_specs(cfg, opt, mesh, par)
        meta = fresh_train_state(cfg, opt, device="meta")
        step = (RK.whole_gather_step(cfg, par, opt, mesh) if whole
                else make_train_step(cfg, par, opt, mesh=mesh))
        with dryrun._own_caches(), weight_cache(False), FakeTensorMode():
            tracker = MemTracker()
            with tracker:
                state = dryrun._fakes(meta, specs, mesh)
                tok = torch.zeros((B, S), dtype=torch.int32)
                step(state, {"tokens": tok, "labels": tok})
            peak = max(v["Total"] for v in tracker.get_tracker_snapshot("peak").values())
            state_bytes = sum(t.numel() * t.element_size() for t in tree_paths(state)[1])
    return peak, state_bytes


@pytest.mark.parametrize("remat", ["none", "layer"])
def test_peak_grows_by_the_added_layers_blocks(remat):
    (p2, s2), (p4, s4) = (_peak(n, remat, whole=False) for n in DEPTHS)
    assert s4 > s2
    assert GROWTH_DEN * (p4 - p2) <= GROWTH_NUM * (s4 - s2), (p2, p4, s2, s4,
                                                            (p4 - p2) / (s4 - s2))


def test_the_bound_sees_the_whole_step_gather():
    (p2, s2), (p4, s4) = (_peak(n, "layer", whole=True) for n in DEPTHS)
    assert GROWTH_DEN * (p4 - p2) > GROWTH_NUM * (s4 - s2), (p2, p4, s2, s4,
                                                           (p4 - p2) / (s4 - s2))
