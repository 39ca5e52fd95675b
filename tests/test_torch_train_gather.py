"""The sharded train step's per-layer gathers (``train/distributed.py``:
each layer gathers its own parameter blocks where it runs, and autograd
reduce-scatters their gradients to the blocks as the backward leaves the
layer) held to the whole-step gather (``_torch_train_mesh_ranks.
whole_gather_step``: every block gathered once before the first
microbatch, the whole gradients reduce-scattered once after the last).

One spawned ``gloo`` world of four ranks runs every job: a step of each
from the same ``init_train_blocks`` state on the same global batch of 8 x
16, each backward on a thread of its own (as autograd runs a card's), on
``chip_smoke.py``'s layouts (a) FSDP over ``("data",)`` = 4, (b) ``dp_only``
+ ``ep`` on (1, 4), (c) tensor parallelism + ``ep`` on (1, 4), (d) (c) with
``seq_shard``, (e) JAX's default (``fsdp``, ``seq_shard``, ``ep``) on (2, 2):

* bit for bit (bound 0: the new blocks, moments and step, and every
  metric) for the reduced qwen2 (f32, exact) and deepseek-moe (``mxu``)
  on (a)-(e) under ``remat`` "none" and "layer", ``grad_accum = 1``;
* where the sum of a gradient changes order, within ``TOL_GRAD_NORM``
  (grad norm, relative) and ``TOL_UPDATE`` (each leaf's update, |d_new -
  d_old| / |d_old|), with the loss, ``ce`` and ``aux`` equal: the tied
  embeddings of gemma3 and whisper, gathered and reduce-scattered at the
  lookup and again at the head (the oracle adds the two whole gradients
  before one reduce-scatter), and ``grad_accum = 2``, where each
  microbatch's gradient is reduce-scattered before the blocks' sum.
  Measured: grad norms equal, updates 4.2e-8 to 6.6e-8 (tied) and 9.1e-7
  to 9.1e-6 (``grad_accum = 2``).

After every step each replicated leaf, moments included, is bit-equal on
the ranks that hold it (``D.replicas_apart``).
"""
import numpy as np
import pytest

import _torch_train_mesh_ranks as RK
from repro_torch.launch.mesh import spawn

TOL_GRAD_NORM, TOL_UPDATE = 1e-6, 1e-4
EXACT = [(f"{arch} {layout} {remat}", arch, cfg, layout, {"remat": remat})
         for arch, cfg in (("qwen2-72b", {}), ("deepseek-moe-16b", {"ax": "mxu"}))
         for layout in sorted(RK.GATHER_LAYOUTS) for remat in ("none", "layer")]
NEAR = [("gemma3-27b tied a", "gemma3-27b", {}, "a", {}),
        ("gemma3-27b tied e layer", "gemma3-27b", {}, "e", {"remat": "layer"}),
        ("whisper-base tied a", "whisper-base", {}, "a", {}),
        ("whisper-base tied e", "whisper-base", {}, "e", {}),
        ("qwen2-72b accum2 a", "qwen2-72b", {}, "a", {"grad_accum": 2}),
        ("qwen2-72b accum2 e layer", "qwen2-72b", {"ax": "mxu"}, "e",
         {"grad_accum": 2, "remat": "layer"}),
        ("deepseek-moe-16b accum2 e", "deepseek-moe-16b", {"ax": "mxu"}, "e",
         {"grad_accum": 2})]


@pytest.fixture(scope="module")
def ranks():
    return spawn(RK.gather_rank, 4, args=(EXACT + NEAR,), device="cpu", timeout_s=RK.TIMEOUT,
                 threads=1)


@pytest.mark.parametrize("job", [j[0] for j in EXACT])
def test_per_layer_gathers_equal_the_whole_step_gather(ranks, job):
    for rank, r in enumerate(ranks):
        res = r[job]
        assert res["bits"], (rank, res["metrics"], res["old_metrics"])
        assert res["replicas"][0] == [] and res["replicas"][1] > 0, (rank, res["replicas"])
    assert all(np.isfinite(v) for v in ranks[0][job]["metrics"].values())


@pytest.mark.parametrize("job", [j[0] for j in NEAR])
def test_reordered_gradient_sums_stay_near_the_whole_step_gather(ranks, job):
    for rank, r in enumerate(ranks):
        res = r[job]
        m, old = res["metrics"], res["old_metrics"]
        assert all(m[k] == old[k] for k in ("loss", "ce", "aux")), (rank, m, old)
        assert RK.rel(m["grad_norm"], old["grad_norm"]) <= TOL_GRAD_NORM, (rank, m, old)
        assert res["replicas"][0] == [] and res["replicas"][1] > 0, (rank, res["replicas"])
    new, old, start = ranks[0][job]["params"]
    gaps = RK.update_gaps(new, old, start)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= TOL_UPDATE, (worst, gaps[worst])
