"""Rank-local train state: ``train.init_train_blocks`` makes a rank's
blocks of the counter-addressed init's train state (``models.registry.
init_blocks`` under ``train.distributed.state_specs``, the AdamW moments
zeros of the blocks) without the whole state.

The reduced qwen2 and deepseek-moe on a spawned ``gloo`` world of four
ranks, on ``chip_smoke.py``'s train layouts (a)-(e)
(``_torch_train_mesh_ranks.GATHER_LAYOUTS``; JAX's default on (e)):

* every rank's ``init_train_blocks`` equals ``local_state(
  init_train_state(init_blocks(cfg)), specs, mesh)`` bit for bit, every
  leaf (parameters, moments, step) in shape, dtype and bits (bound 0);
* no op of ``init_train_blocks`` makes a tensor larger than the rank's
  largest block or one chunk (``layers.CHUNK`` at ``INIT_CHUNK``
  elements, a ``TorchDispatchMode`` watching); on the FSDP layouts (a)
  and (e) the largest whole leaf is larger than that bound, so the check
  would see a whole leaf made.
"""
import pytest

import _torch_train_mesh_ranks as RK
from repro_torch.launch.mesh import spawn

ARCHS = ("qwen2-72b", "deepseek-moe-16b")
LAYOUTS = sorted(RK.GATHER_LAYOUTS)
INIT_CHUNK = 4096


@pytest.fixture(scope="module")
def ranks():
    return spawn(RK.train_init_rank, 4, args=(ARCHS, INIT_CHUNK), device="cpu",
                 timeout_s=RK.TIMEOUT, threads=1)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_train_blocks_equals_the_blocks_of_the_whole_state(ranks, arch, layout):
    for rank, r in enumerate(ranks):
        assert r[(arch, layout)]["bad"] == [], (rank, r[(arch, layout)]["bad"])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_train_blocks_makes_no_tensor_larger_than_a_block_or_a_chunk(ranks, arch, layout):
    for rank, r in enumerate(ranks):
        res = r[(arch, layout)]
        assert res["made"] <= max(res["largest_block"], INIT_CHUNK), (rank, res)
        if layout in ("a", "e"):
            assert res["largest_leaf"] > max(res["largest_block"], INIT_CHUNK), (rank, res)
