"""The model-sharded serve's float sums in rank order, and what lets its
decode step be captured as a CUDA graph over ``nccl``, on a spawned
``gloo`` world of 4 ranks (``tests/_torch_serve_tp_ranks.py::order_rank``).

* The split decode attention's combine (``layers.decode_attention_split``
  over the K/V group of a ``("data", "model")`` = (1, 4) mesh, each rank
  its block of the cache's sequence): bit-equal (bound 0) on every rank to
  one process adding the four blocks' partial sums in rank order, the
  witness of ``chip_smoke.py`` (``tps_witness(4, attention=True)``, the
  card's reference for four ``nccl`` ranks), for a qwen2-72b cache (64
  query heads over 8 kv heads) and a deepseek-moe-16b one (16 and 16), in
  f32 and bf16; the f32 results also within ``TOL`` of JAX's
  ``decode_attention`` over the whole cache, the bound of
  ``tests/test_torch_serve_tp.py``.  ``gloo``'s own SUM over 4 ranks adds
  in its ring's order, which moves the last bits.
* The graph predicate (``serve.engine.model_sharded_graphs``): False under
  ``gloo``, True where every group reports ``nccl`` (``dist.get_backend``
  replaced on the CPU), and the continuous batcher's token step asks for
  graphs exactly then.  The refusals of ``generate`` and ``token_step`` as
  CUDA graphs under ``gloo`` are ``tests/test_torch_serve_tp.py``'s.
* A program key's part of the context (``serve.engine._mesh_sig``): the
  same for the same mesh, another for each rank's model block and for
  another layout.
* A second observed adaptive token step at (2, 2), on the reduced qwen2
  whose query heads split its kv head's group and whose batch splits over
  ``"data"``: no ``torch.tensor`` from a host list or tuple (a CUDA graph
  cannot capture the copy).
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_tp_ranks as RK
from repro.models.layers import decode_attention as j_decode_attention
from repro_torch.launch.mesh import spawn
from repro_torch.models import layers

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
# (B, L, KV, H, hd, dtype, seed): qwen2-72b's and deepseek-moe-16b's heads,
# a 48-row cache, 12 rows a rank
CASES = [(4, 48, 8, 64, 128, "float32", 1), (4, 48, 16, 16, 128, "float32", 2),
         (4, 48, 8, 64, 128, "bfloat16", 3), (4, 48, 16, 16, 128, "bfloat16", 4)]


@pytest.fixture(scope="module")
def ranks():
    return spawn(RK.order_rank, 4, args=(CASES,), device="cpu", timeout_s=RK.TIMEOUT,
                 threads=1)


def _witness(case):
    """The whole cache's decode attention as one device adding the four
    blocks in rank order (``chip_smoke.tps_witness``'s ``attend``)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    q, k, v, ci, kv_len = (torch.from_numpy(a) for a in RK.order_inputs(case))
    q, k, v = (t.to(getattr(torch, case[5])) for t in (q, k, v))
    with chip_smoke.tps_witness(4, attention=True):
        return layers.decode_attention(q, k, v, ci, kv_len).float().numpy()


@pytest.mark.parametrize("case", range(len(CASES)), ids=[
    f"{'qwen2' if c[2] == 8 else 'deepseek'}-{c[5]}" for c in CASES])
def test_decode_combine_adds_in_rank_order(ranks, case):
    want = _witness(CASES[case])
    for r in ranks:
        assert np.array_equal(r["combine"][case], want), \
            float(np.abs(r["combine"][case] - want).max())
    if CASES[case][5] == "float32":
        q, k, v, ci, kv_len = RK.order_inputs(CASES[case])
        ref = np.asarray(j_decode_attention(*(jnp.asarray(a) for a in (q, k, v, ci, kv_len))))
        assert float(np.abs(want - ref).max()) <= TOL * float(np.abs(ref).max())


def test_graphs_are_allowed_exactly_where_every_group_is_nccl(ranks):
    for r in ranks:
        assert r["backend"] == "gloo"
        assert r["graphs gloo"] is False and r["batcher graphs gloo"] is False
        assert r["graphs nccl"] is True and r["batcher graphs nccl"] is True


def test_program_keys_name_the_mesh_context(ranks):
    sigs = [r["sig"] for r in ranks]
    for r in ranks:
        assert r["sig"] == r["sig again"] != "None"
        assert r["sig 22"] != r["sig"]
    assert len(set(sigs)) == 4


def test_a_model_sharded_step_copies_nothing_from_a_host_list(ranks):
    for r in ranks:
        assert r["host lists"]["calls"] == [], r["host lists"]["calls"]
        assert r["host lists"]["records"] == ["attn_out", "attn_out@tiles", "mlp", "mlp@tiles"]
