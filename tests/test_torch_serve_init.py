"""Rank-local weights for the model-sharded serve: the counter-addressed
init (``models.layers.counter_normal``, ``models.registry.init_blocks``)
and ``launch.parallel.init_serve_params``, which makes only a rank's
blocks, and ``convert.serve_params_from_jax``, which slices JAX's numpy
leaves before making any tensor.

The reduced configs of seven families (4 layers; whisper 2 + 4) on spawned
``gloo`` worlds of 2 and 4 ranks (``tests/_torch_serve_tp_ranks.py``), over
``("data", "model")`` = (1, 2), (1, 4) and (2, 2) under JAX's default
layout (``fsdp``, ``seq_shard``, ``ep``), ``dp_only`` and ``seq_shard``:

* every rank's ``init_serve_params`` equals ``serve_params(init_blocks(cfg))``
  bit for bit, and so do the offsets each notes (bound 0), or both refuse;
* under JAX's layout no op of ``init_serve_params`` makes a tensor larger
  than the rank's largest block or one chunk (``layers.CHUNK`` at
  ``INIT_CHUNK`` elements, a ``TorchDispatchMode`` watching);
* the reduced qwen2 served from ``init_serve_params`` equals its serve from
  ``serve_params(init_blocks(cfg))``: the prefill's and teacher-forced
  decode steps' logits, greedy tokens and a drift serve (bound 0);
* ``serve_params_from_jax`` of JAX's params equals ``serve_params`` of the
  whole conversion.

Beside them, in this process: a block made alone is the slice of its leaf
made whole (column, row and expert splits, odd offsets, several chunks);
the element hash against its definition in numpy's uint32 arithmetic; an
n-layer tree's first k layers are the k-layer tree's; each random leaf's
mean and standard deviation within 5 standard errors of 0 and its scale,
no two leaves alike; and ``init_params``' seeded stream unchanged (digests
of its trees from before the counter-addressed init was added).
"""
import dataclasses
import hashlib
import math

import jax
import numpy as np
import pytest
import torch

import _torch_serve_tp_ranks as RK
import repro.configs as JC
import repro.models as JM
import repro_torch.configs as TC
from repro_torch.launch.mesh import spawn, tree_paths
from repro_torch.models import init_blocks, init_params, layers
from repro_torch.models.registry import deferred_params

FAMILIES = RK.INIT_FAMILIES
LAYOUTS = [(1, 2), (1, 4), (2, 2)]
PARS = sorted(RK.INIT_PARS)
CONVERT = ("qwen2-72b", "deepseek-moe-16b", "whisper-base")
# sha256 (first 32 hex digits) over each leaf's path and bytes of
# init_params(reduced config, seed=0) on the CPU, taken on the tree before
# the counter-addressed init was added
STREAM = {
    "qwen2-72b": "a152c2ec7989f280d3d34c4bf3cf89ca",
    "qwen2-vl-72b": "a152c2ec7989f280d3d34c4bf3cf89ca",
    "gemma3-27b": "e69160eb3e290d5de8e0618de4d7bf02",
    "deepseek-moe-16b": "e66d88e469c075002bd000366826ccd9",
    "recurrentgemma-2b": "c29932e0dc0fb95df12b22cf3e3e229a",
    "mamba2-370m": "f911826760f7b812e0551175203803b6",
    "whisper-base": "2046a0ca4fda393ecb75de7cfd16c411",
}


def _jax_tree(arch):
    cfg = JC.reduced(JC.ARCHS[arch])
    return jax.device_get(JM.init_params(jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def worlds():
    """A world of 2 ranks at (1, 2), and one of 4 at (1, 4) and (2, 2)."""
    trees = {arch: _jax_tree(arch) for arch in CONVERT}
    two = spawn(RK.jobs_rank, 2, args=([("init_blocks_rank", ((1, 2), FAMILIES, RK.INIT_PARS))],),
                device="cpu", timeout_s=RK.TIMEOUT, threads=1)
    four = spawn(RK.jobs_rank, 4, args=([("init_blocks_rank", ((1, 4), FAMILIES, RK.INIT_PARS)),
                                         ("init_blocks_rank", ((2, 2), FAMILIES, RK.INIT_PARS)),
                                         ("init_serve_rank", ((1, 4),)),
                                         ("init_serve_rank", ((2, 2),)),
                                         ("init_convert_rank", ((1, 4), trees)),
                                         ("init_convert_rank", ((2, 2), trees))],),
                 device="cpu", timeout_s=RK.TIMEOUT, threads=1)
    return {"blocks": {(1, 2): [r[0] for r in two], (1, 4): [r[0] for r in four],
                       (2, 2): [r[1] for r in four]},
            "serve": {(1, 4): [r[2] for r in four], (2, 2): [r[3] for r in four]},
            "convert": {(1, 4): [r[4] for r in four], (2, 2): [r[5] for r in four]}}


@pytest.mark.parametrize("par", PARS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_rank_blocks_equal_serve_params_of_the_whole_tree(worlds, arch, layout, par):
    for rank, r in enumerate(worlds["blocks"][layout]):
        res = r[(arch, par)]
        if "want_refused" in res or "got_refused" in res:
            assert res.get("want_refused") == res.get("got_refused"), (rank, res)
            continue
        assert res["bad"] == [] and res["starts"] == [], (rank, res["bad"], res["starts"])


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_no_tensor_larger_than_a_block_or_a_chunk(worlds, arch, layout):
    for rank, r in enumerate(worlds["blocks"][layout]):
        res = r[(arch, "jax")]
        assert "got_refused" not in res, res
        assert res["made"] <= max(res["largest_block"], RK.INIT_CHUNK), (rank, res)
        # the check can see a whole leaf: the largest is more than a block
        # (whisper's largest, pos_embed, is whole on every rank)
        if arch != "whisper-base":
            assert res["largest_leaf"] > max(res["largest_block"], RK.INIT_CHUNK), (rank, res)


@pytest.mark.parametrize("layout", [(1, 4), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_init_serve_params_serves_as_serve_params_of_the_whole_tree(worlds, layout):
    for rank, r in enumerate(worlds["serve"][layout]):
        got, want = r["init"], r["whole"]
        for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            assert np.array_equal(a, b), (rank, i, float(np.abs(a - b).max()))
        assert np.array_equal(got["tokens"], want["tokens"]), rank
        assert np.array_equal(got["drift"], want["drift"]), rank


@pytest.mark.parametrize("layout", [(1, 4), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", CONVERT)
def test_serve_params_from_jax_equals_serve_params_of_the_whole_conversion(worlds, arch, layout):
    for rank, r in enumerate(worlds["convert"][layout]):
        assert r[arch] == ([], []), (rank, r[arch])


# ---------------------------------------------------------------------------
# the counter-addressed init in this process
# ---------------------------------------------------------------------------

SPLITS = {  # (whole shape, block index): column, row, expert, odd offsets
    "column": ((96, 200), (slice(None), slice(50, 100))),
    "row": ((96, 200), (slice(24, 48),)),
    "expert": ((8, 24, 40), (slice(2, 4),)),
    "expert ff": ((8, 24, 40), (slice(None), slice(None), slice(10, 30))),
    "odd": ((37, 53, 11), (slice(5, 29), slice(1, 52), slice(3, 10))),
    "vector": ((1000,), (slice(333, 667),)),
}


@pytest.mark.parametrize("chunk", [1 << 24, 64])
@pytest.mark.parametrize("split", sorted(SPLITS))
def test_a_block_made_alone_is_the_slice_of_the_whole_leaf(split, chunk, monkeypatch):
    monkeypatch.setattr(layers, "CHUNK", chunk)
    shape, index = SPLITS[split]
    leaf = layers.Deferred(shape, torch.bfloat16, 0.5)
    whole = layers.counter_normal(7, "layers/3/mlp/in/w", leaf, device="cpu")
    block = layers.counter_normal(7, "layers/3/mlp/in/w", leaf, index, device="cpu")
    assert torch.equal(block, whole[index])


def _fmix32_np(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


@pytest.mark.parametrize("seed, path", [(0, "embed/w"), (3, "layers/79/mlp/out/w"),
                                        (2 ** 31 + 5, "layers_dec/1/xattn/q/w")])
def test_the_element_hash_follows_its_definition(seed, path):
    """int32 tensors that wrap hold the uint32 hash: element n is
    ndtri((fmix32(n * 0x27D4EB2F ^ key) >> 9) + 0.5) / 2^23) times the scale."""
    shape = (300, 70)
    leaf = layers.Deferred(shape, torch.float32, 0.25)
    got = layers.counter_normal(seed, path, leaf, device="cpu")
    with np.errstate(over="ignore"):
        n = np.arange(math.prod(shape), dtype=np.uint32)
        h = _fmix32_np((n * np.uint32(0x27D4EB2F)) ^ np.uint32(layers.leaf_key(seed, path)))
    u = ((h >> np.uint32(9)).astype(np.float32) + np.float32(0.5)) * np.float32(2.0 ** -23)
    want = torch.special.ndtri(torch.from_numpy(u)).mul_(0.25).reshape(shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_the_first_layers_of_a_deeper_tree_are_the_shallower_tree(arch):
    cfg = RK.init_config(arch)
    deep = init_blocks(dataclasses.replace(cfg, n_layers=cfg.n_layers + 2), device="cpu")
    shallow = init_blocks(cfg, device="cpu")
    key = "layers_dec" if cfg.family == "encdec" else "layers"
    deep = dict(deep, **{key: deep[key][:cfg.n_layers]})
    pa, la = tree_paths(deep)
    pb, lb = tree_paths(shallow)
    assert pa == pb
    assert all(torch.equal(a, b) for a, b in zip(la, lb))


@pytest.mark.parametrize("arch", FAMILIES)
def test_random_leaves_have_their_scale_and_no_two_are_alike(arch):
    """Mean within 5 standard errors of 0, standard deviation within 5
    standard errors (and 1% for the bf16 rounding) of the leaf's scale; the
    first 512 elements of any two random leaves equal in under 1% of places."""
    cfg = RK.init_config(arch)
    deferred = dict(zip(*tree_paths(deferred_params(cfg, device="cpu"))))
    made = dict(zip(*tree_paths(init_blocks(cfg, device="cpu"))))
    heads = []
    for path, leaf in deferred.items():
        if not isinstance(leaf, layers.Deferred):
            continue
        x = made[path].double().flatten()
        n, s = x.numel(), leaf.scale
        assert abs(float(x.mean())) <= 5 * s / math.sqrt(n), path
        assert abs(float(x.std()) / s - 1) <= 5 / math.sqrt(2 * n) + 0.01, path
        heads.append((path, x[:512]))
    for i, (pa, a) in enumerate(heads):
        for pb, b in heads[i + 1:]:
            k = min(a.numel(), b.numel())
            assert float((a[:k] == b[:k]).double().mean()) < 0.01, (pa, pb)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_stream_is_unchanged(arch):
    cfg = TC.reduced(TC.ARCHS[arch])
    paths, leaves = tree_paths(init_params(cfg, seed=0, device="cpu"))
    h = hashlib.sha256()
    for p, t in zip(paths, leaves):
        h.update(p.encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest()[:32] == STREAM[arch]


def test_whole_init_blocks_is_the_meta_tree_made():
    """``init_blocks(cfg)`` has ``init_params``' paths, shapes and dtypes,
    and its constant leaves are ``init_params``' constants."""
    for arch in FAMILIES:
        cfg = RK.init_config(arch)
        got = dict(zip(*tree_paths(init_blocks(cfg, device="cpu"))))
        meta = dict(zip(*tree_paths(init_params(cfg, device="meta"))))
        seeded = dict(zip(*tree_paths(init_params(cfg, seed=0, device="cpu"))))
        assert list(got) == list(meta)
        for p, t in got.items():
            assert (t.shape, t.dtype) == (meta[p].shape, meta[p].dtype), p
        deferred = dict(zip(*tree_paths(deferred_params(cfg, device="cpu"))))
        for p, leaf in deferred.items():
            if not isinstance(leaf, layers.Deferred):
                assert torch.equal(got[p], seeded[p]), p


def test_init_blocks_refuses_specs_without_a_mesh():
    with pytest.raises(ValueError, match="needs the mesh"):
        init_blocks(RK.init_config("qwen2-72b"), {"embed": {}}, device="cpu")
