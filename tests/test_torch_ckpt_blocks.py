"""Checkpoints of a sharded train state, saved a leaf at a time and
restored block by block (``repro_torch.train.checkpoint`` with
``sharding_tree``), beside the JAX package's checkpoint format.

The reduced qwen2 (its AdamW moments in bf16, so its files hold bf16
leaves) and deepseek-moe, 2 layers, f32, on a spawned ``gloo`` world of
four ranks, on ``chip_smoke.py``'s train layouts a4, c4 and JAX's default
on (2, 2) (``_torch_train_mesh_ranks.CKPT_LAYOUTS``), one sharded step from
the counter-addressed init, then (``_torch_train_mesh_ranks.ckpt_rank``):

* the sharded ``save`` and ``AsyncCheckpointer.save_async`` write the file
  that ``save`` of the whole state writes in one process: the same
  manifest, every member's bytes equal, and those of ``np.savez`` of the
  whole state's arrays;
* the JAX package's ``repro.train.checkpoint.restore`` reads it, each leaf
  equal to the port's whole leaf (a bf16 leaf as its 16-bit pattern);
* each layout's file restored onto every layout, and whole in one process,
  gives blocks equal to the whole leaf's blocks (bound 0);
* during a sharded save a rank gathers nothing larger than one whole leaf
  (rank 0 gathers each sharded leaf once, whole), no all-gather runs, and
  rank 0's writer queue fills to its bound and never past it; a leaf
  copied through a staging buffer (as rank 0 copies blocks off a card)
  is the whole leaf;
* ``run_supervised`` on four ranks with a crash after the step-2
  checkpoint ends within 1e-5 of the uninterrupted run, its checkpoints
  written through the gathers onto rank 0, never ``gather_state``;
* a write that fails on rank 0's thread is raised by ``wait`` and leaves
  no checkpoint behind.
"""
import json
import os
import shutil
import tempfile
import zipfile

import numpy as np
import pytest

import _torch_train_mesh_ranks as RK
from repro.train import checkpoint as JCK
from repro_torch.launch.mesh import spawn
from repro_torch.train import checkpoint as C

ARCHS = tuple(RK.CKPT_OPT)
TOL_RESTART = 1e-5          # tests/test_train_runtime.py's restart bound


@pytest.fixture(scope="module")
def saved():
    """(root of the files, each rank's ``ckpt_rank``,
    ``ckpt_supervised_rank`` and ``ckpt_failure_rank`` results)."""
    root = tempfile.mkdtemp(prefix="ckpt_blocks_")
    try:
        ranks = spawn(RK.jobs_rank, 4, args=([
            ("ckpt_rank", (os.path.join(root, "files"), ARCHS)),
            ("ckpt_supervised_rank", (os.path.join(root, "supervised"),)),
            ("ckpt_failure_rank", (os.path.join(root, "failure"),))],),
            device="cpu", timeout_s=RK.TIMEOUT, threads=1)
        yield root, ranks
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _files(root, arch, layout):
    return {kind: os.path.join(root, "files", arch, layout, kind)
            for kind in ("whole", "blocks", "async")}


CASES = [(arch, layout) for arch in ARCHS for layout in RK.CKPT_LAYOUTS]


@pytest.mark.parametrize("kind", ["blocks", "async"])
@pytest.mark.parametrize("arch, layout", CASES)
def test_sharded_save_writes_the_whole_state_file(saved, arch, layout, kind):
    root, _ = saved
    f = _files(root, arch, layout)
    with open(os.path.join(f["whole"], "step_1.json")) as a, \
            open(os.path.join(f[kind], "step_1.json")) as b:
        want, got = json.load(a), json.load(b)
    assert got == want
    if arch == "qwen2-72b":
        assert "bfloat16" in want["dtypes"].values()
    with zipfile.ZipFile(os.path.join(f["whole"], "step_1.npz")) as a, \
            zipfile.ZipFile(os.path.join(f[kind], "step_1.npz")) as b:
        assert a.namelist() == b.namelist() == [f"a{i}.npy" for i in range(len(want["names"]))]
        for name in a.namelist():
            assert b.getinfo(name).compress_type == zipfile.ZIP_STORED
            assert a.read(name) == b.read(name), name


@pytest.mark.parametrize("arch, layout", CASES)
def test_whole_save_holds_np_savez_bytes(saved, arch, layout):
    root, _ = saved
    whole = os.path.join(_files(root, arch, layout)["whole"], "step_1.npz")
    with zipfile.ZipFile(whole) as a, \
            zipfile.ZipFile(os.path.join(root, "files", arch, layout, "savez.npz")) as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name


@pytest.mark.parametrize("arch, layout", CASES)
def test_jax_restore_reads_the_sharded_save(saved, arch, layout):
    root, _ = saved
    f = _files(root, arch, layout)
    with open(os.path.join(f["blocks"], "step_1.json")) as fh:
        manifest = json.load(fh)
    like, _ = C.load_tree(f["whole"], 1)
    got, extra = JCK.restore(f["blocks"], 1, like)
    assert extra == RK.CKPT_EXTRA
    with np.load(os.path.join(f["whole"], "step_1.npz")) as whole:
        for i, path in enumerate(manifest["names"]):
            node = got
            for part in path.split("/"):
                node = node[part]
            want = whole[f"a{i}"]
            j = np.asarray(node)
            if manifest["dtypes"][path] == "bfloat16":
                j, want = j.view(np.uint16), want.view(np.uint16)
            assert j.dtype == want.dtype and j.shape == want.shape, path
            assert np.array_equal(j, want), path


@pytest.mark.parametrize("dst", list(RK.CKPT_LAYOUTS) + ["one"])
@pytest.mark.parametrize("arch, src", CASES)
def test_restore_onto_any_mesh_gives_the_whole_leaves_blocks(saved, arch, src, dst):
    _, ranks = saved
    for rank, r in enumerate(ranks):
        got = r[0][(arch, src)]["restores"]
        if dst == "one" and rank:
            continue
        apart, extra_ok = got[dst]
        assert apart == [] and extra_ok, (rank, apart[:4])


@pytest.mark.parametrize("arch, layout", CASES)
def test_sharded_save_gathers_no_more_than_a_leaf(saved, arch, layout):
    _, ranks = saved
    for rank, r in enumerate(ranks):
        res = r[0][(arch, layout)]
        seen, largest = res["seen"], max(res["sizes"])
        assert res["staged_apart"] == [], (rank, res["staged_apart"][:4])
        assert seen["all_gathers"] == 0 and seen["gather_state"] == 0, (rank, seen)
        assert seen["gathers"] and max(seen["gathers"]) <= largest, (rank, seen["gathers"])
        if rank == 0:
            # each sharded leaf gathered once whole, by the save and again by save_async
            assert seen["gathers"] == res["sharded_sizes"] * 2, (seen["gathers"], res)
            assert seen["queue_bound"] == [C.QUEUE_LEAVES], seen
            assert seen["queue_most"] == C.QUEUE_LEAVES, seen
        else:
            assert seen["queue_bound"] == [] and seen["queue_most"] == 0, (rank, seen)
    assert any(res["sharded_sizes"] for res in (r[0][(arch, layout)] for r in ranks))


def test_supervised_crash_on_four_ranks_resumes_through_the_sharded_save(saved):
    root, ranks = saved
    for rank, r in enumerate(ranks):
        (ref, ref_log, ref_step, ref_seen), (got, log, step, seen) = \
            r[1]["ref"], r[1]["chaos"]
        assert ref_log["restarts"] == 0 and log["restarts"] == 1, (ref_log, log)
        assert ref_step == step == 6
        for p, want in ref.items():
            gap = np.linalg.norm(got[p] - want) / max(np.linalg.norm(want), 1e-30)
            assert gap <= TOL_RESTART, (rank, p, gap)
        for s in (ref_seen, seen):
            assert s["gather_state"] == 0 and s["gathers"], (rank, s)
    for label in ("ref", "chaos"):
        d = os.path.join(root, "supervised", label)
        assert sorted(fn for fn in os.listdir(d) if fn.endswith(".npz")) == \
            ["step_2.npz", "step_4.npz", "step_6.npz"]


def test_failed_write_is_raised_and_leaves_no_checkpoint(saved):
    _, ranks = saved
    raised = [r[2][0] for r in ranks]
    assert raised == ["disk full", None, None, None], raised
    for _, files in (r[2] for r in ranks):
        assert not any(fn.startswith("step_") for fn in files), files
