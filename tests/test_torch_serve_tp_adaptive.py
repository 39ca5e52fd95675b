"""Adaptive serving of a model-sharded model: ``generate(par=, adaptive=,
param_hook=)``, ``token_step``/``prefill_one``/``splice_slot`` with ``par``
and the token-mode ``ContinuousBatcher(adaptive=, par=)`` under
``set_mesh_ctx`` of a ``("data", "model")`` mesh, held to the JAX package's
own GSPMD serve: JAX's ``generate`` and batcher under ``set_mesh_ctx`` on a
directly built ``Mesh`` of 4 forced host devices, its params placed by
``param_shardings`` (``tests/_torch_jax_serve_adaptive.py``, a subprocess
a job), against the port in a spawned ``gloo`` world of 4 ranks
(``tests/_torch_serve_tp_ranks.py``), each rank holding its blocks of JAX's
params (``serve_params``) and its own controller.

Reduced configs at 2 layers, f32, JAX's default layout (``fsdp``,
``seq_shard``, ``ep``), a drift hook at step 3 of 12 tokens, and a
controller at drift threshold 0.01, where scalar and tile re-tunes fire:

* ``qwen2_22``: (2, 2), ``kernel``, a batch of 6 split over ``"data"``, in
  tile mode at 3 row tiles of 2 rows: the middle tile straddles the two
  batch shards ([0, 3) and [3, 6));
* ``ds_22``: deepseek-moe (2, 2), ``mxu``, the experts over ``"model"``;
* ``rg_14``: recurrentgemma (1, 4), ``kernel``, its RG-LRU state gathered,
  and the fused adaptive serve in tile mode;
* ``bat_22``: qwen2 (2, 2), ``mxu``, the continuous batcher's drains (two
  slots on each batch shard).

Bound: the tokens, every record the controller observed (field by field,
shapes included), each re-tune's step, target and configs and each tile
re-tune's step, target and grid, and the final policy JSON are equal to
JAX's; the re-tunes' scores within ``SCORE_RTOL`` (the port's exact integer
means against JAX's f32 means, as ``tests/test_torch_adaptive.py``);
teacher-forced decode logits under a fixed tile grid within ``TOL`` of the
largest, their records equal.  (JAX's GSPMD drift serve equals its
one-device serve on reduced qwen2; the one-device runs are not repeated
here.)  Beside them: the fused adaptive serve, the batcher's token drains,
its wave drains against JAX's stepwise loop on one device, the
token-granular calls against one process, the drift hook on blocks that
start at odd rows against JAX's hook, a row tile that straddles two ranks'
rows in the matmul alone, and one projection of a batch split over two
ranks against the whole batch, records included.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_tp_ranks as RK
from repro.launch.serve import _drift_hook as j_drift_hook
from repro_torch.configs.base import AxPolicy
from repro_torch.launch.mesh import spawn
from repro_torch.quant.ax import _kernel_grid_tiled, ax_matmul_int_dyn
from repro_torch.core import multipliers as M
from repro_torch.kernels.schedule import KernelSchedule

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
TOL_FLIP = 5e-2
SCORE_RTOL = 1e-6


def _par(**kw):
    return dict(dict(fsdp=False, seq_shard=False, ep=False, remat="none"), **kw)


DEFAULT = _par(fsdp=True, seq_shard=True, ep=True)
CTRL = dict(min_observe_steps=2, cooldown_steps=2, drift_threshold=0.01)
JOBS = [
    {"label": "qwen2_22", "arch": "qwen2-72b", "shape": [2, 2], "cfg": {"ax": "kernel"},
     "B": 6, "modes": [0, 3], "teacher": 2},
    {"label": "ds_22", "arch": "deepseek-moe-16b", "shape": [2, 2], "cfg": {"ax": "mxu"},
     "B": 4, "modes": [0, 2]},
    {"label": "rg_14", "arch": "recurrentgemma-2b", "shape": [1, 4], "cfg": {"ax": "kernel"},
     "B": 4, "modes": [0, 2], "fused": [2]},
    {"label": "bat_22", "arch": "qwen2-72b", "shape": [2, 2], "cfg": {"ax": "mxu"},
     "B": 4, "modes": [0], "batcher": {"slots": 4, "buckets": [8, 16], "new": 7, "n": 8}},
]
for _j in JOBS:
    _j.update(axes=["data", "model"], par=DEFAULT, ctrl=CTRL, S=16, L=32, new=12,
              drift=[3, 0.05])
GEN = [(j["label"], t) for j in JOBS if "batcher" not in j for t in j["modes"]]
# token_step / prefill_one against one process: 4 slots, the cache 24 long
TOKEN = [dict(label=f"token_{a}{b}", arch="qwen2-72b", shape=[a, b], axes=["data", "model"],
              par=DEFAULT, cfg={"ax": "kernel"}, ctrl=CTRL, tile_rows=3, B=4, S=8, L=24,
              steps=3) for a, b in ((2, 2), (1, 4))]
# the drift hook: ff 20 over 4 model ranks, blocks of 5 rows starting at 0, 5, 10, 15
DRIFT = dict(arch="qwen2-72b", shape=[1, 4], axes=["data", "model"], par=DEFAULT,
             cfg={"d_ff": 20}, scale=0.05)


def _start_jax(jobs, tmp, name):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    log = os.path.join(tmp, name)
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                     "_torch_jax_serve_adaptive.py"),
                                 os.path.join(tmp, "jax"), json.dumps(jobs)], env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    return proc, log


@pytest.fixture(scope="module")
def runs():
    """JAX's runs in a subprocess a job while a 4-rank world runs the
    token-granular and drift-hook checks, then the port's jobs as their
    inputs appear."""
    tmp = tempfile.mkdtemp(prefix="serve_tp_adapt_")
    jobs = [dict(j, dir=os.path.join(tmp, "jax", j["label"])) for j in JOBS]
    procs = [_start_jax([job], tmp, f"jax{i}.log") for i, job in enumerate(jobs)]
    try:
        four = spawn(RK.jobs_rank, 4, args=([("token_rank", (TOKEN[0],)),
                                             ("token_rank", (TOKEN[1],)),
                                             ("drift_rank", (DRIFT,)),
                                             ("adapt_rank", (jobs[:3],)),
                                             ("batcher_rank", (jobs[3],))],),
                     device="cpu", timeout_s=RK.TIMEOUT, threads=1)
        for proc, log in procs:
            assert proc.wait(timeout=RK.TIMEOUT) == 0, open(log).read()[-3000:]
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
    return dict(jax={j["label"]: j["dir"] for j in jobs}, adapt=[r[3] for r in four],
                batcher=[r[4] for r in four], token=[[r[0] for r in four], [r[1] for r in four]],
                drift=[r[2] for r in four])


def _jax_run(d, name):
    """A JAX run's tokens, records (one dict per observed step) and events."""
    z = np.load(os.path.join(d, f"{name}.npz"))
    with open(os.path.join(d, f"{name}.json")) as f:
        ev = json.load(f)
    records = [{} for _ in range(ev["n_records"])]
    for key in z.files:
        if key != "tokens":
            i, t, k = key.split("|")
            records[int(i)].setdefault(t, {})[k] = z[key]
    return dict(ev, tokens=z["tokens"], records=records)


def _same_records(port, ref, what):
    assert len(port) == len(ref), (what, len(port), len(ref))
    for i, (p, r) in enumerate(zip(port, ref)):
        assert set(p) == set(r), (what, i, sorted(p), sorted(r))
        for t in r:
            assert set(p[t]) == set(r[t]), (what, i, t)
            for k, v in r[t].items():
                pv = np.asarray(p[t][k])
                assert pv.shape == v.shape, (what, i, t, k, pv.shape, v.shape)
                assert pv.dtype == v.dtype, (what, i, t, k, pv.dtype, v.dtype)
                assert np.array_equal(pv, v), (what, i, t, k)


def _same_events(port, ref, what):
    assert [e[:4] for e in port["retunes"]] == [e[:4] for e in ref["retunes"]], \
        (what, port["retunes"], ref["retunes"])
    for a, b in zip(port["retunes"], ref["retunes"]):
        assert a[4] == pytest.approx(b[4], rel=SCORE_RTOL)
        assert a[5] == pytest.approx(b[5], rel=SCORE_RTOL)
    assert [e[:3] for e in port["tile_retunes"]] == [e[:3] for e in ref["tile_retunes"]], \
        (what, port["tile_retunes"], ref["tile_retunes"])
    for a, b in zip(port["tile_retunes"], ref["tile_retunes"]):
        assert a[3] == pytest.approx(b[3], rel=SCORE_RTOL)
    assert port["policy"] == ref["policy"], what


def _same_layout(port, ref, what):
    """The records' steps, targets, fields, shapes and dtypes, and their
    sample counts (``n``, ``tile_n``), equal."""
    assert len(port) == len(ref), (what, len(port), len(ref))
    for i, (p, r) in enumerate(zip(port, ref)):
        assert set(p) == set(r), (what, i)
        for t in r:
            assert set(p[t]) == set(r[t]), (what, i, t)
            for k, v in r[t].items():
                pv = np.asarray(p[t][k])
                assert (pv.shape, pv.dtype) == (v.shape, v.dtype), (what, i, t, k)
                if k in ("n", "tile_n"):
                    assert np.array_equal(pv, v), (what, i, t, k)


def _agreed(ranks, key, records=True):
    """Every rank's run ``key`` is the same: tokens, events and (with
    ``records``) the records."""
    first = ranks[0][key]
    for r in ranks[1:]:
        assert np.array_equal(r[key]["tokens"], first["tokens"])
        if records:
            _same_records(r[key]["records"], first["records"], key)
        _same_events(r[key], first, key)
    return first


def _label(label, tr):
    return f"{label}-{'tiles' if tr else 'scalar'}"


@pytest.mark.parametrize("label,tr", GEN, ids=[_label(*g) for g in GEN])
def test_adaptive_generate_equals_jax_gspmd(runs, label, tr):
    """The drift serve (stepwise, a hook at step 3) on every rank: the
    global tokens, every observed record, the re-tunes and the policy JSON
    equal JAX's GSPMD serve, and every rank agrees."""
    port = _agreed([r[label] for r in runs["adapt"]], f"gen{tr}")
    ref = _jax_run(runs["jax"][label], f"gen{tr}")
    assert np.array_equal(port["tokens"], ref["tokens"]), (port["tokens"], ref["tokens"])
    _same_records(port["records"], ref["records"], label)
    _same_events(port, ref, label)
    assert port["retunes"], "the drift re-tunes"


def test_tile_retunes_fire(runs):
    """Tile re-tunes fire in tile mode (the comparisons above then cover
    them): {label: count}."""
    fired = {label: len(runs["adapt"][0][label][f"gen{tr}"]["tile_retunes"])
             for label, tr in GEN if tr}
    print(fired)
    assert fired["qwen2_22"] and fired["ds_22"], fired


def test_fused_adaptive_serve_equals_jax_gspmd(runs):
    """Three fused adaptive generations of recurrentgemma in tile mode with
    one controller (no hook; the drift lands after the first): the tokens,
    the re-tunes and the policy equal JAX's GSPMD serves, and every rank
    agrees.  The records keep their layout (steps, targets, fields, shapes,
    dtypes and counts) but are not held bit for bit: the port's split
    decode attention combines its f32 partial sums in another order than
    one device, and JAX's GSPMD run rounds apart from its one-device run
    too (on deepseek's fused tile serve an ``attn_out`` code of the third
    generation flipped in each, in a run of this test's jobs beside JAX's
    one-device serve; ROADMAP queue 3).  The drift serves above hold every record."""
    port = _agreed([r["rg_14"] for r in runs["adapt"]], "fused2")
    ref = _jax_run(runs["jax"]["rg_14"], "fused2")
    assert np.array_equal(port["tokens"], ref["tokens"])
    _same_events(port, ref, "fused")
    _same_layout(port["records"], ref["records"], "fused")
    assert port["retunes"]


def _job(label):
    return next(j for j in JOBS if j["label"] == label)


def _one(runs, label, name):
    """The port's one-process run ``name`` of a job, from the rank that ran
    it."""
    return next(r[label]["one"][name] for r in runs["adapt"]
                if name in r[label].get("one", {}))


@pytest.mark.parametrize("label", [j["label"] for j in JOBS if j.get("teacher")])
def test_teacher_forced_logits_and_records_equal_jax(runs, label):
    """The prefill and two decode steps under a fixed dynamic policy (a
    3-tile grid for qwen2_22, whose middle tile straddles the batch
    shards): the global logits from the ranks' rows within ``TOL`` of
    JAX's, each step's records equal.  Where the port's one-process run
    itself sits an int8 code away from JAX's (``tests/test_torch_serve_tp.py``
    states why), the sharded logits are held to that run within ``TOL``
    and it to JAX's within ``TOL_FLIP``."""
    job = _job(label)
    ref = np.load(os.path.join(runs["jax"][label], "teacher.npz"))
    ranks = [r[label]["teacher"] for r in runs["adapt"]]
    for i in range(job["teacher"] + 1):
        whole = np.full(ref[f"l{i}"].shape, np.nan, np.float32)
        for r in ranks:
            lo, hi = r["rows"]
            whole[lo:hi] = r["logits"][i]
        want, one = ref[f"l{i}"], _one(runs, label, "teacher")["logits"][i]
        if _gap(one, want) > TOL:
            assert _gap(one, want) <= TOL_FLIP, (i, _gap(one, want))
            want = one
        assert _gap(whole, want) <= TOL, (i, _gap(whole, want))
    refs = [{} for _ in range(job["teacher"])]
    for key in ref.files:
        if "|" in key:
            i, t, k = key.split("|")
            refs[int(i)].setdefault(t, {})[k] = ref[key]
    for r in ranks:
        port = [{t: {k: _host(k, v) for k, v in rec.items()} for t, rec in step.items()}
                for step in r["records"]]
        _same_records(port, refs, label)


def _gap(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _host(field, v):
    """A device record's field with the JAX package's host type."""
    from repro_torch.runtime.telemetry import records_to_host

    return records_to_host({"t": {field: torch.from_numpy(np.asarray(v))}})["t"][field]


def _unversioned(policy_json):
    doc = json.loads(policy_json)
    doc.pop("version")
    return doc


def test_token_mode_batcher_equals_jax_gspmd(runs):
    """Two token-mode drains of 8 requests on 4 slots (2 on each batch
    shard) with one controller, the second of the drifted weights: each
    request's tokens, the re-tunes, the policy and the observed steps equal
    JAX's GSPMD batcher; every rank agrees on the tokens, the clock and the
    decisions; only rank 0 holds the store, which the re-tunes advanced.
    The records are not held bit for bit here (the fused serve's note: the
    split decode attention rounds apart, and an ``attn_out`` code of the
    first drain flips)."""
    with open(os.path.join(runs["jax"]["bat_22"], "batcher.json")) as f:
        ref = json.load(f)
    ranks = runs["batcher"]
    assert ref["retunes"] and len(ref["tokens"]) == 16
    for r in ranks:
        assert r["tokens"] == ref["tokens"], (r["tokens"], ref["tokens"])
        assert [e[:4] for e in r["retunes"]] == [e[:4] for e in ref["retunes"]]
        # rank 0's store rewrites the policy's version (module note of fleet.store)
        assert _unversioned(r["policy"]) == _unversioned(ref["policy"])
        assert r["steps"] == ref["steps"]
        assert r["clock"] == ranks[0]["clock"] and len(r["clock"]) >= 16
    assert [r["rows"] for r in ranks] == [[0, 2], [0, 2], [2, 2], [2, 2]]
    assert ranks[0]["versions"] == 1 + len(ranks[0]["retunes"])
    assert all(r["versions"] is None for r in ranks[1:])


def test_wave_mode_batcher_equals_one_process(runs):
    """A wave-mode drain of the same 8 requests on 4 slots (each wave one
    fused adaptive ``generate(par=)``, eager, with per-slot budgets): on
    every rank each request's tokens and wave, the re-tunes, the policy and
    the observed steps equal the port's drain of the whole weights on one
    process, and those equal JAX's drain on one device with each wave on
    its stepwise loop.  JAX's fused waves (its batcher's own, GSPMD and one
    device alike) depart from that loop: its fused scan folds the steps
    after a wave's largest budget into the controller as zero records,
    which its stepwise loop never surfaces (ROADMAP queue 3), so it
    observes more steps and re-tunes on the zeros; the port's fused path
    observes the live steps only.  The first wave, before any re-tune,
    gives the same tokens on every path."""
    with open(os.path.join(runs["jax"]["bat_22"], "wave.json")) as f:
        gspmd = json.load(f)
    with open(os.path.join(runs["jax"]["bat_22"], "wave_one.json")) as f:
        jax_one = json.load(f)
    ref = jax_one["stepwise"]
    one = runs["batcher"][0]["wave_one"]
    for r in runs["batcher"]:
        w = r["wave"]
        assert w["tokens"] == one["tokens"] and w["waves"] == one["waves"]
        assert [e[:4] for e in w["retunes"]] == [e[:4] for e in one["retunes"]]
        assert w["policy"] == one["policy"] and w["steps"] == one["steps"]
    assert one["tokens"] == ref["tokens"] and one["waves"] == ref["waves"]
    assert [e[:4] for e in one["retunes"]] == [e[:4] for e in ref["retunes"]]
    assert json.loads(one["policy"]) == json.loads(ref["policy"])
    assert one["steps"] == ref["steps"]
    # the stated difference: JAX's fused waves observe the zero records
    fused = jax_one["fused"]
    assert fused["tokens"] == gspmd["tokens"] and fused["steps"] == gspmd["steps"]
    assert fused["steps"] > ref["steps"] and fused["retunes"] and fused["tokens"] != ref["tokens"]
    first = [rid for rid, wave in ref["waves"].items() if wave == 0]
    assert first and all(fused["tokens"][rid] == ref["tokens"][rid] for rid in first)


@pytest.mark.parametrize("case", [0, 1], ids=[t["label"] for t in TOKEN])
def test_token_step_and_prefill_one_equal_one_rank(runs, case):
    """``prefill_one(par=, rows=4)`` of two requests, ``splice_slot`` into
    the rank's block and three observed ``token_step(par=, adaptive=)`` in
    tile mode: the first tokens, each step's tokens and records equal the
    same calls on one process, and the rank's cache block is within ``TOL``
    of its block there (a column-parallel f32 GEMM rounds apart from the
    whole one in the last bit)."""
    ranks = runs["token"][case]
    for r in ranks:
        assert r["sharded"]["firsts"] == r["one"]["firsts"]
        for (tok, rec), (tok1, rec1) in zip(r["sharded"]["steps"], r["one"]["steps"]):
            assert np.array_equal(tok, tok1)
            _same_records([rec], [rec1], "token_step")
        for path, blk in r["sharded"]["cache"].items():
            idx = tuple(slice(a, b) for a, b in r["index"][path])
            assert _gap(blk, r["one"]["cache"][path][idx]) <= TOL, path


def test_drift_hook_on_odd_offset_blocks_equals_jax(runs):
    """The hook on the rank's blocks (``ff`` blocks of 5 rows starting at
    0, 5, 10 and 15) equals the blocks of JAX's ``_drift_hook`` applied to
    the whole weights; on whole weights under the mesh it refuses."""
    cfg = RK.config(DRIFT["arch"], DRIFT["cfg"])
    whole = RK.init_params(cfg, seed=0, device="cpu")
    from repro_torch.launch.mesh import tree_paths

    paths, leaves = tree_paths(whole)
    want = j_drift_hook(0, DRIFT["scale"])(0, {p: jnp.asarray(v.numpy()) for p, v in
                                                zip(paths, leaves)})
    odd = 0
    for r in runs["drift"]:
        assert "serve_params" in r["refused"]
        for p, (idx, blk) in r["blocks"].items():
            sl = tuple(slice(a, b) for a, b in idx)
            assert np.array_equal(blk, np.asarray(want[p])[sl]), p
            odd += len(idx) >= 2 and idx[-2][0] % 2 == 1
    assert odd >= 2


@pytest.mark.parametrize("backend", ["kernel", "emul", "mxu"])
def test_row_tile_straddling_two_rank_blocks(backend):
    """A (3, 1, 3) grid over 10 rows (tiles of 3, 3 and 4 rows) applied to
    the rows [0, 5) and [5, 10) apart (``row_span``), as two batch shards
    do: the middle tile takes its triple on both sides, and the two
    products equal the product of the whole; with the kernel's tile
    histogram the two shards' counts add up to the whole's."""
    mult = M.get(_mult_for(backend))
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-127, 128, (10, 48)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (48, 24)).astype(np.int8))
    grid = torch.tensor([[[1, 2, 0]], [[1, 5, 1]], [[1, 3, 1]]], dtype=torch.int32)
    pol = AxPolicy(mult_name=_mult_for(backend), backend=backend)
    whole = ax_matmul_int_dyn(a, b, pol, grid)
    parts = [ax_matmul_int_dyn(a[lo:hi], b, pol, grid, row_span=(lo, 10))
             for lo, hi in ((0, 5), (5, 10))]
    assert torch.equal(torch.cat(parts), whole)
    if backend == "kernel":
        sched = KernelSchedule(bm=128, bn=128, bk=128)
        _, want = _kernel_grid_tiled(a, b, mult, grid, sched, tile_hist=True)
        got = [_kernel_grid_tiled(a[lo:hi], b, mult, grid, sched, tile_hist=True,
                                  row_span=(lo, 10))[1] for lo, hi in ((0, 5), (5, 10))]
        for w, x, y in zip(want, *got):
            assert torch.equal(x + y, w)


@pytest.fixture(scope="module")
def row_split():
    """``RK.row_split_rank`` of every ``RK.ROW_SPLIT`` case on two ``gloo``
    ranks: each rank's results in rank order."""
    return spawn(RK.row_split_rank, 2, args=(RK.ROW_SPLIT,), device="cpu", backend="gloo",
                 timeout_s=RK.TIMEOUT)


@pytest.mark.parametrize("case", range(len(RK.ROW_SPLIT)), ids=[c[0] for c in RK.ROW_SPLIT])
def test_projection_of_a_batch_split_equals_the_whole_batch(row_split, case):
    """``ax_dense_dyn(rows=)`` on two ``gloo`` ranks, each its half of the
    batch, in an observed tile-mode scope (the kernel's tile histogram with
    ``kernel``): each rank's outputs equal its rows of the whole batch's,
    and its records (the sampled rows gathered over the ranks, the
    histogram's counts summed) equal the whole batch's, field by field."""
    for r in row_split:
        got = r[case]
        assert got["rows"] and got["records"], got
        assert got["targets"] == ["attn_qkv", "attn_qkv@tiles"], got


def _mult_for(backend):
    """A multiplier each backend takes (``mxu`` needs a separable one)."""
    return "mul8s_drum3_4" if backend != "mxu" else "mul8s_trunc0_4"
