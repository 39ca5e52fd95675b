"""The port's analysis tools (``launch/roofline.py``, ``launch/dryrun.py``,
``launch/hlo_analyze.py``, ``models/registry.py::input_specs``) against the
JAX package's.

* ``param_count``, ``model_flops`` and ``skip_reason`` equal JAX's for
  every ``ARCHS`` x ``SHAPES`` pair (pure Python).
* Four cells, the port's dry run (rank 0's step on a fake world of 8 ranks
  under ``FakeTensorMode``, ``tests/_torch_dryrun_cells.py``) against
  JAX's ``run_cell`` on a directly built ``Mesh`` of 8 forced host devices
  (``tests/_torch_jax_dryrun.py``), both subprocesses: a train cell and a
  ``decode_32k`` cell on (4, 2), a ``prefill_32k`` cell and a ``long_500k``
  cell of a ``LONG_CONTEXT_OK`` architecture on (2, 2, 2) with ``"pod"``.
  JAX runs with its default cost extrapolation: XLA's cost analysis counts
  a scanned layer's body once (JAX's own note), so its unextrapolated
  FLOPs are not a device's.  The port's row is ``ok`` where JAX's is, and
  its per-device FLOPs (``FlopCounterMode``: matmul-class FLOPs only) are
  at most ``FLOPS_ABOVE`` times JAX's (XLA also counts elementwise work);
  on the train, prefill and long-context cells, where GSPMD partitions the
  step as the port does, at least ``FLOPS_BELOW`` times JAX's.  On the
  decode cell of a full-attention model GSPMD all-gathers the
  sequence-sharded cache and attends over the whole of it on every device
  (its all-gather bytes show it), where the port combines partial softmax
  statistics (``layers.decode_attention_split``): there only the upper
  bound holds.  The useful ratio does not exceed 1 by more than JAX's
  does.  Peak memory is recorded, not compared.
* The port's 1- and 2-period cost extrapolation equals its full count
  (FLOPs, bytes, collectives) on reduced configs: the train step and a
  decode step of mamba2, a decode step of qwen2.
* The production meshes over fake worlds of 256 and 512 ranks, a group of
  two axes made under ``FakeTensorMode``; ``hlo_analyze`` prints its
  tables, and the dry-run CLI runs a cell, and one with ``--ax`` in a
  process that has built no multiplier table before.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

import repro.launch.roofline as JR
from repro.configs import ARCHS as J_ARCHS
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun, roofline

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
FLOPS_ABOVE, FLOPS_BELOW = 1.02, 0.9
CELLS = [["mamba2-370m", "train_4k", [4, 2]], ["qwen2-72b", "decode_32k", [4, 2]],
         ["mamba2-370m", "prefill_32k", [2, 2, 2]],
         ["recurrentgemma-2b", "long_500k", [2, 2, 2]]]
SAME_PARTITION = {"train_4k", "prefill_32k", "long_500k"}


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + [
                    p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))


def _start(args, log):
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable] + args, env=_env(), stdout=f,
                                stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs():
    """JAX's cells, the port's cells and checks, ``hlo_analyze`` and the
    CLI, four subprocesses at once."""
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    cells = json.dumps(CELLS)
    jobs = {
        "jax": [str(ROOT / "tests" / "_torch_jax_dryrun.py"), os.path.join(tmp, "jax.json"),
                cells],
        "port": [str(ROOT / "tests" / "_torch_dryrun_cells.py"),
                 os.path.join(tmp, "port.json"), cells],
        "hlo": ["-m", "repro_torch.launch.hlo_analyze", "--arch", "mamba2-370m", "--shape",
                "decode_32k", "--top", "5"],
        "cli": ["-m", "repro_torch.launch.dryrun", "--arch", "recurrentgemma-2b", "--shape",
                "decode_32k", "--out", os.path.join(tmp, "cli.jsonl")],
        "cli_ax": ["-m", "repro_torch.launch.dryrun", "--arch", "mamba2-370m", "--shape",
                   "decode_32k", "--ax", "--out", os.path.join(tmp, "cli_ax.jsonl")],
    }
    procs = {k: _start(a, os.path.join(tmp, f"{k}.log")) for k, a in jobs.items()}
    try:
        codes = {k: p.wait(timeout=TIMEOUT) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    logs = {k: open(os.path.join(tmp, f"{k}.log")).read() for k in jobs}
    for k in ("jax", "port"):
        assert codes[k] == 0, logs[k][-3000:]
    out = {k: json.load(open(os.path.join(tmp, f"{k}.json"))) for k in ("jax", "port")}
    cli = {k: [json.loads(x) for x in open(os.path.join(tmp, f"{k}.jsonl"))]
           if codes[k] == 0 else None for k in ("cli", "cli_ax")}
    return dict(out, codes=codes, logs=logs, **cli)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_and_model_flops_equal_jax(arch):
    """Every shape of the architecture: the analytic parameter count and the
    model FLOPs, equal to JAX's."""
    assert roofline.param_count(ARCHS[arch]) == JR.param_count(J_ARCHS[arch])
    for name, shape in SHAPES.items():
        assert roofline.model_flops(ARCHS[arch], shape) == JR.model_flops(J_ARCHS[arch], shape)


def test_skip_reason_equals_jax(runs):
    """The skip policy of every ``ARCHS`` x ``SHAPES`` pair."""
    want = runs["jax"]["skip"]
    assert len(want) == len(ARCHS) * len(SHAPES)
    for key, reason in want.items():
        assert dryrun.skip_reason(*key.split("/")) == reason, key


@pytest.mark.parametrize("cell", range(len(CELLS)))
def test_dryrun_cell_matches_jax(runs, cell):
    """``ok`` where JAX's row is ``ok``, JAX's row keys, the per-device FLOPs
    within the module note's bounds of JAX's, the useful ratio no further
    above 1 than JAX's; the peak recorded."""
    j, p = runs["jax"]["rows"][cell], runs["port"]["rows"][cell]
    arch, shape, _ = CELLS[cell]
    assert j["status"] == "ok" and p["status"] == "ok", (j.get("error"), p)
    assert set(j) - {"compile_s", "cost_compile_s"} <= set(p), set(j) - set(p)
    assert (p["arch"], p["shape"], p["mesh"], p["chips"]) == (
        j["arch"], j["shape"], j["mesh"], j["chips"])
    assert p["model_flops"] == j["model_flops"]
    ratio = p["hlo_flops_per_dev"] / j["hlo_flops_per_dev"]
    assert ratio <= FLOPS_ABOVE, ratio
    if shape in SAME_PARTITION:
        assert ratio >= FLOPS_BELOW, ratio
    assert p["useful_ratio"] <= max(1.0, j["useful_ratio"]), (p["useful_ratio"],
                                                              j["useful_ratio"])
    assert p["memory"]["memtracker_peak_bytes"] > 0 and p["peak_bytes_per_dev"] > 0
    assert p["cost_source"] == "extrapolated_1p2p"
    assert set(p["collectives"]) <= set(roofline.COLLECTIVES)


@pytest.mark.parametrize("key", ["qwen2-72b/decode_32k", "mamba2-370m/train_4k",
                                 "mamba2-370m/decode_32k"])
def test_extrapolation_equals_the_full_count(runs, key):
    """On a reduced config the 1- and 2-period extrapolation gives the full
    depth's FLOPs, bytes and collective bytes exactly (each layer's step is
    the same ops); the peak is not linear in the depth and not compared."""
    r = runs["port"]["extrapolation"][key]
    ex, full = r["extrapolated"], r["full"]
    assert (ex["cost_source"], full["cost_source"]) == ("extrapolated_1p2p", "full")
    for k in ("hlo_flops_per_dev", "bytes_per_dev", "collectives"):
        assert ex[k] == full[k], (k, ex[k], full[k])


def test_production_meshes_on_fake_worlds(runs):
    """(16, 16) and (2, 16, 16) over fake worlds of 256 and 512 ranks in one
    process; a group over the mesh's batch axes made under fake tensors."""
    m = runs["port"]["meshes"]
    assert m["256"] == dict(names=["data", "model"], shape=[16, 16], group=[0, 16])
    assert m["512"] == dict(names=["pod", "data", "model"], shape=[2, 16, 16], group=[0, 32])


def test_hlo_analyze_prints_its_tables(runs):
    """Per-op-kind totals, then the largest single ops (``--top 5``)."""
    assert runs["codes"]["hlo"] == 0, runs["logs"]["hlo"][-3000:]
    log = runs["logs"]["hlo"]
    assert "== per-op-kind totals (output bytes, count) ==" in log
    tail = log.split("== largest individual ops ==")[1].strip().splitlines()
    assert len(tail) == 5 and all(" GB " in line for line in tail), tail


def test_dryrun_cli_runs_a_cell(runs):
    """``python -m repro_torch.launch.dryrun --arch --shape --out``: one ``ok``
    row on the production mesh, extrapolated."""
    assert runs["codes"]["cli"] == 0, runs["logs"]["cli"][-3000:]
    assert "== dry-run: 1 ok, 0 skipped, 0 failed, 1 cells" in runs["logs"]["cli"]
    (row,) = runs["cli"]
    assert (row["status"], row["mesh"], row["chips"], row["cost_source"]) == (
        "ok", "16x16", 256, "extrapolated_1p2p")


def test_dryrun_cli_ax_on_a_cold_process(runs):
    """``--ax`` in a fresh process: the multiplier's tables are built from
    real values before the fake run (under ``FakeTensorMode`` they would be
    fakes), and the cell's row is ``ok`` with the multiplier named."""
    assert runs["codes"]["cli_ax"] == 0, runs["logs"]["cli_ax"][-3000:]
    (row,) = runs["cli_ax"]
    assert (row["status"], row["ax"], row["cost_source"]) == (
        "ok", "mul8s_trunc0_4", "extrapolated_1p2p")
    want = roofline.model_flops(ARCHS["mamba2-370m"], SHAPES["decode_32k"])
    assert row["model_flops"] == pytest.approx(want, rel=1e-12)
    assert row["memory"]["memtracker_peak_bytes"] > 0
