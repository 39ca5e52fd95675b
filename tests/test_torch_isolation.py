"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro`` (importing every
module, serving a tiny model static and adaptive, tiny models of the
local/global, MoE, RG-LRU, SSD and M-RoPE families and of whisper, a canaried
writer serve over a policy store with an SLO engine, a trace recorder and a
replica, a continuous-batcher drain, the telemetry aggregation, the serve
CLI, a train step with a checkpoint, the train CLI, the schedule autotuner's
CLI with a store, a reader and ``resolve``, the serve CLI's
``--autotune``, its ``--fleet 2`` over spawned ranks, a one-rank fleet mesh
with a mesh-sharded serve and batcher, the sharded train step on a
one-rank train mesh, the rank-local weights (``init_serve_params`` on that
mesh, a serve of ``init_blocks``), the spec trees of the multi-pod mesh, and a dry-run
cell of the model-sharded decode step on a fake world with its op tables
load neither; the examples are held so in
``tests/test_torch_examples.py``), and
``chip_smoke.py`` refuses to run without a CUDA device or outside a
checkout."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
sys.path.insert(0, {root!r})
import chip_smoke  # noqa: F401
import dataclasses, torch
from repro_torch.configs import qwen2_72b, reduced
from repro_torch.configs.base import AxPolicy
from repro_torch.models import init_params
from repro_torch.serve import ServeConfig, generate
cfg = dataclasses.replace(reduced(qwen2_72b), n_layers=1, ax=AxPolicy(backend="kernel"))
p = init_params(cfg, seed=0, device="cpu")
toks = generate(p, {{"tokens": torch.zeros((1, 4), dtype=torch.int64)}}, cfg,
                ServeConfig(max_new_tokens=2))
from repro_torch.launch.serve import drift_hook
from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy
ctrl = AdaptiveController(SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                          AdaptiveConfig(tile_rows=2), device="cpu")
adaptive = generate(p, {{"tokens": torch.zeros((2, 4), dtype=torch.int64)}}, cfg,
                    ServeConfig(max_new_tokens=3), adaptive=ctrl,
                    param_hook=drift_hook(1, 0.05))
from repro_torch.configs import ARCHS
families = {{}}
for n in ("gemma3-27b", "deepseek-moe-16b", "recurrentgemma-2b", "mamba2-370m",
          "qwen2-vl-72b"):
    c = dataclasses.replace(reduced(ARCHS[n]), n_layers=3, ax=AxPolicy(backend="kernel"))
    pp = init_params(c, seed=0, device="cpu")
    families[n] = list(generate(pp, {{"tokens": torch.zeros((1, 4), dtype=torch.int64)}}, c,
                                ServeConfig(max_new_tokens=2)).shape)
wc = dataclasses.replace(reduced(ARCHS["whisper-base"]), n_layers=1, n_enc_layers=1,
                         ax=AxPolicy(backend="kernel"))
wp = init_params(wc, seed=0, device="cpu")
families["whisper-base"] = list(generate(
    wp, {{"frames": torch.zeros((1, 6, wc.d_model)), "tokens": torch.zeros((1, 4), dtype=torch.int64)}},
    wc, ServeConfig(max_new_tokens=2)).shape)
import tempfile
from repro_torch import train
with tempfile.TemporaryDirectory() as root:
    opt = train.AdamWConfig()
    state = train.fresh_train_state(cfg, opt, device="cpu")
    state, m = train.make_train_step(cfg, None, opt)(
        state, train.SyntheticStream(train.DataConfig(cfg.vocab, 8, 2)).next())
    train.save(root, 1, state)
    state, _ = train.restore(root, 1, state, device="cpu")
    from repro_torch.launch.train import main as train_main
    _, tlog, _ = train_main(["--device", "cpu", "--smoke", "--steps", "1", "--batch", "2",
                             "--seq", "8", "--ckpt-dir", root + "/cli"])
    trained = [int(state["opt"]["step"]), tlog["steps_run"]]
from repro_torch import obs
from repro_torch.fleet import PolicyReader, PolicyStore
with tempfile.TemporaryDirectory() as root:
    store = PolicyStore(root)
    writer = AdaptiveController(SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                                AdaptiveConfig(min_observe_steps=1, cooldown_steps=1,
                                               drift_threshold=0.0, canary=True),
                                store=store, device="cpu")
    writer.resume_from_store()
    writer.attach_slo(obs.SLOEngine(obs.default_serving_slos(qor_targets=cfg.ax.targets),
                                    audit=writer.audit))
    obs.install_recorder(obs.TraceRecorder())
    generate(p, {{"tokens": torch.zeros((2, 4), dtype=torch.int64)}}, cfg,
             ServeConfig(max_new_tokens=4), adaptive=writer, param_hook=drift_hook(1, 0.05))
    replica = PolicyReader(store, cfg.ax.targets, device="cpu")
    generate(p, {{"tokens": torch.zeros((2, 4), dtype=torch.int64)}}, cfg,
             ServeConfig(max_new_tokens=3), adaptive=replica)
    kinds = sorted({{e["kind"] for e in writer.audit.read()}})
    text = obs.prometheus_text()
    import numpy as np
    from repro_torch.fleet import (BatcherConfig, ContinuousBatcher, Request,
                                   combine_shards, make_sharded_summarizer)
    from repro_torch.launch.serve import main
    from repro_torch.train import StragglerWatchdog
    bat = ContinuousBatcher(p, cfg, BatcherConfig(n_slots=2, prompt_buckets=(8,),
                                                  new_token_bucket=3, token_granular=True),
                            adaptive=replica)
    for rid in range(3):
        bat.submit(Request(rid, np.arange(1, 4 + rid), max_new=3))
    served = len(bat.run())
    summ = make_sharded_summarizer("mul8s_trunc0_4")
    rec = summ(torch.ones((2, 8), dtype=torch.int8), torch.ones((8, 4), dtype=torch.int8),
               torch.tensor([1, 3, 0], dtype=torch.int32))
    combine_shards([{{"s": rec}}, {{"s": rec}}])
    StragglerWatchdog().observe(0.1)
    cli, _ = main(["--device", "cpu", "--smoke", "--fleet", "1", "--token-granular",
                   "--requests", "2", "--prompt-len", "8", "--new-tokens", "3",
                   "--policy-store", root + "/cli"])
    fleet2, _ = main(["--device", "cpu", "--smoke", "--fleet", "2", "--token-granular",
                      "--requests", "2", "--prompt-len", "8", "--new-tokens", "3",
                      "--policy-store", root + "/cli2"])
    import torch.distributed as dist
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.mesh import make_fleet_mesh, param_shardings, production_mesh_shape
    mesh = make_fleet_mesh(1, device="cpu")
    mctrl = AdaptiveController(SwapPolicy.from_ax_policy(cfg.ax), cfg.ax.targets,
                               AdaptiveConfig(tile_rows=2), device="cpu")
    meshed = generate(p, {{"tokens": torch.zeros((2, 4), dtype=torch.int64)}}, cfg,
                      ServeConfig(max_new_tokens=3), adaptive=mctrl, mesh=mesh)
    mbat = ContinuousBatcher(p, cfg, BatcherConfig(n_slots=2, prompt_buckets=(8,),
                                                   new_token_bucket=3, token_granular=True),
                             adaptive=mctrl, mesh=mesh)
    for rid in range(3):
        mbat.submit(Request(rid, np.arange(1, 4 + rid), max_new=3))
    mesh_served = len(mbat.run())
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import distributed as TD
    tmesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    tpar = ParallelConfig(dp_only=True, fsdp=True, ep=True, remat="none")
    topt = train.AdamWConfig()
    tspecs = TD.state_specs(cfg, topt, tmesh, tpar)
    tstate = TD.local_state(train.fresh_train_state(cfg, topt, device="cpu"), tspecs, tmesh)
    tstate, _ = train.make_train_step(cfg, tpar, topt, mesh=tmesh)(
        tstate, train.SyntheticStream(train.DataConfig(cfg.vocab, 8, 2)).next())
    mesh_trained = int(train.gather_state(tstate, tspecs, tmesh)["opt"]["step"])
    from repro_torch.launch.parallel import init_serve_params
    from repro_torch.models import init_blocks
    iparams = init_serve_params(cfg, tmesh, ParallelConfig(fsdp=True, seq_shard=True, ep=True),
                                device="cpu")
    init = [len(iparams["layers"]), list(generate(
        init_blocks(cfg, device="cpu"), {{"tokens": torch.zeros((1, 4), dtype=torch.int64)}}, cfg,
        ServeConfig(max_new_tokens=2)).shape)]
    dist.destroy_process_group()
    specs = param_shardings(production_mesh_shape(multi_pod=True), ParallelConfig(),
                            init_params(ARCHS["qwen2-72b"], device="meta"))
    import io
    from repro_torch.launch import dryrun, hlo_analyze
    from repro_torch.launch.sharding import MeshShape
    drow = dryrun.run_cell("qwen2-72b", "decode_32k", False,
                           ParallelConfig(seq_shard=True, ep=True, remat="none"),
                           verbose=False, mesh=MeshShape(("data", "model"), (1, 2)),
                           cfg_patch=dict(n_layers=2, d_model=256, d_ff=512, n_heads=4,
                                          n_kv_heads=2, head_dim=64, vocab=1024),
                           keep_recorder=True)
    tables = io.StringIO()
    hlo_analyze.report(drow["recorder"], 3, out=tables)
    dry = [drow["status"], drow["mesh"], "largest individual ops" in tables.getvalue()]
from repro_torch.kernels import autotune as TA, clear_table, resolve
with tempfile.TemporaryDirectory() as root:
    TA.main(["--device", "cpu", "--quick", "--shapes", "4x64x48", "--store", root])
    sched_reader = TA.ScheduleReader(TA.ScheduleStore(root))
    sched = resolve(4, 64, 48, "mxu", "mul8s_trunc0_4", "int_dyn")
    tuned, _ = main(["--device", "cpu", "--smoke", "--ax", "--autotune", "--batch", "1",
                     "--prompt-len", "4", "--new-tokens", "2",
                     "--schedule-store", root + "/serve"])
    clear_table()
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m == "repro" or m.startswith("repro."))
print(json.dumps({{"modules": len(names), "bad": bad, "shape": list(toks.shape),
                  "adaptive": list(adaptive.shape), "observed": ctrl.step,
                  "retunes": len(writer.retunes), "audit": kinds,
                  "replica": replica.version, "metrics": "repro_canary_total" in text,
                  "served": served, "cli": cli.stats["requests"],
                  "mesh": [list(meshed.shape), mesh_served, fleet2["stats"]["requests"],
                           list(specs["embed"]["w"]), mesh_trained],
                  "families": families, "trained": trained, "dry": dry, "init": init,
                  "autotune": [sched_reader.version, sched.backend, list(tuned.shape)]}}))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    env.update(extra)
    return env


def test_importing_and_running_the_port_loads_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    assert res["modules"] >= 22 and res["shape"] == [1, 2]
    assert res["adaptive"] == [2, 3] and res["observed"] == 2
    assert res["retunes"] >= 1 and "retune" in res["audit"] and res["replica"] >= 1
    assert res["metrics"] and res["served"] == 3 and res["cli"] == 2
    assert res["families"] == {n: [1, 2] for n in ("gemma3-27b", "deepseek-moe-16b",
                                                   "recurrentgemma-2b", "mamba2-370m",
                                                   "qwen2-vl-72b", "whisper-base")}
    assert res["trained"] == [1, 1]
    assert res["mesh"] == [[2, 3], 3, 2, ["model", None], 1]
    assert res["autotune"] == [1, "mxu", [1, 2]]
    assert res["dry"] == ["ok", "1x2", True]
    assert res["init"] == [1, [1, 2]]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_import_statement_names_jax_or_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) >= 15
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, (f, roots)


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, env=_env(CUDA_VISIBLE_DEVICES=""), cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _entry_points():
    import repro_torch.apps.common as apps
    import repro_torch.convert as convert
    import repro_torch.core.multipliers as mults
    import repro_torch.core.tuning as tuning
    import repro_torch.kernels.autotune as autotune
    import repro_torch.kernels.ops as ops
    import repro_torch.launch.mesh as launch_mesh
    import repro_torch.launch.parallel as parallel
    import repro_torch.launch.serve as launch_serve
    import repro_torch.launch.train as launch_train
    import repro_torch.models as models
    import repro_torch.models.whisper as whisper
    import repro_torch.train.checkpoint as checkpoint
    import repro_torch.train.train_step as train_step
    from repro_torch import obs
    from repro_torch.fleet import PolicyReader
    from repro_torch.runtime import AdaptiveController, SwapPolicy

    return {"init_params": models.init_params, "init_cache": models.init_cache,
            "init_blocks": models.init_blocks,
            "registry.deferred_params": models.registry.deferred_params,
            "parallel.init_serve_params": parallel.init_serve_params,
            "serve_params_from_jax": convert.serve_params_from_jax,
            "whisper.init_params": whisper.init_params,
            "whisper.init_cache": whisper.init_cache,
            "train_step.fresh_train_state": train_step.fresh_train_state,
            "checkpoint.restore": checkpoint.restore,
            "launch.train": launch_train._parser(),
            "launch.serve": launch_serve._parser(),
            "mesh.make_fleet_mesh": launch_mesh.make_fleet_mesh,
            "mesh.make_production_mesh": launch_mesh.make_production_mesh,
            "mesh.spawn": launch_mesh.spawn,
            "kernels.autotune": autotune._parser(),
            "autotune.tune_table": autotune.tune_table,
            "autotune.tune_signature": autotune.tune_signature,
            "params_from_jax": convert.params_from_jax,
            "cache_from_jax": convert.cache_from_jax,
            "train_state_from_jax": convert.train_state_from_jax,
            "AdaptiveController": AdaptiveController.__init__,
            "PolicyReader": PolicyReader.__init__, "SwapPolicy.dyn_tree": SwapPolicy.dyn_tree,
            "device_trace": obs.trace.device_trace.__wrapped__,
            "component_sweep": tuning.component_sweep, "two_bit_sweep": tuning.two_bit_sweep,
            "tune_application": tuning.tune_application,
            "component_sweep_kernel": ops.component_sweep_kernel,
            "tune_app": apps.tune_app, "evaluate": apps.evaluate,
            "is_commutative": mults.is_commutative}


@pytest.mark.parametrize("module", ["dryrun", "hlo_analyze"])
def test_the_dry_run_tools_take_no_device(module):
    """The analysis CLIs run a cell on fake tensors over a fake world: they
    allocate nothing, touch no device and take no ``--device``."""
    import importlib

    parser = importlib.import_module(f"repro_torch.launch.{module}")._parser()
    args = parser.parse_args(["--arch", "qwen2-72b", "--shape", "decode_32k"])
    assert not hasattr(args, "device")


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """Every entry point that holds tensors runs on ``cuda`` unless the
    caller passes ``device="cpu"`` (a CLI: ``--device cpu``)."""
    import argparse
    import inspect

    entry = _entry_points()[name]
    if isinstance(entry, argparse.ArgumentParser):
        assert entry.parse_args([]).device == "cuda", name
        return
    sig = inspect.signature(entry)
    assert sig.parameters["device"].default == "cuda", name
