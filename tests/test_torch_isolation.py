"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro`` (importing every
module, serving a tiny model static and adaptive, and a canaried writer
serve over a policy store with an SLO engine, a trace recorder and a
replica loads neither), and
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
import tempfile
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
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m == "repro" or m.startswith("repro."))
print(json.dumps({{"modules": len(names), "bad": bad, "shape": list(toks.shape),
                  "adaptive": list(adaptive.shape), "observed": ctrl.step,
                  "retunes": len(writer.retunes), "audit": kinds,
                  "replica": replica.version, "metrics": "repro_canary_total" in text}}))
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
    assert res["metrics"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_import_statement_names_jax_or_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
    import repro_torch.kernels.ops as ops
    import repro_torch.models as models
    from repro_torch import obs
    from repro_torch.fleet import PolicyReader
    from repro_torch.runtime import AdaptiveController, SwapPolicy

    return {"init_params": models.init_params, "init_cache": models.init_cache,
            "params_from_jax": convert.params_from_jax,
            "AdaptiveController": AdaptiveController.__init__,
            "PolicyReader": PolicyReader.__init__, "SwapPolicy.dyn_tree": SwapPolicy.dyn_tree,
            "device_trace": obs.trace.device_trace.__wrapped__,
            "component_sweep": tuning.component_sweep, "two_bit_sweep": tuning.two_bit_sweep,
            "tune_application": tuning.tune_application,
            "component_sweep_kernel": ops.component_sweep_kernel,
            "tune_app": apps.tune_app, "evaluate": apps.evaluate,
            "is_commutative": mults.is_commutative}


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """Every entry point that holds tensors runs on ``cuda`` unless the
    caller passes ``device="cpu"``."""
    import inspect

    sig = inspect.signature(_entry_points()[name])
    assert sig.parameters["device"].default == "cuda", name
