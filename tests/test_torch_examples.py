"""The port's examples (``examples/torch_*.py``) run on the CPU.

Each runs in a subprocess with ``--device cpu`` (and ``--smoke`` where the
JAX namesake has a size; ``--ranks 2`` for the fleet, whose ranks are
spawned processes), in a temporary directory, exits 0, prints what
its JAX namesake prints, and loads neither JAX nor the JAX package; each
defaults to the card.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# example -> (extra arguments, a line its output must hold)
EXAMPLES = {
    "torch_quickstart": ([], "SWAPPER best bit"),
    "torch_error_profile": ([], "full surfaces saved to error_profile.npz"),
    "torch_axbench_sobel": (["--smoke"], "SWAPPER app-tuned"),
    "torch_serve_decode": (["--smoke"], "generated token ids:"),
    "torch_adaptive_drift": (["--smoke"], "re-tunes: 1"),
    "torch_train_lm_ax": (["--smoke"], "'steps_run': 3"),
    "torch_fleet_serve": (["--ranks", "2"], "replica 1: v2 configs_equal(writer)=True"),
}

_RUN = r"""
import json, runpy, sys
sys.argv = [{path!r}] + {args!r}
runpy.run_path({path!r}, run_name="__main__")
bad = sorted(m for m in sys.modules if m.startswith("jax") or m == "repro"
             or m.startswith("repro."))
print("LOADED " + json.dumps(bad))
"""


def test_every_port_example_is_listed():
    found = sorted(p.stem for p in (ROOT / "examples").glob("torch_*.py"))
    assert found == sorted(EXAMPLES)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, want = EXAMPLES[name]
    path = str(ROOT / "examples" / f"{name}.py")
    # one intra-op thread, as tests/test_torch_threads.py holds the workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _RUN.format(path=path, args=["--device", "cpu"] + args)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert want in out.stdout, out.stdout[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1][len("LOADED "):])
    assert loaded == [], loaded


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_defaults_to_the_card(name):
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod._parser().parse_args([]).device == "cuda"
