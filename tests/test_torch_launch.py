"""The port's serve CLI (``repro_torch.launch.serve.main``) on the CPU: the
single serve (static and adaptive with ``--policy-out``), the fleet front
end through the continuous batcher (token mode with ``--obs-dir``, wave
mode under an arrival trace and a fault plan that kills the replica once),
and the flags that exit with a message: ``--fleet 2`` (the device mesh),
``--autotune`` / ``--schedule-store`` and an architecture the port does not
hold.  Small shapes (``--smoke``, 16-token prompts, 6 new tokens)."""
import json
import os

import pytest

from repro.configs import ARCHS as J_ARCHS
from repro_torch.configs import ARCHS
from repro_torch.fleet import chaos
from repro_torch.launch import serve

SMALL = ["--device", "cpu", "--smoke", "--prompt-len", "16", "--new-tokens", "6"]


def test_single_serve_static_and_adaptive(capsys, tmp_path):
    out, ctrl = serve.main(SMALL)
    assert out.shape == (4, 6) and ctrl is None
    assert "generated 24 tokens" in capsys.readouterr().out

    policy = tmp_path / "policy.json"
    out, ctrl = serve.main(SMALL + ["--ax", "--adaptive", "--policy-out", str(policy)])
    text = capsys.readouterr().out
    assert out.shape == (4, 6) and ctrl.step == 5
    assert "[drift] step 2" in text and "re-tunes:" in text
    assert json.loads(policy.read_text())["mult_name"] == "mul8s_trunc0_4"


def test_fleet_token_granular_writes_obs_files(capsys, tmp_path):
    obs_dir, store = tmp_path / "obs", tmp_path / "store"
    bat, done = serve.main(SMALL + ["--ax", "--fleet", "1", "--token-granular",
                                    "--requests", "6", "--obs-dir", str(obs_dir),
                                    "--policy-store", str(store)])
    text = capsys.readouterr().out
    assert "[fleet] served 6 requests" in text and "after poll: staleness=[0]" in text
    assert sorted(c.rid for c in done) == list(range(6))
    assert bat.mode == "token" and all(c.qor is not None for c in done)
    trace = json.loads((obs_dir / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"token_step", "admit", "request"} <= names
    assert "repro_admissions_total" in (obs_dir / "metrics.prom").read_text()
    assert len((obs_dir / "metrics.jsonl").read_text().splitlines()) == 1
    assert os.path.exists(store / "CURRENT")


def test_fleet_wave_arrivals_survive_an_injected_crash(capsys, tmp_path):
    plan = tmp_path / "plan.json"
    chaos.FaultPlan([chaos.FaultSpec("sched.step", "crash_replica", at=0)]).save(str(plan))
    bat, done = serve.main(SMALL + ["--fleet", "1", "--requests", "5", "--arrival-rate",
                                    "500", "--chaos-plan", str(plan), "--policy-store",
                                    str(tmp_path / "store")])
    text = capsys.readouterr().out
    assert "[chaos] survived injected crash" in text and "arrival trace: 5" in text
    assert bat.mode == "wave" and sorted(c.rid for c in done) == list(range(5))
    assert chaos.current() is None


@pytest.mark.parametrize("argv,match", [
    (["--fleet", "2", "--backend", "nccl"], "CPU ranks use gloo"),
    (["--arch", "whisper-base", "--adaptive"], "serves statically only"),
    (["--arch", "whisper-base", "--fleet", "1"], "serves statically only"),
])
def test_flags_that_exit_with_a_message(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(SMALL + argv)


def test_an_arch_the_port_does_not_hold_exits():
    """The port holds every JAX architecture; an unknown name exits with
    the port's list."""
    assert set(J_ARCHS) == set(ARCHS)
    with pytest.raises(SystemExit, match="not an architecture of the port") as e:
        serve.main(SMALL + ["--arch", "no-such-arch"])
    assert str(sorted(ARCHS)) in str(e.value)


def test_the_device_defaults_to_the_card():
    assert serve._parser().parse_args([]).device == "cuda"
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            serve.main(["--smoke"])
