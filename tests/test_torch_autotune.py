"""The port's kernel-schedule autotuner (``repro_torch.kernels.autotune``)
on the CPU, against the JAX package.

The candidate space (the default first, no two candidates launching the
same thing, every split leaving each block a K step, ``quick`` smaller,
caps only for the static ops); ``sweep`` with injected callables and an
injected timer; every candidate of all four signature ops, through the
plain versions, equal to JAX's ``ax_matmul``/``ax_matmul_grid`` (Pallas in
interpret mode) with equal ``tile_hist``; ``tune_table`` and the CLI
publishing a table that JAX's reader adopts; and the serve CLI's
``--autotune --schedule-store`` serving the tokens of a serve without it.
CPU walls say nothing about the card: the card's sweep is
``chip_smoke.py``'s autotune phase and ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as JC
import repro.kernels as JK
from repro.kernels.autotune import ScheduleReader as JReader, ScheduleStore as JStore
import repro_torch.kernels as TK
from repro_torch import obs as tobs
from repro_torch.core.multipliers import get
from repro_torch.kernels import autotune as TA
from repro_torch.kernels.ax_matmul import K_STEP, plan
from repro_torch.kernels.ref import tile_hist_blocks
from repro_torch.kernels.schedule import sig_key

MULT = "mul8s_trunc0_4"


@pytest.fixture(autouse=True)
def _clean_tables():
    JK.clear_table()
    TK.clear_table()
    yield
    JK.clear_table()
    TK.clear_table()


@pytest.mark.parametrize("route, M, K, N", [("T", 4, 8192, 29568), ("T", 128, 29568, 8192),
                                            ("T", 96, 200, 48), ("C", 4, 8192, 8192),
                                            ("C", 128, 512, 384)])
@pytest.mark.parametrize("op", ["matmul", "matmul_grid"])
def test_candidate_space(route, M, K, N, op):
    full = TA.candidate_schedules("kernel", M, K, N, op=op, route=route)
    quick = TA.candidate_schedules("kernel", M, K, N, op=op, quick=True, route=route)
    d = plan(route, M if M <= 128 else -(-M // 128) * 128, 128, K_STEP)
    steps = -(-(K if K <= 128 else -(-K // 128) * 128) // K_STEP)
    for cands in (full, quick):
        assert cands[0] == TK.default_schedule("kernel")
        keys = [TA._launch_key(s, route, M, K, N, 132) for s in cands]
        assert len(set(keys)) == len(keys)                       # no launch twice
        for s in cands:
            assert s.tile is None or s.tile <= d.tile
            assert s.splits is None or 1 <= s.splits <= steps
        assert any(s.grid_order == "nm" for s in cands)
        assert {s.backend for s in cands} == {"kernel"}
    assert len(quick) < len(full) and {s.short() for s in quick} <= {s.short() for s in full}
    caps = [s for s in full if (s.bm, s.bn) != (128, 128)]
    if op == "matmul":
        assert caps and all(M % s.bm == 0 and N % s.bn == 0 for s in caps)
    else:
        assert not caps
    assert (route == "C") == any(s.slots is not None for s in full)
    assert not any(s.slots is not None for s in quick)


def test_mxu_candidates_are_route_t_and_emul_has_none():
    c = TA.candidate_schedules("mxu", 4, 512, 256, op="int_dyn", route="C")
    assert c[0] == TK.default_schedule("mxu") and all(s.slots is None for s in c)
    with pytest.raises(ValueError):
        TA.candidate_schedules("emul", 4, 512, 256)


def test_sweep_picks_the_minimum_and_counts():
    calls = {"a": 0, "b": 0, "c": 0}

    def make(name):
        def f():
            calls[name] += 1
        return f

    cost = {"a": 5.0, "b": 1.0, "c": 3.0}
    fns = [make(n) for n in "abc"]
    timer = lambda f: (f(), cost["abc"[fns.index(f)]])[1]  # noqa: E731
    reg = tobs.default_registry().get("repro_sched_tuner_candidates_total")
    n0 = reg.total()
    best, walls = TA.sweep(fns, reps=3, warmup=1, timer=timer)
    assert best == 1 and walls == [5.0, 1.0, 3.0]
    assert calls == {"a": 4, "b": 4, "c": 4}                    # warm-up + 3 reps
    assert reg.total() == n0 + 3

    def slow():
        for _ in range(20000):
            pass

    best, walls = TA.sweep([slow, lambda: None], reps=3)        # the host clock
    assert best == 1 and walls[1] <= walls[0]


def test_every_candidate_equals_jax_with_its_tile_hist():
    """All four ops' candidates (full sweep, both routes) through the plain
    versions give JAX's ``ax_matmul`` / ``ax_matmul_grid`` bits, and each
    candidate's ``tile_hist`` JAX's histogram of its tiles."""
    M, K, N = 24, 256, 80
    a, b = TA.operands(M, K, N, seed=3)
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    for name in (MULT, "mul8s_drum3_4"):
        jm = JC.get(name)
        want = np.asarray(JK.ax_matmul(ja, jb, jm, JC.SwapConfig("A", 3, 0)))
        grid = jnp.broadcast_to(jnp.asarray((1, 3, 0), jnp.int32), (1, 1, 3))
        jgrid = np.asarray(JK.ax_matmul_grid(ja, jb, jm, grid,
                                             schedule=JK.KernelSchedule(bm=M, bn=N, bk=64)))
        assert np.array_equal(want, jgrid)
        ops = ("matmul", "matmul_grid") + (("int_static", "int_dyn") if name == MULT else ())
        route = "T" if name == MULT else "C"
        m = get(name)
        seen = 0
        for op in ops:
            backend = "kernel" if op.startswith("matmul") else "mxu"
            for s in TA.candidate_schedules(backend, M, K, N, op=op, route=route):
                got = TA.dispatch_fn(op, a, b, name, s)()
                assert np.array_equal(got.numpy(), want), (name, op, s.short())
                out, hist = TK.ax_matmul(a, b, m, None, schedule=s, tile_hist=True)
                bm, bn = min(s.bm, M), min(s.bn, N)
                jh = JK.tile_hist_ref(ja, jb, m.bits, -(-M // bm), -(-N // bn))
                assert np.array_equal(hist.numpy(), np.asarray(jh)), (op, s.short())
                assert torch.equal(hist, tile_hist_blocks(a, b, m.bits, bm, bn))
                seen += 1
        assert seen >= 20


def test_tune_table_on_the_cpu_loads_in_jax(tmp_path):
    shapes = [(4, 128, 64), (16, 64, 96)]
    table, reports = TA.tune_table(shapes, MULT, quick=True, device="cpu")
    assert len(table) == len(reports) == 8
    assert table.meta["device"] == "cpu" and table.meta["mode"] == "quick"
    for (M, K, N) in shapes:
        for backend, ops in TA.DEFAULT_OPS.items():
            for op in ops:
                s = table.lookup(M, K, N, backend, MULT, op)
                assert s is not None and s.backend == backend
                assert s in TA.candidate_schedules(backend, M, K, N, op=op, quick=True)
    rep = reports[0]
    assert rep["sig"] == sig_key(4, 128, 64, "kernel", MULT, "matmul")
    assert rep["default_us"] == rep["walls_us"][TK.default_schedule().short()]
    assert rep["best_us"] == min(rep["walls_us"].values()) and rep["route"] == "T"
    store = TA.ScheduleStore(str(tmp_path / "s"))
    assert store.publish(table) == 1
    jr = JReader(JStore(store.root), name="jax")
    assert jr.version == 1 and set(jr.table.entries) == set(table.entries)
    for key, s in table.entries.items():
        j = jr.table.entries[key]
        assert (j.bm, j.bn, j.bk, j.grid_order, j.backend) == \
            (s.bm, s.bn, s.bk, s.grid_order, s.backend)


def test_cli_publishes_what_jax_adopts(tmp_path, capsys):
    out, root = str(tmp_path / "t.json"), str(tmp_path / "store")
    assert TA.main(["--device", "cpu", "--quick", "--shapes", "4x64x48,8x128x64",
                    "--backends", "kernel,mxu", "--out", out, "--store", root]) == 0
    text = capsys.readouterr().out
    assert "4x64x48/mxu/mul8s_trunc0_4/int_dyn:" in text and "published v1" in text
    assert "device: cpu" in text
    t = TK.ScheduleTable.load(out)
    assert len(t) == 8
    jr = JReader(JStore(root), name="jax")
    assert jr.version == 1 and set(jr.table.entries) == set(t.entries)
    if not torch.cuda.is_available():            # the card is the default device
        with pytest.raises(SystemExit):
            TA.main(["--shapes", "4x64x48"])


def test_serve_cli_autotune_serves_the_same_tokens(tmp_path, capsys):
    from repro_torch.launch import serve

    argv = ["--device", "cpu", "--smoke", "--ax", "--batch", "2", "--prompt-len", "8",
            "--new-tokens", "4"]
    base, _ = serve.main(argv)
    root = str(tmp_path / "sched")
    hits0 = tobs.default_registry().get("repro_sched_lookups_total").value(result="hit")
    tuned, _ = serve.main(argv + ["--autotune", "--schedule-store", root])
    text = capsys.readouterr().out
    assert np.array_equal(tuned, base)
    assert text.count("[autotune] ") == 3 * 2 + 1 and "published schedule table v1" in text
    assert TK.installed_table() is not None and len(TK.installed_table()) == 3 * 2
    assert tobs.default_registry().get("repro_sched_lookups_total").value(
        result="hit") > hits0
    assert TA.ScheduleStore(root).current_version() == 1
