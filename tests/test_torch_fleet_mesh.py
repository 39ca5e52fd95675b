"""The mesh-sharded serve of the port (``generate(mesh=)``,
``token_step(mesh=)``, ``ContinuousBatcher(mesh=)``, the serve CLI's
``--fleet N``) in real ``gloo`` worlds of 2 and 4 ranks on the CPU
(``launch.mesh.spawn``: spawned processes, a ``FileStore``, a hard
timeout), on reduced qwen2 (2 layers, ``mxu``).

The JAX package's sharded serve does not run in this container (ROADMAP
queue 3, item 1), so the port's is held to the oracles JAX's own tests
use (``tests/test_fleet.py``): the tokens of the single-process unrolled
adaptive loop over the whole batch, and per observed step the host
combiner (``combine_records``, the port's and the JAX package's) of each
rank's records when it serves its block alone; the fleet telemetry's
``n``, ``sum_abs``, ``count_neq`` (sums) and ``max_abs`` (max) equal those
of the solo runs.  A mesh batcher gives every request the tokens of the
one-process batcher, in wave and token mode, with async admission and
EOS.  Each world is spawned once per module (fixtures) and the tests read
its results.
"""

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as RK
from repro.runtime.telemetry import combine_records as j_combine
from repro_torch.fleet import BatcherConfig, ContinuousBatcher
from repro_torch.launch.mesh import spawn
from repro_torch.launch.sharding import MeshShape
from repro_torch.models import init_params
from repro_torch.runtime.telemetry import combine_records as t_combine
from repro_torch.serve import ServeConfig, generate, token_step
from repro_torch.core import SwapConfig

TIMEOUT = 240


def _world(fn, n, *args):
    return spawn(fn, n, args=args, device="cpu", timeout_s=TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def model():
    cfg = RK.qwen_cfg()
    return cfg, init_params(cfg, seed=0, device="cpu")


def _requests(cfg):
    rng = np.random.default_rng(3)
    return [(rng.integers(0, cfg.vocab, int(rng.integers(5, 33))).tolist(),
             int(rng.integers(1, 9))) for _ in range(8)]


@pytest.fixture(scope="module")
def worlds(model):
    """One 2-rank and one 4-rank world, each spawned once: the serves and
    the drains; the one-process drains beside them."""
    cfg, params = model
    reqs = _requests(cfg)
    base = dict(n_slots=4, prompt_buckets=(16, 32), new_token_bucket=8)
    wave = RK.drain(params, cfg, reqs, base)
    # an EOS taken from the run's own tokens: a mid-sequence token
    eos = next(t[2] for t in wave[0].values() if len(t) > 3)
    configs = {"wave": base, "token": dict(base, token_granular=True),
               "token_async": dict(base, token_granular=True, async_admission=True),
               "token_eos": dict(base, token_granular=True, eos_id=eos),
               "wave_eos": dict(base, eos_id=eos),
               # a deadline of 0 s lapses at the first check, on the agreed clock
               "token_deadline": dict(base, token_granular=True, deadlines={3: 0.0, 6: 0.0})}
    one = {"wave": wave}
    one.update({label: RK.drain(params, cfg, reqs, kw) for label, kw in configs.items()
                if label != "wave"})
    two = _world(RK.jobs_rank, 2, [("serve_rank", ()),
                                   ("batcher_rank", (reqs, configs))])
    four = _world(RK.jobs_rank, 4, [("serve_rank", (False, (0,))),
                                    ("batcher_rank", (reqs, {"token": configs["token"]}))])
    return dict(serves={2: [r[0] for r in two], 4: [r[0] for r in four]},
                drains=(one, [r[1] for r in two], [r[1] for r in four]))


@pytest.fixture(scope="module")
def serves(worlds):
    return worlds["serves"]


@pytest.fixture(scope="module")
def drains(worlds):
    return worlds["drains"]


@pytest.fixture(scope="module")
def unrolled(model):
    """The single-process unrolled adaptive loop over the whole batch, per
    granularity, and after the policy update."""
    cfg, params = model
    toks = RK.prompts(cfg)
    out = {}
    for tile_rows in (0, 2):
        out[tile_rows] = generate(params, {"tokens": toks}, cfg,
                                  ServeConfig(max_new_tokens=RK.T, fused=False),
                                  adaptive=RK.controller(cfg, tile_rows)).numpy()
    c = RK.controller(cfg)
    c.policy.set_config("mlp", SwapConfig("B", 5, 1))
    out["update"] = generate(params, {"tokens": toks}, cfg,
                             ServeConfig(max_new_tokens=RK.T, fused=False), adaptive=c).numpy()
    return out


def _equal_records(got, want):
    assert set(got) == set(want)
    for t in want:
        assert set(got[t]) == set(want[t]), t
        for k, v in want[t].items():
            g = np.asarray(got[t][k])
            assert g.dtype == np.asarray(v).dtype, (t, k)
            np.testing.assert_array_equal(g, v, err_msg=f"{t}.{k}")


# tile mode on 2 ranks, scalar mode on 2 and 4
CASES = [(2, 0), (2, 2), (4, 0)]


@pytest.mark.parametrize("n,tile_rows", CASES)
def test_mesh_generate_gives_the_unrolled_loops_tokens_on_every_rank(serves, unrolled, n,
                                                                       tile_rows):
    for rank, res in enumerate(serves[n]):
        np.testing.assert_array_equal(res[tile_rows]["tokens"], unrolled[tile_rows],
                                      err_msg=f"rank {rank}")
        np.testing.assert_array_equal(res[tile_rows]["solo_tokens"],
                                      unrolled[tile_rows][RK.block(rank, n)])


@pytest.mark.parametrize("n,tile_rows", CASES)
def test_fleet_records_equal_combine_records_of_the_solo_shards(serves, n, tile_rows):
    """Every observed step's fleet record (the same on every rank) equals
    the host combiner of the ranks' solo records of that step, bit for bit
    and field type for field type; the tile records in tile mode."""
    ranks = [r[tile_rows] for r in serves[n]]
    steps = len(ranks[0]["records"])
    assert steps == RK.T - 1
    for i in range(steps):
        solo = [r["solo_records"][i] for r in ranks]
        want = t_combine(solo)
        _equal_records(want, j_combine(solo))
        for r in ranks:
            _equal_records(r["records"][i], want)
    if tile_rows:
        assert any(k.endswith("@tiles") for k in ranks[0]["records"][0])


@pytest.mark.parametrize("n,tile_rows", CASES)
def test_fleet_telemetry_sums_equal_the_solo_runs(serves, n, tile_rows):
    ranks = [r[tile_rows] for r in serves[n]]
    for t, (n_, sum_abs, max_abs, neq) in ranks[0]["stats"].items():
        solo = [r["solo_stats"][t] for r in ranks]
        assert n_ == sum(s[0] for s in solo) and sum_abs == sum(s[1] for s in solo)
        assert max_abs == max(s[2] for s in solo) and neq == sum(s[3] for s in solo)
        assert all(r["stats"][t] == ranks[0]["stats"][t] for r in ranks)


@pytest.mark.parametrize("n", [2, 4])
def test_a_policy_update_on_the_mesh_builds_nothing(serves, unrolled, n):
    for res in serves[n]:
        up = res["update"]
        assert up["captures"] and up["nvcc"] == 0 and up["programs"] == 0
        np.testing.assert_array_equal(up["tokens"], unrolled["update"])
    assert not np.array_equal(unrolled["update"], unrolled[0])


def test_mesh_token_step_follows_the_mesh_decode(serves):
    """``token_step(mesh=)`` over each rank's prefilled block: the tokens
    and every step's fleet record of ``generate(mesh=)``."""
    for res in serves[2]:
        np.testing.assert_array_equal(res["token"]["tokens"], res[0]["tokens"])
        for got, want in zip(res["token"]["records"], res[0]["records"]):
            _equal_records(got, want)


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["wave", "token", "token_async", "token_eos", "wave_eos",
                                   "token_deadline"])
def test_two_rank_batcher_gives_each_request_the_one_rank_tokens(drains, label):
    one, two, _ = drains
    want_toks, want_finish, want_stats = one[label]
    assert len(want_toks) == 8
    for rank, res in enumerate(two):
        toks, finish, stats = res[label]
        assert toks == want_toks, (rank, label)
        assert finish == want_finish
        for k in ("requests", "real_tokens", "splices", "backfilled", "eos_retired",
                  "decode_steps", "decode_retraces_post_warmup"):
            assert stats[k] == want_stats[k], (k, stats[k], want_stats[k])
    if label.endswith("eos"):
        assert one[label][2]["eos_retired"] > 0
    if label == "token_deadline":
        assert want_finish[3] == want_finish[6] == "timeout" and want_toks[3] == []
        assert want_stats["timeouts"] == 2 == two[0][label][2]["timeouts"]


def test_four_rank_token_batcher_gives_the_one_rank_tokens(drains):
    one, _, four = drains
    for res in four:
        assert res["token"][0] == one["token"][0]
        assert res["token"][2]["splices"] == one["token"][2]["splices"] > 0


def test_cli_fleet_two_serves_what_fleet_one_serves(tmp_path):
    from repro_torch.launch.serve import main

    common = ["--device", "cpu", "--smoke", "--ax", "--token-granular", "--requests", "6",
              "--prompt-len", "8", "--new-tokens", "4", "--slots", "4"]
    bat, done1 = main(common + ["--fleet", "1", "--policy-store", str(tmp_path / "a")])
    summary, done2 = main(common + ["--fleet", "2", "--policy-store", str(tmp_path / "b"),
                                    "--world-timeout", str(TIMEOUT)])
    assert {c.rid: c.tokens.tolist() for c in done1} == \
        {c.rid: c.tokens.tolist() for c in done2}
    assert summary["stats"]["requests"] == bat.stats["requests"] == 6
    assert summary["describe"].startswith("batcher[token]")


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_mesh_guards_raise_where_jax_asserts(model):
    cfg, params = model
    toks = RK.prompts(cfg, 4, 8)
    fake = MeshShape(("data",), (2,))
    with pytest.raises(ValueError, match="adaptive fused path"):
        generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=2), mesh=fake)
    with pytest.raises(ValueError, match="adaptive fused path"):
        generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=2, fused=False),
                 adaptive=RK.controller(cfg), mesh=fake)
    with pytest.raises(ValueError, match="adaptive fused path"):
        generate(params, {"tokens": toks}, cfg, ServeConfig(max_new_tokens=2),
                 adaptive=RK.controller(cfg), param_hook=lambda i, p: p, mesh=fake)
    z = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="adaptive token step"):
        token_step(params, [], z, z, z.bool(), cfg, mesh=fake)
    with pytest.raises(ValueError, match="requires an adaptive"):
        ContinuousBatcher(params, cfg, BatcherConfig(n_slots=4), mesh=fake)
    with pytest.raises(ValueError, match="must divide"):
        ContinuousBatcher(params, cfg, BatcherConfig(n_slots=8), adaptive=RK.controller(cfg),
                          mesh=MeshShape(("data",), (3,)))
    with pytest.raises(ValueError, match="overflow"):
        ContinuousBatcher(params, cfg, BatcherConfig(n_slots=66),
                          adaptive=RK.controller(cfg), mesh=MeshShape(("data",), (33,)))
