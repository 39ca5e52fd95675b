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

The four-rank world also serves the reduced starcoder2 (2 layers, ``mxu``,
f32; the gelu MLP with biases, GQA) from the JAX package's own initial
weights (``params_from_jax``, handed to the ranks as numpy), held to the
same oracles and, beside them, to JAX's one-device stepwise adaptive serve
(``repro.serve.generate(..., adaptive=)``, ``fused=False``) of the same
weights: the tokens, and each observed step's integer fields through JAX's
host combiner of its serves of the ranks' blocks.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as RK
import repro.configs as JC
import repro.models as JM
import repro.runtime as JR
from repro.configs.base import AxPolicy as JPolicy
from repro.runtime.telemetry import combine_records as j_combine
from repro.serve.engine import ServeConfig as JServe, generate as j_generate
from repro_torch.fleet import BatcherConfig, ContinuousBatcher
from repro_torch.launch.mesh import spawn
from repro_torch.launch.sharding import MeshShape
from repro_torch.models import init_params
from repro_torch.runtime.telemetry import combine_records as t_combine
from repro_torch.serve import ServeConfig, generate, token_step
from repro_torch.core import SwapConfig

TIMEOUT = 240
Q, SC = "qwen2-72b", "starcoder2-15b"


def _world(fn, n, *args):
    return spawn(fn, n, args=args, device="cpu", timeout_s=TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def model():
    cfg = RK.qwen_cfg()
    return cfg, init_params(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def starcoder():
    """JAX's reduced starcoder2 (the configuration of ``RK.starcoder_cfg``)
    and its initial weights, as JAX params, as numpy and in the port."""
    jc = dataclasses.replace(JC.reduced(JC.ARCHS[SC]), n_layers=2, compute_dtype="float32",
                             ax=JPolicy(backend="mxu"))
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    np_tree = jax.device_get(jp)
    cfg, params = RK.model(SC, np_tree)
    return dict(jc=jc, jp=jp, np_tree=np_tree, cfg=cfg, params=params)


def _requests(cfg):
    rng = np.random.default_rng(3)
    return [(rng.integers(0, cfg.vocab, int(rng.integers(5, 33))).tolist(),
             int(rng.integers(1, 9))) for _ in range(8)]


@pytest.fixture(scope="module")
def worlds(model, starcoder):
    """One 2-rank and one 4-rank world, each spawned once: the serves and
    the drains (of the reduced starcoder2 too, on four ranks); the
    one-process drains beside them, and JAX's serves of the starcoder2
    ranks' blocks (on a thread while the worlds run)."""
    toks = RK.prompts(starcoder["cfg"]).numpy().astype(np.int32)
    jax_blocks = []
    jax_thread = threading.Thread(target=lambda: jax_blocks.extend(
        _jax_serve(starcoder, toks[RK.block(r, 4)]) for r in range(4)))
    jax_thread.start()
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
    sc_one = RK.drain(starcoder["params"], starcoder["cfg"], reqs, configs["token"])
    two = _world(RK.jobs_rank, 2, [("serve_rank", ()),
                                   ("batcher_rank", (reqs, configs))])
    sc = (SC, starcoder["np_tree"])
    four = _world(RK.jobs_rank, 4, [("serve_rank", (False, (0,))),
                                    ("batcher_rank", (reqs, {"token": configs["token"]})),
                                    ("serve_rank", (False, (0,)) + sc),
                                    ("batcher_rank", (reqs, {"token": configs["token"]}) + sc)])
    jax_thread.join()
    return dict(serves={(2, Q): [r[0] for r in two], (4, Q): [r[0] for r in four],
                        (4, SC): [r[2] for r in four]},
                drains=(one, [r[1] for r in two], [r[1] for r in four]),
                starcoder_drains=(sc_one, [r[3]["token"] for r in four]), jax_blocks=jax_blocks)


@pytest.fixture(scope="module")
def serves(worlds):
    return worlds["serves"]


@pytest.fixture(scope="module")
def drains(worlds):
    return worlds["drains"]


@pytest.fixture(scope="module")
def unrolled(model, starcoder):
    """The single-process unrolled adaptive loop over the whole batch, per
    model and granularity, and after the policy update."""
    out = {Q: {}, SC: {}}
    for arch, (cfg, params), modes in ((Q, model, (0, 2)),
                                       (SC, (starcoder["cfg"], starcoder["params"]), (0,))):
        for tile_rows in modes:
            out[arch][tile_rows] = generate(
                params, {"tokens": RK.prompts(cfg)}, cfg,
                ServeConfig(max_new_tokens=RK.T, fused=False),
                adaptive=RK.controller(cfg, tile_rows)).numpy()
    cfg, params = model
    c = RK.controller(cfg)
    c.policy.set_config("mlp", SwapConfig("B", 5, 1))
    out[Q]["update"] = generate(params, {"tokens": RK.prompts(cfg)}, cfg,
                                ServeConfig(max_new_tokens=RK.T, fused=False),
                                adaptive=c).numpy()
    return out


def _equal_records(got, want):
    assert set(got) == set(want)
    for t in want:
        assert set(got[t]) == set(want[t]), t
        for k, v in want[t].items():
            g = np.asarray(got[t][k])
            assert g.dtype == np.asarray(v).dtype, (t, k)
            np.testing.assert_array_equal(g, v, err_msg=f"{t}.{k}")


# qwen2: tile mode on 2 ranks, scalar mode on 2 and 4; starcoder2: scalar on 4
CASES = [pytest.param(2, 0, Q, id="2-0"), pytest.param(2, 2, Q, id="2-2"),
         pytest.param(4, 0, Q, id="4-0"), pytest.param(4, 0, SC, id="4-0-starcoder2")]


@pytest.mark.parametrize("n,tile_rows,arch", CASES)
def test_mesh_generate_gives_the_unrolled_loops_tokens_on_every_rank(serves, unrolled, n,
                                                                       tile_rows, arch):
    want = unrolled[arch][tile_rows]
    for rank, res in enumerate(serves[n, arch]):
        np.testing.assert_array_equal(res[tile_rows]["tokens"], want, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(res[tile_rows]["solo_tokens"], want[RK.block(rank, n)])


@pytest.mark.parametrize("n,tile_rows,arch", CASES)
def test_fleet_records_equal_combine_records_of_the_solo_shards(serves, n, tile_rows, arch):
    """Every observed step's fleet record (the same on every rank) equals
    the host combiner of the ranks' solo records of that step, bit for bit
    and field type for field type; the tile records in tile mode."""
    ranks = [r[tile_rows] for r in serves[n, arch]]
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


@pytest.mark.parametrize("n,tile_rows,arch", CASES)
def test_fleet_telemetry_sums_equal_the_solo_runs(serves, n, tile_rows, arch):
    ranks = [r[tile_rows] for r in serves[n, arch]]
    for t, (n_, sum_abs, max_abs, neq) in ranks[0]["stats"].items():
        solo = [r["solo_stats"][t] for r in ranks]
        assert n_ == sum(s[0] for s in solo) and sum_abs == sum(s[1] for s in solo)
        assert max_abs == max(s[2] for s in solo) and neq == sum(s[3] for s in solo)
        assert all(r["stats"][t] == ranks[0]["stats"][t] for r in ranks)


@pytest.mark.parametrize("n", [2, 4])
def test_a_policy_update_on_the_mesh_builds_nothing(serves, unrolled, n):
    for res in serves[n, Q]:
        up = res["update"]
        assert up["captures"] and up["nvcc"] == 0 and up["programs"] == 0
        np.testing.assert_array_equal(up["tokens"], unrolled[Q]["update"])
    assert not np.array_equal(unrolled[Q]["update"], unrolled[Q][0])


def test_mesh_token_step_follows_the_mesh_decode(serves):
    """``token_step(mesh=)`` over each rank's prefilled block: the tokens
    and every step's fleet record of ``generate(mesh=)``."""
    for res in serves[2, Q]:
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


def test_four_rank_token_batcher_of_starcoder2_gives_the_one_rank_tokens(worlds):
    one, four = worlds["starcoder_drains"]
    assert len(one[0]) == 8
    for res in four:
        assert res[0] == one[0] and res[1] == one[1]
        assert res[2]["splices"] == one[2]["splices"] > 0


def _jax_serve(starcoder, toks):
    """JAX's one-device stepwise adaptive serve of ``toks`` with a detector
    that never fires: (tokens, each observed step's host records)."""
    jc = starcoder["jc"]
    ctrl = JR.AdaptiveController(JR.SwapPolicy.from_ax_policy(jc.ax), jc.ax.targets,
                                 cfg=JR.AdaptiveConfig(min_observe_steps=10 ** 6))
    seen, observe = [], ctrl.observe

    def keep(records):
        seen.append({t: {k: np.asarray(v) for k, v in rec.items()}
                     for t, rec in records.items()})
        return observe(records)

    ctrl.observe = keep
    out = j_generate(starcoder["jp"], {"tokens": jnp.asarray(toks)}, jc,
                     JServe(max_new_tokens=RK.T, fused=False), adaptive=ctrl)
    return np.asarray(out), seen


def _port_ratios(starcoder, toks, monkeypatch):
    """The port's one-process stepwise adaptive serve of ``toks``, every
    summarized operand's ``a_smp`` codes beside their ``x / scale`` before
    rounding: [(codes, ratios)] in call order."""
    import repro_torch.quant.ax as TAX
    import repro_torch.runtime.telemetry as TTel

    tq, tos = TAX.quantize_rows, TTel.operand_summary
    last, calls = [], []

    def quantize(x, axis=-1, amax=None):
        q, sc = tq(x, axis, amax)
        if axis == -1:
            last[:] = [x / sc]
        return q, sc

    def summary(xq, wq, mult, dyn, **kw):
        calls.append((TTel._flat_sample(xq, TTel.RETUNE_SAMPLE).numpy(),
                      TTel._flat_sample(last[0], TTel.RETUNE_SAMPLE).numpy()))
        return tos(xq, wq, mult, dyn, **kw)

    monkeypatch.setattr(TAX, "quantize_rows", quantize)
    monkeypatch.setattr(TTel, "operand_summary", summary)
    cfg = starcoder["cfg"]
    generate(starcoder["params"], {"tokens": torch.from_numpy(toks)}, cfg,
             ServeConfig(max_new_tokens=RK.T, fused=False), adaptive=RK.controller(cfg))
    monkeypatch.undo()
    return calls


# an activation whose x / scale lies this close to a rounding boundary may
# round to either code on an ulp-level difference of the float activation
TOL_FLIP = 1e-4


def test_four_rank_starcoder2_serve_equals_jax_stepwise_serve(worlds, serves, starcoder,
                                                              monkeypatch):
    """The reduced starcoder2 on four ranks against JAX's one-device
    stepwise adaptive serve of the same weights, run over each rank's rows:
    every rank's tokens equal JAX's, and each observed step's fleet record
    equals JAX's host combiner of JAX's records of the ranks' blocks in
    every integer field, but where an int8 activation code sits on a
    rounding boundary: at step 3 one ``attn_out`` input of row 7 lies 9.5e-7
    from one in the port's own one-process serve (x / scale -10.500001; two
    places of the 2 x 512 sampled codes hold it), and the attention
    output's last-bit difference from XLA's rounds it one code apart.  Such
    a code is one apart, sits within ``TOL_FLIP`` of a boundary, and moves
    only its step's sample and error fields of its target."""
    toks = RK.prompts(starcoder["cfg"]).numpy().astype(np.int32)
    blocks = worlds["jax_blocks"]
    assert len(blocks) == 4
    whole = np.concatenate([b[0] for b in blocks])
    ranks = [r[0] for r in serves[4, SC]]
    assert all(len(b[1]) == len(ranks[0]["records"]) == RK.T - 1 for b in blocks)
    for rank, res in enumerate(ranks):
        np.testing.assert_array_equal(res["tokens"], whole, err_msg=f"rank {rank}")
    errs = {"err_lo", "err_hi", "err_cnt", "err_max"}
    flips = []
    for i in range(RK.T - 1):
        want = j_combine([b[1][i] for b in blocks])
        for res in ranks:
            got = res["records"][i]
            assert set(got) == set(want)
            for t in want:
                ints = [k for k, v in want[t].items() if v.dtype.kind in "iu"]
                assert ints and set(got[t]) == set(want[t]), t
                apart = []
                for k in ints:
                    assert got[t][k].dtype == want[t][k].dtype, (t, k)
                    if not np.array_equal(got[t][k], want[t][k]):
                        apart.append(k)
                if apart:
                    assert "a_smp" in apart and set(apart) <= errs | {"a_smp"}, (i, t, apart)
                    d = np.argwhere(got[t]["a_smp"] != want[t]["a_smp"])
                    gap = got[t]["a_smp"][tuple(d.T)].astype(int) - \
                        want[t]["a_smp"][tuple(d.T)].astype(int)
                    assert (np.abs(gap) == 1).all(), gap
                    if res is ranks[0]:
                        flips += [(i, t, int(r_), int(c_)) for r_, c_ in d]
    assert len(flips) <= 2, flips
    ratios = {}
    for i, t, row, col in flips:
        calls = ranks[0]["records"][i][t]["a_smp"].shape[-2] // 4
        rank, call = divmod(row, calls)
        if rank not in ratios:
            ratios[rank] = _port_ratios(starcoder, toks[RK.block(rank, 4)], monkeypatch)
        codes = serves[4, SC][rank][0]["solo_records"][i][t]["a_smp"][call]
        seen = [r for c, r in ratios[rank] if np.array_equal(c, codes)]
        assert seen, (i, t, row)
        assert abs(abs(seen[0][col] - np.floor(seen[0][col])) - 0.5) < TOL_FLIP, seen[0][col]


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
    replicas = summary["replicas"]
    assert replicas["after"] == [(replicas["version"], 0)] * 2 and replicas["version"] >= 1


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
