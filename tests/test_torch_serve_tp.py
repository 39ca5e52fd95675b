"""The model-sharded prefill and decode step (``models.registry.prefill`` and
``decode_step`` with ``par`` under ``set_mesh_ctx`` of a ``("data",
"model")`` mesh), held to the JAX package's own GSPMD prefill and decode:
JAX's ``registry.prefill``/``decode_step`` jitted under ``set_mesh_ctx`` on
a directly built ``Mesh`` of 4 forced host devices, its params placed by
``param_shardings`` and its cache by ``cache_shardings``
(``tests/_torch_jax_serve.py``, two subprocesses), and beside it JAX's
one-device prefill and decode from the same inputs; the port's step in a
spawned ``gloo`` world of 4 ranks (``tests/_torch_serve_tp_ranks.py``),
each rank holding its blocks of JAX's params (``serve_params``).

Reduced configs at 2 layers, f32 compute, a global batch of 8 x 16, a
prefill and 3 teacher-forced decode steps.  Bound: the prefill's and each
step's logits and every gathered cache leaf within ``TOL = 1e-5`` of the
largest reference value; greedy tokens (argmax) equal wherever the
reference's top-2 margin is above twice that.  Where JAX's own sharded run
tips an int8 code against its one-device run, the port is held to the
one-device run: its K-split projection is exact.  Through the SWAPPER
projection (``mxu`` jobs, marked ``one``) the port's one-process run itself
may sit an int8 code away from JAX's one-device run (an f32 last-bit
difference of XLA's fused ops on a rounding boundary, ROADMAP's stated
differences): there the sharded port is held to its one-process run at
``TOL``, and the one-process run to JAX's within ``TOL_FLIP``, the
reference phase's bound of a code flip in reduced qwen2 (``chip_smoke.py``
``REF_CONFIGS``).  Layouts (``("data", "model")``):

* ``qwen2_22``: (2, 2), ``mxu``, JAX's default layout (``fsdp``,
  ``seq_shard``, ``ep``), and ``generate(par=)`` against one process;
* ``qwen2_slots_14``: (1, 4), ``kernel``, a pad-mask prefill, per-slot
  positions and a write mask that drops rows at one step;
* ``gemma3_14``: (1, 4), ``seq_shard``, its window cut to 8 so the ring
  (2 rows a rank) wraps in the prefill and in decode;
* ``ds_22``: deepseek-moe (2, 2), ``seq_shard`` + ``ep`` (the expert
  all-to-all in prefill and decode), ``mxu``, and ``generate(par=)``;
* ``ds_cap_22``: the same on exact projections at the published capacity
  factor 1.25, where the prefill drops choices: per token shard in JAX's
  sharded run and the port's, over the global batch in JAX's one-device run;
* ``rg_22``: recurrentgemma (2, 2), its RG-LRU state whole on every rank;
* ``mamba_14``: mamba2 (1, 4), ``seq_shard``, its SSD state;
* ``vl_14``: qwen2-vl (1, 4), embeds and M-RoPE positions in;
* ``whisper_22``: (2, 2), ``seq_shard``, the cross cache split on its
  frames.

Beside them: ``layers.decode_attention_split`` alone over the 4 ranks
called as the sharded decode step calls it, against JAX's and the port's
``decode_attention`` on the whole cache (plain, and a ring that wraps);
the refusals (``ValueError``) and the meshes that carry no tensor
parallelism.
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
from repro.models.layers import decode_attention as j_decode_attention
from repro_torch import train
from repro_torch.convert import cache_from_jax
from repro_torch.launch.mesh import spawn, tree_paths
from repro_torch.models.layers import decode_attention

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
TOL_FLIP = 5e-2


def _par(**kw):
    """Every flag given, so JAX's and the port's ``ParallelConfig`` (whose
    defaults differ) read the same layout."""
    return dict(dict(fsdp=False, seq_shard=False, ep=False, remat="none"), **kw)


JOBS = [
    {"label": "qwen2_22", "arch": "qwen2-72b", "shape": [2, 2],
     "par": _par(fsdp=True, seq_shard=True, ep=True), "cfg": {"ax": "mxu"}, "one": True},
    {"label": "qwen2_slots_14", "arch": "qwen2-72b", "shape": [1, 4], "par": _par(),
     "cfg": {"ax": "kernel"}, "slots": True},
    {"label": "gemma3_14", "arch": "gemma3-27b", "shape": [1, 4], "par": _par(seq_shard=True),
     "cfg": {"local_window": 8}},
    {"label": "ds_22", "arch": "deepseek-moe-16b", "shape": [2, 2],
     "par": _par(seq_shard=True, ep=True), "cfg": {"ax": "mxu"}, "one": True},
    {"label": "ds_cap_22", "arch": "deepseek-moe-16b", "shape": [2, 2],
     "par": _par(seq_shard=True, ep=True), "cfg": {"moe_capacity": 1.25}, "drops": True},
    {"label": "rg_22", "arch": "recurrentgemma-2b", "shape": [2, 2], "par": _par(fsdp=True)},
    {"label": "mamba_14", "arch": "mamba2-370m", "shape": [1, 4], "par": _par(seq_shard=True)},
    {"label": "vl_14", "arch": "qwen2-vl-72b", "shape": [1, 4],
     "par": _par(fsdp=True, seq_shard=True)},
    {"label": "whisper_22", "arch": "whisper-base", "shape": [2, 2],
     "par": _par(seq_shard=True)},
]
for _j in JOBS:
    _j.update(axes=["data", "model"], B=8, S=16, L=24, steps=3)
# a job whose choices drop has no one-device reference (its capacity is global)
LABELS = [j["label"] for j in JOBS if not j.get("drops")]
# (B, L, KV, H, hd, window, seed); the windowed case is a ring of its window's
# rows, 2 a rank, as gemma3_14's
COMBINE = [(2, 32, 2, 4, 16, 0, 1), (3, 8, 1, 4, 16, 8, 2)]
REFUSALS = {"cache sequence": "does not split over the 4 ranks",
            "prompt under seq_shard": "does not split over 4 model ranks",
            "SSD heads": "does not split over 4 model ranks",
            "fleet mesh": "do not combine",
            "batcher on a fleet mesh": "do not combine",
            "generate as a CUDA graph": "a CUDA graph cannot capture",
            "token_step as a CUDA graph": "a CUDA graph cannot capture",
            "adaptive whisper": "adaptive serving of the encoder-decoder is refused",
            "splice of another layout": "prefill_one(rows=) must be the slot count"}


def _start_jax(jax_root, jobs, tmp, name):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    log = os.path.join(tmp, name)
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_jax_serve.py"),
                                 jax_root, json.dumps(jobs)], env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    return proc, log


@pytest.fixture(scope="module")
def runs():
    """JAX's sharded and one-device runs in two subprocesses (every other
    job each) while a 4-rank world runs the port's jobs as their inputs
    appear, then the combine and the refusals."""
    tmp = tempfile.mkdtemp(prefix="serve_tp_")
    jax_root = os.path.join(tmp, "jax")
    procs = [_start_jax(jax_root, JOBS[i::2], tmp, f"jax{i}.log") for i in (0, 1)]
    try:
        four = spawn(RK.jobs_rank, 4, args=([("serve_rank", (jax_root, JOBS)),
                                             ("combine_rank", (COMBINE,)),
                                             ("refusal_rank", ())],),
                     device="cpu", timeout_s=RK.TIMEOUT, threads=1)
        for proc, log in procs:
            assert proc.wait(timeout=RK.TIMEOUT) == 0, open(log).read()[-3000:]
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
    return dict(jax_root=jax_root, serve=[r[0] for r in four], combine=[r[1] for r in four],
                refusal=[r[2] for r in four])


def _job(label):
    return next(j for j in JOBS if j["label"] == label)


def _port_logits(ranks, job):
    """The global logits of each step from the ranks' rows; the ranks that
    hold the same rows agree bit for bit."""
    out = []
    for i in range(job["steps"] + 1):
        whole = np.full((job["B"],) + ranks[0]["logits"][i].shape[1:], np.nan, np.float32)
        for r in ranks:
            lo, hi = r["rows"]
            if np.isnan(whole[lo]).any():
                whole[lo:hi] = r["logits"][i]
            else:
                assert np.array_equal(whole[lo:hi], r["logits"][i])
        out.append(whole)
    return out


def _port_cache(ranks):
    """{path: the whole leaf} gathered from the ranks' blocks."""
    out = {}
    for path in ranks[0]["cache"]:
        shape = [hi for _, hi in ranks[0]["cache"][path][0]]
        for r in ranks:
            shape = [max(a, hi) for a, (_, hi) in zip(shape, r["cache"][path][0])]
        whole = np.full(shape, np.nan, np.float32)
        for r in ranks:
            idx, blk = r["cache"][path]
            whole[tuple(slice(a, b) for a, b in idx)] = blk
        assert not np.isnan(whole).any(), path
        out[path] = whole
    return out


def _jax(root, label, name):
    d = os.path.join(root, label)
    lg = np.load(os.path.join(d, f"{name}.npz"))
    tree, _ = train.load_tree(os.path.join(d, f"{name}_cache"), 0)
    cfg = RK.config(_job(label)["arch"], _job(label).get("cfg", {}))
    paths, leaves = tree_paths(cache_from_jax(tree, cfg, device="cpu"))
    return ([lg[f"l{i}"] for i in range(len(lg.files))],
            {p: v.float().numpy() for p, v in zip(paths, leaves)})


def _gap(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _hold(port, sharded, one, what):
    """``port`` within ``TOL`` of JAX's sharded value, or, where JAX's
    sharding tipped a code against its one-device run, of the one-device
    value."""
    g = _gap(port, sharded)
    if g <= TOL:
        return
    assert _gap(sharded, one) > TOL and _gap(port, one) <= TOL, \
        (what, g, _gap(sharded, one), _gap(port, one))


def _held(port, sharded, one, port_one, what):
    """``_hold``, or for a job with the port's one-process run ``port_one``:
    the sharded port within ``TOL`` of it, and it within ``TOL_FLIP`` of
    JAX's one-device run (module note)."""
    if port_one is None:
        return _hold(port, sharded, one, what)
    assert _gap(port, port_one) <= TOL, (what, _gap(port, port_one))
    assert _gap(port_one, one) <= TOL_FLIP, (what, _gap(port_one, one))


@pytest.mark.parametrize("label", LABELS)
def test_sharded_prefill_and_decode_equal_jax_gspmd(runs, label):
    """The prefill's and each decode step's logits (the global batch from
    the ranks' rows, whole vocabulary), the cache gathered from the ranks'
    blocks and the greedy tokens, against JAX's sharded run (or its
    one-device run where its sharding tips a code; or, through the SWAPPER
    projection, the port's one-process run: module note)."""
    job = _job(label)
    ranks = [r[label] for r in runs["serve"]]
    port = _port_logits(ranks, job)
    (j_sh, c_sh), (j_one, c_one) = (_jax(runs["jax_root"], label, n) for n in ("sharded",
                                                                              "one"))
    p_one, pc_one = ranks[0].get("one", ([None] * len(port), None))
    inp = np.load(os.path.join(runs["jax_root"], label, "inputs.npz"))
    for i, (p, s, o) in enumerate(zip(port, j_sh, j_one)):
        assert p.shape == s.shape, (i, p.shape, s.shape)
        _held(p, s, o, p_one[i], f"logits {i}")
        if p_one[i] is not None:
            o = p_one[i]                    # the greedy reference
        # the sampled position: the prompt's last (real) token, then the step's
        last = (p[np.arange(job["B"]), inp["lens"] - 1] if i == 0 and job.get("slots")
                else p[:, -1])
        ref = (o[np.arange(job["B"]), inp["lens"] - 1] if i == 0 and job.get("slots")
               else o[:, -1])
        top2 = np.sort(ref, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * TOL * np.abs(ref).max()
        assert np.array_equal(last.argmax(-1)[clear], ref.argmax(-1)[clear]), i
    cache = _port_cache(ranks)
    assert set(cache) == set(c_sh)
    for path, v in cache.items():
        assert v.shape == c_sh[path].shape, path
        _held(v, c_sh[path], c_one[path], pc_one and pc_one[path], path)


def test_moe_capacity_drops_held_to_jax_gspmd(runs):
    """deepseek at capacity 1.25: JAX's sharded prefill, which gives each
    token shard its own capacity, differs from its one-device prefill (the
    drops act), and the port's sharded prefill and decode equal the sharded
    one: logits and the gathered cache within ``TOL``, the greedy tokens
    wherever the top-2 margin is above twice that."""
    job = _job("ds_cap_22")
    ranks = [r["ds_cap_22"] for r in runs["serve"]]
    (j_sh, c_sh), (j_one, _) = (_jax(runs["jax_root"], "ds_cap_22", n) for n in ("sharded",
                                                                                 "one"))
    assert _gap(j_sh[0], j_one[0]) > TOL
    for i, (p, s) in enumerate(zip(_port_logits(ranks, job), j_sh)):
        assert _gap(p, s) <= TOL, (i, _gap(p, s))
        top2 = np.sort(s[:, -1], axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * TOL * np.abs(s[:, -1]).max()
        assert np.array_equal(p[:, -1].argmax(-1)[clear], s[:, -1].argmax(-1)[clear]), i
    for path, v in _port_cache(ranks).items():
        assert _gap(v, c_sh[path]) <= TOL, (path, _gap(v, c_sh[path]))


@pytest.mark.parametrize("label", [j["label"] for j in JOBS if j.get("one")])
def test_sharded_generate_equals_one_process(runs, label):
    """``generate(par=)`` under the mesh gives every rank the global greedy
    tokens, equal to the port's one-process serve of the whole weights."""
    ranks = [r[label] for r in runs["serve"]]
    for r in ranks:
        assert np.array_equal(r["tokens"], ranks[0]["tokens"])
    assert np.array_equal(ranks[0]["tokens"], ranks[0]["one_tokens"]), \
        (ranks[0]["tokens"], ranks[0]["one_tokens"])


@pytest.mark.parametrize("case", range(len(COMBINE)))
def test_decode_combine_equals_decode_attention_on_the_whole_cache(runs, case):
    """The partial-softmax combine over 4 ranks' blocks of the cache's
    sequence, called as the sharded decode step calls it, against JAX's and
    the port's ``decode_attention(window=)`` over the whole cache (f32; a
    ring cache of a windowed layer that wraps, its query at the last row)."""
    B, L, KV, H, hd, window, seed = COMBINE[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    ci = rng.integers(0, 2 * L, B)
    kv_len = np.minimum(ci + 1, L)
    q_pos = np.full_like(ci, L - 1) if window else ci
    want = np.asarray(j_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(q_pos), jnp.asarray(kv_len),
                                         window=window))
    port = decode_attention(*(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_len)),
                            window=window).numpy()
    assert _gap(port, want) <= TOL
    for r in runs["combine"]:
        assert np.array_equal(r[case], runs["combine"][0][case])
        assert _gap(r[case], want) <= TOL


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_model_sharded_refusals(runs, name):
    """A cache sequence or a prompt under ``seq_shard`` that does not split
    over the ranks, SSD heads that do not, the fleet mesh (``generate`` and
    the batcher), a decode step captured as a CUDA graph (``generate``'s
    fused serve, ``token_step``: the card's case, its graph switch forced
    here), adaptive whisper and a splice of a fresh cache of another layout
    under a model-sharded mesh raise ``ValueError`` on every rank."""
    for r in runs["refusal"]:
        assert r[name] is not None and REFUSALS[name] in r[name], (name, r[name])


@pytest.mark.parametrize("name", ["fleet mesh: no tp", "dp_only: no tp", "(2, 2): tp"])
def test_which_meshes_carry_tensor_parallelism(runs, name):
    """``set_mesh_ctx`` of the 1-D ``("data",)`` fleet mesh or of a
    ``dp_only`` layout installs no ``TensorParallel``; a ``("data", "model")``
    mesh of (2, 2) does."""
    assert all(r[name] is True for r in runs["refusal"])
