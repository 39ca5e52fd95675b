"""The port's telemetry aggregation (``repro_torch.fleet.collect``) against
the host oracles.

Per-shard records come from the port's ``operand_summary`` and
``tile_summary`` on seeded int8 operands (each held to JAX's summary of the
same operands).  The rule over N simulated shards (``combine_shards``), and
``aggregate_records`` over a real 2-rank ``gloo`` group, equal the port's
``combine_records`` and the JAX package's
``repro.runtime.telemetry.combine_records`` of the same numpy records bit
for bit (field types included).  The 2-rank run has a hard join timeout of
60 s: a hang fails the test.
"""
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as C
import repro.runtime as JR
from repro.runtime.telemetry import combine_records as j_combine
import repro_torch.core as TC
import repro_torch.runtime as TR
from repro_torch.fleet import aggregate_records, combine_shards, make_sharded_summarizer
from repro_torch.fleet import collect
from repro_torch.runtime.telemetry import combine_records as t_combine, records_to_host

SRC = Path(__file__).resolve().parents[1] / "src"
MULT = "mul8s_drum3_4"
TRIPLE = (1, 3, 0)


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8)


def _shard_ops(rank):
    return _int8((6, 64), 100 + rank), _int8((64, 32), 7)


def _shard_records(rank, tile_rows=2):
    """One shard's record tree for one call: the scalar and the tile record."""
    x, w = (torch.from_numpy(a) for a in _shard_ops(rank))
    mult, dyn = TC.get(MULT), torch.tensor(TRIPLE, dtype=torch.int32)
    rec = TR.operand_summary(x, w, mult, dyn)
    trec = TR.tile_summary(x, w, mult, tile_rows, dyn=dyn)
    return {"mlp": {k: v[None] for k, v in rec.items()},
            "mlp@tiles": {k: v[None] for k, v in trec.items()}}


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    for t in want:
        assert set(got[t]) == set(want[t]), t
        for k, v in want[t].items():
            g = np.asarray(got[t][k])
            assert g.dtype == np.asarray(v).dtype, (t, k, g.dtype, np.asarray(v).dtype)
            np.testing.assert_array_equal(g, v, err_msg=f"{t}.{k}")


def test_shard_records_equal_jax():
    x, w = _shard_ops(0)
    j = JR.operand_summary(jnp.asarray(x), jnp.asarray(w), C.get(MULT),
                           jnp.asarray(TRIPLE, jnp.int32))
    t = records_to_host(_shard_records(0))["mlp"]
    _assert_trees_equal({"mlp": {k: v[0] for k, v in t.items()}},
                        {"mlp": {k: np.asarray(v) for k, v in j.items()}})


@pytest.mark.parametrize("n", [1, 2, 3, 8, 32])
def test_combine_shards_equals_combine_records_and_jax(n):
    shards = [_shard_records(r) for r in range(n)]
    host = [records_to_host(s) for s in shards]
    got = records_to_host(combine_shards(shards))
    _assert_trees_equal(got, t_combine(host))
    _assert_trees_equal(got, j_combine(host))
    assert got["mlp"]["a_smp"].shape[0] == n             # one call per shard
    assert got["mlp@tiles"]["tile_a_smp"].shape[-2] == n * TR.TILE_RETUNE_SAMPLE


def test_limb_sums_wrap_as_uint32():
    """Limb sums past 32 bits wrap as the host's uint32 sums do."""
    big = {"mlp": {"err_lo": torch.tensor([0xFFFFFFF0], dtype=torch.int64),
                   "err_max": torch.tensor([5], dtype=torch.int64)}}
    small = {"mlp": {"err_lo": torch.tensor([0x20], dtype=torch.int64),
                     "err_max": torch.tensor([9], dtype=torch.int64)}}
    got = records_to_host(combine_shards([big, small]))
    want = t_combine([records_to_host(big), records_to_host(small)])
    _assert_trees_equal(got, want)
    assert int(got["mlp"]["err_lo"][0]) == 0x10


def test_shard_bound_and_identity():
    assert collect.MAX_SHARDS == 32
    with pytest.raises(ValueError, match="overflow"):
        combine_shards([_shard_records(0)] * 33)
    recs = _shard_records(0)
    assert aggregate_records(recs) is recs                # no group: identity
    assert collect.world_size() == 1
    summarize = make_sharded_summarizer(MULT, tile_rows=0, target="s")
    x, w = (torch.from_numpy(a) for a in _shard_ops(0))
    one = summarize(x, w, torch.tensor(TRIPLE, dtype=torch.int32))
    _assert_trees_equal(records_to_host({"s": one}),
                        records_to_host({"s": _shard_records(0)["mlp"]}))


_RANK = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
import repro_torch.core as TC
import repro_torch.runtime as TR
from repro_torch.fleet import aggregate_records, make_sharded_summarizer
from repro_torch.runtime.telemetry import records_to_host
MULT, TRIPLE = {mult!r}, {triple!r}
{helpers}
rank = int(sys.argv[1])
store = dist.FileStore({store!r}, 2)
dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
agg = records_to_host(aggregate_records(_shard_records(rank), group=dist.group.WORLD))
x, w = (torch.from_numpy(a) for a in _shard_ops(rank))
summ = make_sharded_summarizer(MULT, dist.group.WORLD, target="mlp", tile_rows=2)
tree = records_to_host(summ(x, w, torch.tensor(TRIPLE, dtype=torch.int32)))
dist.destroy_process_group()
out = {{name: {{t: {{k: [v.dtype.str, v.tolist()] for k, v in rec.items()}}
                for t, rec in r.items()}} for name, r in (("agg", agg), ("summ", tree))}}
json.dump(out, open({out!r} + str(rank), "w"))
"""


def test_two_rank_gloo_aggregate_equals_combine_records(tmp_path):
    """A real 2-process ``gloo`` world on a ``FileStore``: both ranks hold
    the oracle's record, through ``aggregate_records`` and through
    ``make_sharded_summarizer``."""
    out = str(tmp_path / "rank")
    helpers = "\n".join(inspect.getsource(f) for f in (_int8, _shard_ops, _shard_records))
    script = _RANK.format(mult=MULT, triple=TRIPLE, helpers=helpers,
                          store=str(tmp_path / "store"), out=out)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    errs, deadline = [], time.monotonic() + 60
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), errs
    want = t_combine([records_to_host(_shard_records(r)) for r in range(2)])
    for r in range(2):
        res = json.load(open(out + str(r)))
        for name in ("agg", "summ"):
            got = {t: {k: np.asarray(v, dtype=np.dtype(dt)) for k, (dt, v) in rec.items()}
                   for t, rec in res[name].items()}
            _assert_trees_equal(got, want)
