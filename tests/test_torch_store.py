"""The port's policy store and chaos harness (``repro_torch.fleet``) against
the JAX package's (``repro.fleet``).

* the on-disk protocol is shared: a store written by either package
  (versions, a tile grid, a promoted, a rejected and a pending candidate, a
  rollback, a prune) loads in the other, file for file, and the same
  operations write the same bytes;
* the chaos sites, kinds and seeded plans equal JAX's;
* the store-fault cases of the JAX robustness suite (crash-atomic publish,
  torn CURRENT, corrupt policy JSON, pruned CURRENT, candidate lifecycle,
  rollback) and its heartbeat cases hold on the port.
"""
import os

import numpy as np
import pytest

import repro.core as C
import repro.runtime as JR
from repro.fleet import PolicyReader as JReader, PolicyStore as JStore, chaos as jchaos
import repro_torch.core as TC
import repro_torch.runtime as TR
from repro_torch import obs as tobs
from repro_torch.fleet import PolicyReader as TReader, PolicyStore as TStore, chaos as tchaos

PKG = {"t": (TR, TC, TStore, TReader), "j": (JR, C, JStore, JReader)}


def _policy(R, K, cfg=None, mult="mul8u_trunc0_4"):
    return R.SwapPolicy(mult, configs={"*": None if cfg is None else K.SwapConfig(*cfg)})


def _tport(cfg=None):
    return _policy(TR, TC, cfg)


def _reader(store, **kw):
    return TReader(store, ("mlp",), device="cpu", **kw)


def _write_history(pkg, root):
    """Every kind of store file: versions with configs and a tile grid, a
    promoted, a rejected and a pending candidate, a rollback, a prune."""
    R, K, Store, _ = PKG[pkg]
    store = Store(root)
    store.publish(_policy(R, K, ("A", 3, 0)))                       # v1
    p2 = _policy(R, K, ("B", 5, 1))
    p2.set_tile_grid("mlp", np.asarray([[[1, 2, 0]], [[2, 0, 2]]], np.int32))
    p2.meta["note"] = "grid"
    store.publish(p2)                                               # v2
    store.promote(store.publish_candidate(_policy(R, K, ("A", 1, 1))))   # v3
    store.reject_candidate(store.publish_candidate(_policy(R, K, ("A", 7, 0))))  # v4
    store.rollback(2)
    store.publish(_policy(R, K, ("B", 0, 0)))                       # v5
    store.prune(keep_last=3)                                        # drops v1
    store.publish_candidate(_policy(R, K, ("A", 6, 1)))             # v6 pending
    store.rollback(3)
    return store


@pytest.mark.parametrize("writer,reader", [("t", "j"), ("j", "t")])
def test_a_store_loads_in_the_other_package(tmp_path, writer, reader):
    _write_history(writer, str(tmp_path))
    R, _, Store, Reader = PKG[reader]
    store = Store(str(tmp_path))
    assert store.versions() == [2, 3, 5]
    assert store.current_version() == 3 and store.candidate_version() == 6
    assert store.heartbeat_ns() == 3
    for v in store.versions():
        with open(store._path(v)) as f:
            assert store.load(v).to_json() == f.read()
    assert store.load(2).tile_grids["mlp"].tolist() == [[[1, 2, 0]], [[2, 0, 2]]]
    assert store.load(2).meta == {"note": "grid"}
    rd = Reader(store, ("mlp",), tile_rows=2) if reader == "j" else \
        Reader(store, ("mlp",), tile_rows=2, device="cpu")
    assert rd.version == 3 and rd.staleness() == 0
    assert rd.policy.lookup("mlp").short() == "A[1]==1"
    # the reader's writer resumes past every allocated number
    assert store.publish(_policy(R, PKG[reader][1], ("A", 2, 0))) == 7
    assert rd.poll() is True and rd.version == 7


def test_the_same_operations_write_the_same_files(tmp_path):
    for p in ("t", "j"):
        _write_history(p, str(tmp_path / p))
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert names == ["CURRENT", "HEARTBEAT", "policy_v000002.json", "policy_v000003.json",
                     "policy_v000004.json.cand.rejected", "policy_v000005.json",
                     "policy_v000006.json.cand"]
    for n in names:
        with open(tmp_path / "t" / n, "rb") as f, open(tmp_path / "j" / n, "rb") as g:
            assert f.read() == g.read(), n
        assert os.stat(tmp_path / "t" / n).st_mtime_ns == 3 or n != "HEARTBEAT"


def test_chaos_sites_and_plans_equal_jax(tmp_path):
    assert tchaos.SITES == jchaos.SITES
    for seed in (0, 42, 7):
        tp, jp = tchaos.FaultPlan.seeded(seed), jchaos.FaultPlan.seeded(seed)
        assert tp.to_json() == jp.to_json() and tp.describe() == jp.describe()
        assert tchaos.FaultPlan.from_json(jp.to_json()).describe() == jp.describe()
    path = str(tmp_path / "plan.json")
    tchaos.FaultPlan.seeded(42).save(path)
    assert jchaos.FaultPlan.load(path).describe() == jchaos.FaultPlan.seeded(42).describe()
    with pytest.raises(ValueError):
        tchaos.FaultSpec("no.such.site", "torn_current")
    with pytest.raises(ValueError):
        tchaos.FaultSpec("store.publish", "poison_nan")


def test_harness_armed_but_idle_and_firing():
    assert tchaos.fire("store.publish") == []
    plan = tchaos.FaultPlan([tchaos.FaultSpec("reader.poll", "delay_poll", at=1, arg=0.0),
                             tchaos.FaultSpec("reader.poll", "delay_poll", at=2, arg=0.0)])
    with tchaos.active(plan) as h:
        assert tchaos.fire("reader.poll") == []
        assert [f.kind for f in tchaos.fire("reader.poll")] == ["delay_poll"]
        assert len(tchaos.fire("reader.poll")) == 1
        assert h.fired_count("delay_poll") == 2 and h.visits["reader.poll"] == 3
    assert tchaos.current() is None


def test_poison_records_equal_jax():
    rng = np.random.default_rng(0)
    rec = {"mlp": {"bits_a": rng.integers(0, 9, (1, 8)).astype(np.float32),
                   "neg_b": np.zeros(1, np.float32), "err_lo": np.asarray([40], np.uint32),
                   "a_smp": rng.integers(0, 256, (1, 16)).astype(np.int32)}}
    for kinds in (["poison_nan"], ["poison_inf"], ["poison_outlier"], ["poison_nan",
                                                                      "poison_outlier"]):
        t = tchaos.poison_records([tchaos.FaultSpec("controller.observe", k) for k in kinds],
                                  rec)
        j = jchaos.poison_records([jchaos.FaultSpec("controller.observe", k) for k in kinds],
                                  rec)
        for f in rec["mlp"]:
            np.testing.assert_array_equal(t["mlp"][f], j["mlp"][f])
            assert t["mlp"][f].dtype == j["mlp"][f].dtype


# ---------------------------------------------------------------------------
# the JAX robustness suite's store faults, on the port
# ---------------------------------------------------------------------------

def test_publish_kill_mid_write_is_crash_atomic(tmp_path):
    store = TStore(str(tmp_path))
    store.publish(_tport(("A", 3, 0)))
    plan = tchaos.FaultPlan([tchaos.FaultSpec("store.publish", "kill_mid_write", at=0)])
    with tchaos.active(plan):
        with pytest.raises(tchaos.InjectedFault):
            store.publish(_tport(("B", 5, 1)))
    assert store.current_version() == 1 and store.versions() == [1]
    assert any(fn.endswith(".tmp") for fn in os.listdir(str(tmp_path)))
    store2 = TStore(str(tmp_path), recover_stale_s=0.0)
    assert not any(fn.endswith(".tmp") for fn in os.listdir(str(tmp_path)))
    assert store2.publish(_tport(("B", 5, 1))) == 2 and store2.current_version() == 2


def test_publish_kill_before_current_keeps_the_previous_version(tmp_path):
    store = TStore(str(tmp_path))
    store.publish(_tport(("A", 3, 0)))
    reader = _reader(store)
    plan = tchaos.FaultPlan([tchaos.FaultSpec("store.publish", "kill_before_current", at=0)])
    with tchaos.active(plan):
        with pytest.raises(tchaos.InjectedFault):
            store.publish(_tport(("B", 5, 1)))
    # heartbeat 2 > CURRENT 1: the reader takes the full path, adopts nothing
    # new and does not cache the heartbeat
    assert store.current_version() == 1 and store.heartbeat_ns() == 2
    assert reader.poll() is False and reader._hb_seen is None
    assert TStore(str(tmp_path)).publish(_tport(("A", 1, 1))) == 3


def test_publish_torn_current_degrades_to_newest(tmp_path):
    store = TStore(str(tmp_path))
    store.publish(_tport(("A", 3, 0)))
    reader = _reader(store, backoff_s=0.0)
    assert reader.version == 1
    plan = tchaos.FaultPlan([tchaos.FaultSpec("store.publish", "torn_current", at=0)])
    with tchaos.active(plan):
        with pytest.raises(tchaos.InjectedFault):
            store.publish(_tport(("B", 5, 1)))
    assert store.current_version() == 2
    assert reader.poll() is True and reader.version == 2
    assert TStore(str(tmp_path)).publish(_tport(("A", 1, 1))) == 3


def test_corrupt_policy_reader_falls_back_loadable(tmp_path):
    tobs.reset_default_registry()
    store = TStore(str(tmp_path))
    store.publish(_tport(("A", 3, 0)))
    plan = tchaos.FaultPlan([tchaos.FaultSpec("store.after_publish", "corrupt_policy", at=0)])
    with tchaos.active(plan):
        store.publish(_tport(("B", 5, 1)))
    reader = _reader(store, retries=2, backoff_s=0.0)
    assert reader.version == 1 and reader.read_errors >= 1
    assert reader.policy.lookup("mlp") == TC.SwapConfig("A", 3, 0)
    errs = tobs.default_registry().get("repro_store_read_errors")
    assert errs.total() >= 1


def test_reader_survives_pruned_current(tmp_path):
    store = TStore(str(tmp_path))
    for cfg in (("A", 3, 0), ("B", 5, 1), ("A", 1, 1)):
        store.publish(_tport(cfg))
    os.remove(store._path(3))
    reader = _reader(store, retries=2, backoff_s=0.0)
    assert reader.version == 2 and reader.read_errors >= 1
    assert reader.policy.lookup("mlp") == TC.SwapConfig("B", 5, 1)


def test_reader_crash_and_delay_sites(tmp_path):
    store = TStore(str(tmp_path))
    store.publish(_tport(("A", 3, 0)))
    reader = _reader(store)
    plan = tchaos.FaultPlan([tchaos.FaultSpec("reader.poll", "delay_poll", at=0, arg=0.0),
                             tchaos.FaultSpec("reader.poll", "crash_replica", at=1)])
    with tchaos.active(plan) as h:
        assert reader.poll() is False
        with pytest.raises(tchaos.InjectedFault):
            reader.poll()
    assert h.fired_count() == 2


def test_candidate_promote_reject_lifecycle(tmp_path):
    store = TStore(str(tmp_path))
    store.publish(_tport(("A", 3, 0)))
    reader = _reader(store)
    cand = store.publish_candidate(_tport(("B", 5, 1)))
    assert cand == 2 and store.candidate_version() == 2
    assert store.versions() == [1]
    assert reader.poll() is False and reader.version == 1
    assert store.promote(cand) == 2
    assert reader.poll() is True and reader.version == 2
    c2 = store.publish_candidate(_tport(("A", 7, 0)))
    store.reject_candidate(c2)
    assert store.candidate_version() is None
    assert store.publish(_tport(("A", 1, 0))) == c2 + 1
    with pytest.raises(FileNotFoundError):
        store.promote(99)


def test_rollback_repoints_current_and_allocates_past(tmp_path):
    store = TStore(str(tmp_path))
    store.publish(_tport(("A", 3, 0)))
    store.publish(_tport(("B", 5, 1)))
    reader = _reader(store)
    assert reader.version == 2
    assert store.rollback(1) == 1 and store.current_version() == 1
    assert reader.poll() is True and reader.version == 1
    assert reader.policy.lookup("mlp") == TC.SwapConfig("A", 3, 0)
    assert store.versions() == [1, 2]
    assert store.publish(_tport(("A", 1, 1))) == 3
    with pytest.raises(FileNotFoundError):
        store.rollback(99)


def test_single_writer_guard(tmp_path):
    a, b = TStore(str(tmp_path)), TStore(str(tmp_path))
    a.publish(_tport(("A", 3, 0)))
    b.publish(_tport(("B", 5, 1)))
    with pytest.raises(RuntimeError, match="single-writer"):
        a.publish(_tport(("A", 1, 1)))


def test_heartbeat_mtime_is_version_and_polls_fast_path(tmp_path):
    tobs.reset_default_registry()
    store = TStore(str(tmp_path))
    assert store.heartbeat_ns() is None
    for k in range(1, 4):
        store.publish(_tport(("A", k, 0)))
        assert store.heartbeat_ns() == k
    reader = _reader(store)
    polls = tobs.default_registry().get("repro_policy_poll_total")
    before = polls.value(path="heartbeat")
    for _ in range(3):
        assert reader.poll() is False
    assert polls.value(path="heartbeat") - before == 3
    os.remove(os.path.join(str(tmp_path), "HEARTBEAT"))      # a store without one
    assert reader.poll() is False and polls.value(path="full") >= 1
    store.publish(_tport(("B", 2, 1)))
    assert reader.poll() is True and reader.version == 4


def test_staleness_distinguishes_empty_store_from_behind(tmp_path):
    store = TStore(str(tmp_path))
    reader = _reader(store)
    assert reader.staleness() == 0 and reader.policy is None
    with pytest.raises(RuntimeError, match="store is empty"):
        reader.dyn_tree()
    store.publish(_tport(("A", 3, 0)))
    store.publish(_tport(("A", 4, 0)))
    assert reader.staleness() == 2                     # behind every version
    assert reader.poll() is True and reader.staleness() == 0
    store.publish(_tport(("A", 5, 0)))
    assert reader.staleness() == 1


def test_reader_dyn_tree_on_its_device_equals_jax(tmp_path):
    store = TStore(str(tmp_path))
    p = _tport(("A", 3, 0))
    p.set_tile_grid("mlp", np.asarray([[[1, 2, 0]], [[2, 0, 2]]], np.int32))
    store.publish(p)
    for tile_rows in (0, 2):
        t = TReader(store, ("mlp", "attn_out"), tile_rows=tile_rows, device="cpu")
        j = JReader(JStore(str(tmp_path)), ("mlp", "attn_out"), tile_rows=tile_rows)
        tt, jt = t.dyn_tree(), j.dyn_tree()
        assert sorted(tt) == sorted(jt)
        for k in tt:
            assert tt[k].device.type == "cpu"
            np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
        assert t.observe({"mlp": {}}) == []
