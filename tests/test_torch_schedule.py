"""The port's kernel schedule (``repro_torch.kernels.schedule``) against the
JAX package's, on the CPU.

Held equal: the signature keys, the resolution order (explicit > installed
table > defaults) and its ``repro_sched_*`` series, the table's JSON in both
directions (a JAX-written table loads in the port and a port-written one in
JAX, caps and grid order equal; each drops the other's own knobs), and the
two stores over one directory (JAX publishes, the port's reader adopts; the
port publishes, JAX's reader adopts; equal ``schedule_publish`` audit
events; torn ``CURRENT`` and a corrupt newest file degrade).  Then the
port's side: ``plan()``'s overrides (the grid arithmetic, ``atomic``, the
rejections), the deprecated block keywords, and the rule that a table
entry never changes the tile-mode grid, the ``tile_hist`` layout or the
telemetry, nor pads a weight.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as JC
import repro.kernels as JK
from repro import obs as jobs
from repro.kernels.autotune import ScheduleReader as JReader, ScheduleStore as JStore
from repro.kernels.schedule import ScheduleTable as JTable, resolve as jresolve
import repro_torch.kernels as TK
import repro_torch.quant.ax as TQ
from repro_torch import obs as tobs
from repro_torch.configs.base import AxPolicy
from repro_torch.core.multipliers import get
from repro_torch.kernels import schedule as TS
from repro_torch.kernels.ax_matmul import K_STEP, Plan, plan
from repro_torch.kernels.autotune import ScheduleReader, ScheduleStore

AXM = __import__("sys").modules["repro_torch.kernels.ax_matmul"]
MULT = "mul8s_trunc0_4"


@pytest.fixture(autouse=True)
def _clean_tables():
    JK.clear_table()
    TK.clear_table()
    yield
    JK.clear_table()
    TK.clear_table()


def _i8(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))


# ---------------------------------------------------------------------------
# the value, the key, the resolution order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sig", [(4, 8192, 29568, "kernel", MULT, "matmul"),
                                 (128, 29568, 8192, "mxu", MULT, "int_dyn"),
                                 (1, 64, 48, "kernel", "mul8s_drum3_4", "matmul_grid"),
                                 (6016, 512, 2048, "emul", "mul8u_trunc0_4", "int_static")])
def test_sig_key_is_the_jax_string(sig):
    assert TS.sig_key(*sig) == JK.sig_key(*sig)


@pytest.mark.parametrize("bad", [dict(backend="cuda"), dict(grid_order="zigzag"),
                                 dict(bm=0), dict(bk=256), dict(tile=3), dict(slots=16),
                                 dict(tile=0), dict(splits=0)])
def test_bad_schedule_values_raise(bad):
    with pytest.raises(ValueError):
        TK.KernelSchedule(**bad)


def test_schedule_roundtrip_and_labels():
    s = TK.KernelSchedule(bm=32, bn=64, grid_order="nm", backend="mxu", tile=2, splits=5)
    assert TK.KernelSchedule.from_dict(s.to_dict()) == s
    assert hash(s) == hash(dataclasses.replace(s))
    assert s.short() == "mxu:32x64x128/nm/t2/s*/k5"
    assert TK.default_schedule().short() == "kernel:128x128x128/mn/t*/s*/k*"
    assert TK.KernelSchedule(16, 32, 32, "nm") == TK.KernelSchedule(bm=16, bn=32, bk=32,
                                                                     grid_order="nm")


def _lookups(reg):
    m = reg.get("repro_sched_lookups_total")
    return {r: m.value(result=r) for r in ("hit", "miss", "explicit")}


def test_resolution_order_and_counters_match_jax():
    """explicit > installed entry > default, and the same counter moves and
    entries gauge in both packages for the same calls."""
    tt, jt = TS.ScheduleTable(), JTable()
    tt.set(64, 64, 64, "kernel", MULT, TK.KernelSchedule(bm=32, bn=32, bk=32, splits=1))
    jt.set(64, 64, 64, "kernel", MULT, JK.KernelSchedule(bm=32, bn=32, bk=32))
    tt.set(64, 64, 64, "mxu", MULT, TK.KernelSchedule(backend="mxu", tile=1), op="int_dyn")
    jt.set(64, 64, 64, "mxu", MULT, JK.KernelSchedule(backend="mxu"), op="int_dyn")
    t0, j0 = _lookups(tobs.default_registry()), _lookups(jobs.default_registry())
    assert TK.install_table(tt) is None and JK.install_table(jt) is None
    for reg in (tobs.default_registry(), jobs.default_registry()):
        assert reg.get("repro_sched_table_entries").value() == 2
    for args, explicit in [((64, 64, 64, "kernel", MULT), False),
                           ((128, 64, 64, "kernel", MULT), False),
                           ((64, 64, 64, "kernel", MULT, "matmul_grid"), False),
                           ((64, 64, 64, "mxu", MULT, "int_dyn"), False),
                           ((64, 64, 64, "kernel", "mul8s_drum3_4"), False),
                           ((64, 64, 64, "kernel", MULT), True)]:
        t = TS.resolve(*args, override=TK.KernelSchedule(grid_order="nm") if explicit else None)
        j = jresolve(*args, override=JK.KernelSchedule(grid_order="nm") if explicit else None)
        assert (t.bm, t.bn, t.bk, t.grid_order, t.backend) == \
            (j.bm, j.bn, j.bk, j.grid_order, j.backend), args
    t1, j1 = _lookups(tobs.default_registry()), _lookups(jobs.default_registry())
    dt = {k: t1[k] - t0[k] for k in t0}
    assert dt == {k: j1[k] - j0[k] for k in j0} == {"hit": 2, "miss": 3, "explicit": 1}
    assert TS.resolve(64, 64, 64, "kernel", MULT).splits == 1
    assert TS.resolve(128, 64, 64, "mxu", MULT, "int_dyn") == TK.default_schedule("mxu")
    ov = TK.KernelSchedule(grid_order="nm")
    assert TS.resolve(64, 64, 64, "kernel", MULT, override=ov) is ov
    assert TS.resolve_for((2, 32, 64), (64, 64), "kernel", MULT).splits == 1
    assert TK.install_table(None) is tt
    assert tobs.default_registry().get("repro_sched_table_entries").value() == 0


# ---------------------------------------------------------------------------
# tables and stores across the two packages
# ---------------------------------------------------------------------------

def test_jax_table_loads_in_the_port_and_back(tmp_path):
    jt = JTable(meta={"mode": "quick"}, version=3)
    jt.set(128, 128, 128, "kernel", MULT, JK.KernelSchedule(bm=64, k_slab=4, grid_order="nm"))
    jt.set(4, 512, 256, "mxu", MULT, JK.KernelSchedule(backend="mxu", limbs="split",
                                                      noswap_fast=True), op="int_dyn")
    jt.save(str(tmp_path / "j.json"))
    tt = TS.ScheduleTable.load(str(tmp_path / "j.json"))
    assert tt.version == 3 and tt.meta == {"mode": "quick"} and set(tt.entries) == set(jt.entries)
    for key, js in jt.entries.items():
        ts = tt.entries[key]
        assert (ts.bm, ts.bn, ts.bk, ts.grid_order, ts.backend) == \
            (js.bm, js.bn, js.bk, js.grid_order, js.backend)
        assert ts.knobs() == {"tile": None, "slots": None, "splits": None}

    tt2 = TS.ScheduleTable(meta={"device": "NVIDIA H100 80GB HBM3"}, version=7)
    tt2.set(4, 8192, 29568, "kernel", MULT, TK.KernelSchedule(grid_order="nm", tile=1,
                                                              splits=16))
    tt2.set(128, 8192, 8192, "mxu", MULT, TK.KernelSchedule(bm=64, bn=32, backend="mxu",
                                                            tile=4), op="int_static")
    tt2.save(str(tmp_path / "t.json"))
    raw = json.loads((tmp_path / "t.json").read_text())
    assert raw["kind"] == "schedule_table" and set(raw) == {"kind", "version", "meta",
                                                            "entries"}
    back = JTable.load(str(tmp_path / "t.json"))
    assert back.version == 7 and back.meta == tt2.meta
    for key, ts in tt2.entries.items():
        js = back.entries[key]
        assert (js.bm, js.bn, js.bk, js.grid_order, js.backend) == \
            (ts.bm, ts.bn, ts.bk, ts.grid_order, ts.backend)
    assert TS.ScheduleTable.load(str(tmp_path / "t.json")) == tt2
    with pytest.raises(ValueError):
        TS.ScheduleTable.from_dict({"kind": "policy"})


def _event(store):
    ev = tobs.audit_for_store(store).read()[-1]
    return {k: v for k, v in ev.items() if k not in ("seq", "unix_time", "store_version")}


def test_stores_cross_adopt_and_audit_alike(tmp_path):
    """JAX publishes v1 and the port's reader adopts it; the port publishes
    v2 into the same directory and JAX's reader adopts that; the two
    ``schedule_publish`` events carry the same fields."""
    root = str(tmp_path / "store")
    jstore, tstore = JStore(root), ScheduleStore(root)
    jt = JTable(meta={"mode": "quick", "mult": MULT})
    jt.set(64, 64, 64, "kernel", MULT, JK.KernelSchedule(bm=32, grid_order="nm"))
    assert jstore.publish(jt) == 1
    ev_j = _event(tstore)
    tr = ScheduleReader(tstore, name="port")
    assert tr.version == 1 and TK.installed_table() is tr.table
    assert TS.resolve(64, 64, 64, "kernel", MULT).grid_order == "nm"

    tt = TS.ScheduleTable(meta={"mode": "quick", "mult": MULT})
    tt.set(64, 64, 64, "kernel", MULT, TK.KernelSchedule(bm=32, grid_order="mn", splits=1))
    assert tstore.publish(tt) == 2 and tstore.heartbeat_ns() == 2
    assert _event(tstore) == ev_j == {"kind": "schedule_publish", "entries": 1,
                                      "meta": {"mode": "quick", "mult": MULT}}
    evs = jobs.audit_for_store(jstore).read()
    assert [e["kind"] for e in evs] == ["schedule_publish"] * 2
    assert [e["store_version"] for e in evs] == [1, 2]
    jr = JReader(jstore, name="jax")
    assert jr.version == 2 and jresolve(64, 64, 64, "kernel", MULT).bm == 32
    assert jresolve(64, 64, 64, "kernel", MULT).grid_order == "mn"
    assert tr.poll() is True and TS.resolve(64, 64, 64, "kernel", MULT).splits == 1
    assert tr.poll() is False                       # heartbeat fast path
    assert tstore.prune(keep_last=1) == [1] and jstore.versions() == [2]


def test_store_degraded_reads(tmp_path):
    store = ScheduleStore(str(tmp_path / "store"))
    reg = tobs.default_registry()
    errs0 = reg.get("repro_sched_store_read_errors_total").total()
    t = TS.ScheduleTable()
    t.set(64, 64, 64, "kernel", MULT, TK.KernelSchedule(tile=2))
    store.publish(t)
    reader = ScheduleReader(store, name="r0")
    assert reader.version == 1
    # a torn CURRENT: the newest version file stands in
    with open(os.path.join(store.root, "CURRENT"), "w") as f:
        f.write("1x")
    assert store.current_version() == 1 and reader.poll() is False
    # a corrupt newest file: the reader keeps the newest loadable table
    t.set(64, 64, 128, "kernel", MULT, TK.KernelSchedule())
    store2 = ScheduleStore(store.root)
    v2 = store2.publish(t)
    with open(store._path(v2), "w") as f:
        f.write('{"kind": "schedule_tab')
    assert reader.poll() is False and reader.version == 1
    assert reader.table is not None and TS.resolve(64, 64, 64, "kernel", MULT).tile == 2
    assert store.load_newest_loadable()[0] == 1
    assert reg.get("repro_sched_store_read_errors_total").total() > errs0
    # a second writer is refused
    other = ScheduleStore(store.root)
    other.publish(TS.ScheduleTable())
    with pytest.raises(RuntimeError):
        store2.publish(TS.ScheduleTable())


# ---------------------------------------------------------------------------
# plan() overrides
# ---------------------------------------------------------------------------

def _plan_before(route, M, N, K, sms=132):
    """``plan`` as it was before it took overrides."""
    p2 = lambda v: 1 << max(0, (v - 1).bit_length())  # noqa: E731
    if route == "T":
        tile = min(8, p2(-(-M // 16)))
        slots, rows = 8, 16 * tile
        target = (4 if tile <= 2 else 2) * sms
    else:
        slots = 8 if M >= 8 else p2(M)
        tile = min(8, p2(-(-M // 8))) if M >= 8 else 1
        rows = slots * tile
        target = 2 * sms
    steps = -(-K // 64)
    tiles = -(-M // rows) * -(-N // 128)
    splits = max(1, min(steps, -(-target // tiles)))
    splits = -(-steps // -(-steps // splits))
    return Plan(route, tile, slots, splits, splits > 1 or slots < 8)


@pytest.mark.parametrize("route", ["T", "C"])
def test_plan_default_is_unchanged(route):
    for M in (1, 3, 4, 7, 8, 16, 33, 128, 1024, 6016):
        for N, K in ((512, 512), (29568, 8192), (8192, 29568), (48, 96), (51865, 512)):
            for sms in (132, 114):
                assert plan(route, M, N, K, sms) == _plan_before(route, M, N, K, sms)


def test_plan_overrides_grid_and_atomic():
    K = 8192                                       # 128 steps of 64
    assert plan("T", 4, 29568, K, tile=2, splits=1) == Plan("T", 2, 8, 1, False)
    assert plan("T", 128, 29568, K, tile=1, splits=64) == Plan("T", 1, 8, 64, True)
    assert plan("T", 128, 8192, K, slots=8, tile=8, splits=43) == Plan("T", 8, 8, 43, True)
    # a tile override moves plan's own split: 8 x 231 blocks at tile 1 fill
    # the card without one; plan's tile 8 takes 231 x 2
    assert plan("T", 128, 29568, K, tile=1).splits == 1
    assert plan("T", 128, 29568, K).splits == 2
    # route C at 1 slot: 4 rows per thread, 231 blocks, K split in 2
    assert plan("C", 4, 29568, K, slots=1) == Plan("C", 4, 1, 2, True)
    assert plan("C", 64, 512, 512, slots=8, tile=1, splits=1) == Plan("C", 1, 8, 1, False)
    assert plan("C", 64, 512, 512, slots=8, tile=1, splits=2).atomic
    assert plan("C", 64, 512, 512, slots=2, splits=1).atomic        # idle slots split K
    steps = -(-K // K_STEP)
    for s in range(1, steps + 1):
        whole = -(-steps // -(-steps // s))
        if whole == s:
            assert plan("T", 4, 512, K, splits=s).splits == s
        else:
            with pytest.raises(ValueError):
                plan("T", 4, 512, K, splits=s)


@pytest.mark.parametrize("bad", [dict(tile=3), dict(tile=16), dict(slots=0), dict(slots=4),
                                 dict(splits=0), dict(splits=129), dict(splits=3, K=256)])
def test_plan_rejects_bad_overrides(bad):
    K = bad.pop("K", 8192)
    with pytest.raises(ValueError):
        plan("T", 4, 512, K, **bad)


def test_blocks_wrapper_checks_knobs_on_the_cpu_and_ignores_them():
    a, b = _i8((5, 128), 0), _i8((128, 40), 1)
    m = get(MULT)
    want = AXM.ax_matmul_blocks(a, b, m, None, bm=5, bn=40, bk=128)
    got = AXM.ax_matmul_blocks(a, b, m, None, bm=5, bn=40, bk=128, tile=1, splits=2)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        AXM.ax_matmul_blocks(a, b, m, None, bm=5, bn=40, bk=128, splits=3)
    with pytest.raises(ValueError):
        AXM.ax_matmul_grid_blocks(a, b, m, torch.zeros((1, 1, 3), dtype=torch.int32),
                                  bm=5, bn=40, bk=128, slots=2)


# ---------------------------------------------------------------------------
# the dispatch sites
# ---------------------------------------------------------------------------

def test_legacy_keywords_warn_and_match_the_schedule():
    a, b = _i8((64, 64), 10), _i8((64, 64), 11)
    m = get(MULT)
    with pytest.warns(DeprecationWarning):
        legacy = TK.ax_matmul(a, b, m, None, block_m=32, block_n=32, block_k=32, k_slab=4,
                              tile_hist=True)
    sched = TK.KernelSchedule(bm=32, bn=32, bk=32)
    want = TK.ax_matmul(a, b, m, None, schedule=sched, tile_hist=True)
    assert all(torch.equal(x, y) for x, y in zip(legacy, want))
    j = JK.ax_matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), JC.get(MULT), None,
                     schedule=JK.KernelSchedule(bm=32, bn=32, bk=32), tile_hist=True)
    assert all(np.array_equal(np.asarray(x), y.numpy()) for x, y in zip(j, want))
    with pytest.warns(DeprecationWarning):
        TK.ax_matmul_grid(a, b, m, torch.zeros((1, 2, 3), dtype=torch.int32), block_n=32)
    with pytest.raises(ValueError):
        TK.ax_matmul(a, b, m, None, schedule=sched, k_slab=4)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(TQ, name)

    def spy(a, b, *args, **kw):
        calls.append(dict(a=a, b=b, args=args, **kw))
        return real(a, b, *args, **kw)

    monkeypatch.setattr(TQ, name, spy)
    return calls


def test_tile_mode_table_entry_changes_no_grid_hist_or_telemetry(monkeypatch):
    """A ``matmul_grid`` entry with small caps and knobs: the tile-mode
    dispatch keeps the blocks the logical tiles give under the default
    caps, and the output and the kernel's tile statistic are unchanged."""
    a, b = _i8((2, 24, 96), 20), _i8((96, 160), 21)
    pol = AxPolicy(mult_name=MULT, backend="kernel")
    rng = np.random.default_rng(3)
    dyn = torch.from_numpy(np.stack([rng.integers(0, 2, (3, 1)), rng.integers(0, 8, (3, 1)),
                                     rng.integers(0, 3, (3, 1))], -1).astype(np.int32))
    calls = _spy(monkeypatch, "ax_matmul_grid")
    base = TQ.ax_matmul_int_dyn_hist(a, b, pol, dyn)
    plain = TQ.ax_matmul_int_dyn(a, b, pol, dyn)
    t = TS.ScheduleTable()
    t.set(48, 96, 160, "kernel", MULT,
          TK.KernelSchedule(bm=8, bn=32, bk=32, grid_order="nm", tile=1, splits=2),
          op="matmul_grid")
    TK.install_table(t)
    hits0 = _lookups(tobs.default_registry())["hit"]
    tuned = TQ.ax_matmul_int_dyn_hist(a, b, pol, dyn)
    assert _lookups(tobs.default_registry())["hit"] == hits0 + 1
    assert torch.equal(tuned[0], base[0]) and torch.equal(tuned[0], plain)
    assert all(torch.equal(x, y) for x, y in zip(tuned[1], base[1]))
    before, after = calls[0]["schedule"], calls[-1]["schedule"]
    assert (after.bm, after.bn, after.bk) == (before.bm, before.bn, before.bk) == (16, 80, 96)
    assert (after.grid_order, after.tile, after.splits) == ("nm", 1, 2)
    assert torch.equal(calls[-1]["args"][1], calls[0]["args"][1])
    # the scalar grid path keeps the default caps too
    TQ.ax_matmul_int_dyn(a, b, pol, torch.tensor([1, 3, 0], dtype=torch.int32))
    assert (calls[-1]["schedule"].bm, calls[-1]["schedule"].bn) == (48, 128)


def test_static_entry_caps_never_pad_a_weight(monkeypatch):
    """A static entry's caps apply, lowered to divisors of the logical dims:
    the weight reaches the kernel as it is (no copy), the bits unchanged."""
    a, b = _i8((4, 192), 30), _i8((192, 200), 31)
    pol = AxPolicy(mult_name=MULT, backend="kernel")
    calls = _spy(monkeypatch, "ax_matmul")
    want = TQ.ax_matmul_int(a, b, pol)
    t = TS.ScheduleTable()
    t.set(4, 192, 200, "kernel", MULT, TK.KernelSchedule(bm=32, bn=64, bk=64, splits=3),
          op="matmul")
    TK.install_table(t)
    got = TQ.ax_matmul_int(a, b, pol)
    assert torch.equal(got, want)
    s = calls[-1]["schedule"]
    assert (s.bm, s.bn, s.bk, s.splits) == (4, 50, 64, 3)
    assert calls[-1]["b"].data_ptr() == b.data_ptr()
    assert calls[0]["b"].data_ptr() != b.data_ptr()          # the default pads N to 256
