"""The port's sharding rules and spec trees (``repro_torch.launch.sharding``,
``launch/mesh.py``, the partition specs of ``fleet/collect.py``) against
the JAX package's, with no world: JAX's functions run on
``jax.sharding.AbstractMesh`` (16, 16) and (2, 16, 16), the port's on the
same shapes (``MeshShape``), for every config of ``configs/`` (whisper
included) and ``dp_only``/``fsdp``/``ep``/``seq_shard`` on and off.

The port keeps its layers as a list where JAX scan-stacks them: port
layer i (``convert.layer_order``) is compared with the JAX leaf it comes
from, whose stacked spec carries a leading layer axis (and whisper's cross
cache its leading (layer, 2) axes).  Shape trees come from
``jax.eval_shape`` and ``init_params(..., device="meta")``: full-size
configs, nothing allocated.
"""
import functools
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as JP

import repro.configs as JC
import repro.fleet.collect as JCOL
import repro.launch.mesh as JM
import repro.launch.sharding as JS
from repro.configs.base import ParallelConfig as JPar
from repro.models import init_cache as j_init_cache, init_params as j_init_params
from repro.models.layers import axes_for_path as j_axes_for_path
import repro_torch.configs as TC
import repro_torch.fleet.collect as TCOL
import repro_torch.launch.mesh as TM
import repro_torch.launch.sharding as TS
from repro_torch.configs.base import ParallelConfig as TPar
from repro_torch.convert import layer_order
from repro_torch.models import init_cache as t_init_cache, init_params as t_init_params
from repro_torch.models.layers import axes_for_path as t_axes_for_path

NAMES = sorted(TC.ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
FLAGS = ("dp_only", "fsdp", "ep")
PARS = [dict(zip(FLAGS, v)) for v in itertools.product((False, True), repeat=3)]


def _meshes(key):
    shape, names = MESHES[key]
    return AbstractMesh(shape, names), TS.MeshShape(names, shape)


def _pars(flags, seq_shard=False):
    return (JPar(seq_shard=seq_shard, **flags),
            TPar(seq_shard=seq_shard, **flags))


def _spec(p):
    """A JAX PartitionSpec or NamedSharding as a plain tuple."""
    p = getattr(p, "spec", p)
    return tuple(p)


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    return jax.eval_shape(lambda k: j_init_params(k, JC.ARCHS[name]), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(name):
    return t_init_params(TC.ARCHS[name], seed=0, device="meta")


def _jax_leaf_index(tree):
    paths, leaves, _ = JM.tree_paths(tree)
    return dict(zip(paths, leaves))


def _param_pairs(name):
    """(port path, JAX path, stacked dims to drop) for every port leaf."""
    cfg = TC.ARCHS[name]
    port = TM.tree_paths(_port_params(name))[0]
    out = []
    if cfg.family == "encdec":
        for p in port:
            head, _, rest = p.partition("/")
            if head in ("layers_enc", "layers_dec"):
                out.append((p, f"{head}/{rest.partition('/')[2]}", 1))
            else:
                out.append((p, p, 0))
        return out
    order = layer_order(cfg)
    for p in port:
        head, _, rest = p.partition("/")
        if head != "layers":
            out.append((p, p, 0))
            continue
        i, _, leaf = rest.partition("/")
        key, k = order[int(i)]
        out.append((p, f"{key}/{leaf}", 0) if k is None else (p, f"layers/{key}/{leaf}", 1))
    return out


def _jax_norm(path):
    """A JAX parameter path as ``repro.launch.mesh.param_shardings`` hands it
    to ``axes_for_path``."""
    if path.startswith(("layers_enc/", "layers_dec/")):
        return "layers/" + path.split("/", 1)[1]
    if path.startswith("layers/"):
        return "layers/" + path.split("/", 2)[2]
    return path


@pytest.mark.parametrize("name", NAMES)
def test_axes_for_path_equals_jax_on_every_leaf(name):
    shapes = dict(zip(*TM.tree_paths(_port_params(name))))
    for port, jpath, drop in _param_pairs(name):
        nd = len(shapes[port].shape)
        want = j_axes_for_path(_jax_norm(jpath), nd + drop)
        assert t_axes_for_path(TM._layer_path(port), nd) == tuple(want[drop:]), (port, jpath)
        assert all(a in ("layers", None) for a in want[:drop])


def test_axis_rules_spec_for_and_param_spec_equal_jax():
    meshes = list(MESHES) + ["fleet"]
    for key, flags, seq in itertools.product(meshes, PARS, (False, True)):
        jm, tm = (_meshes(key) if key != "fleet" else
                  (AbstractMesh((8,), ("data",)), TS.MeshShape(("data",), (8,))))
        jp, tp = _pars(flags, seq)
        jr, tr = JS.axis_rules(jm, jp), TS.axis_rules(tm, tp)
        assert jr == tr, (key, flags, seq)
        for axes in (("batch", "seq", "embed"), ("experts", "embed", "ff"),
                     ("vocab", "embed"), ("layers", "embed", "heads"), ("kv_seq",)):
            assert tuple(TS.spec_for(axes, tr)) == _spec(JS.spec_for(axes, jr))
            if key == "fleet":        # no 'model' axis: JAX's param_spec raises too
                continue
            for shape in ((256, 4096, 8192)[:len(axes)], (1, 24, 100)[:len(axes)]):
                assert tuple(TS.param_spec(axes, tm, tp, shape)) == \
                    _spec(JS.param_spec(axes, jm, jp, shape)), (axes, shape)


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_param_and_state_shardings_equal_jax_for_every_config(name, mesh_key):
    jm, tm = _meshes(mesh_key)
    jshape = _jax_params(name)
    pairs = _param_pairs(name)
    for flags in PARS:
        jp, tp = _pars(flags)
        jspecs = _jax_leaf_index(JM.param_shardings(jm, jp, jshape))
        tspecs = dict(zip(*TM.tree_paths(TM.param_shardings(tm, tp, _port_params(name)))))
        assert len(tspecs) == len(pairs)
        for port, jpath, drop in pairs:
            want = _spec(jspecs[jpath])
            assert tuple(tspecs[port]) == want[drop:], (flags, port, jpath)
            assert all(a is None for a in want[:drop])
    # the train state: moments follow their parameters, the step replicated
    jp, tp = _pars(PARS[-1])
    tstate = {"params": _port_params(name), "opt": {"step": None, "m": None, "v": None,
                                                    "ef": None}}
    jstate = {"params": jshape, "opt": {"step": None, "m": None, "v": None, "ef": None}}
    ts = TM.state_shardings(tm, tp, tstate)
    js = JM.state_shardings(jm, jp, jstate)
    assert tuple(ts["opt"]["step"]) == _spec(js["opt"]["step"]) == ()
    for k in ("m", "v", "ef"):
        assert ts["opt"][k] is ts["params"]


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_batch_shardings_equal_jax(mesh_key):
    jm, tm = _meshes(mesh_key)
    for B in (256, 128, 32, 1):
        batch = {"tokens": (B, 4096), "labels": (B, 4096), "frames": (B, 1500, 512),
                 "pos": (B, 4096, 3), "flag": ()}
        jspec = JM.batch_shardings(jm, {k: jax.ShapeDtypeStruct(v, np.int32)
                                        for k, v in batch.items()})
        tspec = TM.batch_shardings(tm, {k: torch.empty(v, device="meta")
                                        for k, v in batch.items()})
        for k in batch:
            assert tuple(tspec[k]) == _spec(jspec[k]), (B, k)


def _cache_pairs(name, B, S):
    """(port path, JAX path, dims to drop) over the decode caches."""
    cfg = TC.ARCHS[name]
    port = t_init_cache(cfg, B, S, device="meta", enc_len=24)
    ppaths = TM.tree_paths(port)[0]
    out = []
    if cfg.family == "encdec":
        for p in ppaths:
            i, leaf = p.split("/")
            out.append((p, "cross", 2) if leaf in ("xk", "xv") else (p, f"self/{leaf}", 1))
        return port, out
    order = layer_order(cfg)
    for p in ppaths:
        i, leaf = p.split("/")
        key, k = order[int(i)]
        out.append((p, f"{key}/{leaf}", 0) if k is None else (p, f"stack/{key}/{leaf}", 1))
    return port, out


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_cache_shardings_equal_jax_for_every_config(name, mesh_key):
    jm, tm = _meshes(mesh_key)
    cfg_j, cfg_t = JC.ARCHS[name], TC.ARCHS[name]
    for B, S in ((128, 1024), (1, 4096)):          # decode_32k-like, long-context batch 1
        kw = {"enc_len": 24} if cfg_j.family == "encdec" else {}
        jcache = jax.eval_shape(lambda: j_init_cache(cfg_j, B, S, **kw))
        port, pairs = _cache_pairs(name, B, S)
        js = _jax_leaf_index(JM.cache_shardings(jm, JPar(), jcache, cfg_j))
        ts = dict(zip(*TM.tree_paths(TM.cache_shardings(tm, TPar(), port, cfg_t))))
        for p, jpath, drop in pairs:
            want = _spec(js[jpath])
            assert tuple(ts[p]) == want[drop:], (B, p, jpath, want)


def test_cache_pspecs_and_decode_specs_equal_jax():
    name = "qwen2-72b"
    cfg_j, cfg_t = JC.reduced(JC.ARCHS[name]), TC.reduced(TC.ARCHS[name])
    B = 8
    jcache = jax.eval_shape(lambda: j_init_cache(cfg_j, B, 32))
    tcache = t_init_cache(cfg_t, B, 32, device="meta")
    pairs = [(p, f"stack/{k}/{p.split('/')[1]}" if n is not None else
              f"{k}/{p.split('/')[1]}", 1 if n is not None else 0)
             for p in TM.tree_paths(tcache)[0]
             for k, n in [layer_order(cfg_t)[int(p.split("/")[0])]]]
    for n in (1, 2, 4, 8):
        jm, tm = AbstractMesh((n,), ("data",)), TS.MeshShape(("data",), (n,))
        axes = TCOL.batch_axis_names(tm)
        assert axes == JCOL.batch_axis_names(jm) == ("data",)
        jc = _jax_leaf_index(JCOL.cache_pspecs(jcache, B, axes))
        tc = dict(zip(*TM.tree_paths(TCOL.cache_pspecs(tcache, B, axes))))
        for p, jp, drop in pairs:
            assert tuple(tc[p]) == tuple(jc[jp])[drop:]
        for seeded in (False, True):
            for jfn, tfn in ((JCOL.shard_decode_specs, TCOL.shard_decode_specs),
                             (JCOL.token_step_specs, TCOL.token_step_specs)):
                ji, jo, ja = jfn(jcache, B, jm, seeded=seeded)
                ti, to, ta = tfn(tcache, B, tm, seeded=seeded)
                assert ta == ja and len(ti) == len(ji) and len(to) == len(jo)
                for j, t in zip(ji + jo, ti + to):
                    if isinstance(j, JP):
                        assert tuple(t) == tuple(j)
                # the cache's spec tree, and none without a cache
                assert tfn(None, B, tm, seeded=seeded)[0][1] is None
    mesh3 = TS.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert TCOL.batch_axis_names(mesh3) == JCOL.batch_axis_names(
        AbstractMesh((2, 16, 16), ("pod", "data", "model"))) == ("pod", "data")


def test_shard_guards_raise_value_errors():
    """Where JAX asserts: an indivisible batch and more than 32 shards."""
    with pytest.raises(ValueError, match="must divide"):
        TCOL.shard_decode_specs(None, 6, TS.MeshShape(("data",), (4,)))
    with pytest.raises(ValueError, match="overflow"):
        TCOL.token_step_specs(None, 66, TS.MeshShape(("data",), (33,)))
    with pytest.raises(AssertionError):
        JCOL.shard_decode_specs({"k": jax.ShapeDtypeStruct((6,), np.int32)}, 6,
                                AbstractMesh((4,), ("data",)))
    assert TCOL.shard_decode_specs(None, 64, TS.MeshShape(("data",), (32,)))[2] == ("data",)


def test_partition_spec_prints_as_jax_and_shard_is_the_identity():
    spec = TS.PartitionSpec("data", None, ("pod", "data"))
    assert repr(spec) == repr(JP("data", None, ("pod", "data")))
    assert spec == ("data", None, ("pod", "data")) and TS.PartitionSpec() == ()
    x = torch.zeros(2, 3)
    assert TS.shard(x, "batch") is x                 # no context: nothing checked
    assert TS.current_mesh() is None and TS.spec_for(("batch",)) == ()
    tm = TS.MeshShape(("data", "model"), (16, 16))
    with TS.set_mesh_ctx(tm, TPar()) as rules:
        assert TS.current_mesh() is tm and rules["batch"] == "data"
        assert TS.shard(x, "batch", "embed") is x
        assert tuple(TS.spec_for(("batch", "heads"))) == ("data", "model")
        with pytest.raises(ValueError, match="logical axes"):
            TS.shard(x, "batch")
    assert TS.current_mesh() is None


def test_meshes_need_their_worlds():
    assert TM.production_mesh_shape().shape == {"data": 16, "model": 16}
    assert TM.production_mesh_shape(multi_pod=True).size == 512
    assert TS.mesh_shape(AbstractMesh((2, 16, 16), ("pod", "data", "model"))) == \
        TM.production_mesh_shape(multi_pod=True)
    with pytest.raises(ValueError, match="256"):
        TM.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="no world"):
        TM.make_fleet_mesh(2, device="cpu")
