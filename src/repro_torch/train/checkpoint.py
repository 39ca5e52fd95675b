"""Checkpoints in the JAX package's on-disk format (``repro.train.checkpoint``):
atomic, asynchronous on request, and of a state no card holds whole.

A checkpoint of step n is ``step_{n}.npz``, whose entries ``a{i}`` hold the
state's leaves in the sorted order of their '/'-joined tree paths (a dict
key, or a list index as in JAX's sequence keys), and ``step_{n}.json`` with
``step``, ``names`` (those paths), ``extra`` (the caller's: data-pipeline
state, the train step) and ``dtypes``.  Each file is written to a temporary
name and renamed, so a crash mid-save never corrupts the newest checkpoint.
A bfloat16 leaf is stored as its raw 16-bit pattern (numpy has no bfloat16
without ``ml_dtypes``) under the dtype name ``bfloat16``, and read back
from a checkpoint of either package by that name.  The npz is written a
member at a time (:class:`_NpzWriter`) as ``np.savez`` writes it: a stored
``zipfile`` with ``allowZip64``, each member ``force_zip64`` and holding
``np.lib.format.write_array``'s bytes (:func:`_write_npy`).  So a file
written leaf by leaf holds the arrays ``np.savez`` of the whole tree
holds, byte for byte.

``restore`` puts each leaf on ``device``, the card unless the caller says
otherwise (JAX's restore puts it on the default device).  It reads leaf by
leaf, and of a leaf only the rows of its first dim that it keeps: a member
is stored, so its array lies at a fixed offset of the file
(:func:`_member_array`, :func:`_read_block`).

**A sharded state.**  ``save`` and ``restore`` take ``sharding_tree`` (a
tree of ``launch.sharding.PartitionSpec`` shaped like the state; a
``None`` leaf is replicated) and the mesh.  The port is multi-process SPMD,
so a rank holds its block of each leaf as a plain tensor, and ``like``
describes the rank's own state.  ``save`` is then a collective: every rank
walks the leaves in the file's order, and each sharded leaf's distinct
blocks are gathered onto rank 0 alone (``dist.gather`` over the ranks that
hold them, those whose coordinates on the mesh axes the spec leaves out are
rank 0's), which copies each block, through one pinned buffer, into its
place in a host array (``launch.mesh.block_index``) and frees them on the
card before the next leaf; a replicated leaf is rank 0's copy.  Rank 0 writes each leaf as it
comes.  So a rank's card holds at most one whole leaf more than its
blocks, and rank 0's host a few whole leaves, never the state.
``restore`` places each leaf by its spec on the mesh, the elastic restore
onto another mesh: a rank reads its block of a sharded leaf, the whole
leaf of a replicated one.  :class:`AsyncCheckpointer`
gathers on the caller's thread (the collectives run in one order on every
rank), and rank 0 writes on a thread of its own that a queue of
``QUEUE_LEAVES`` leaves feeds.  :func:`gather_state` is the whole state on
every rank, which the tests build their references with.  ``load_tree``
reads a checkpoint as a nested dict of numpy arrays: a JAX train state
read so goes to ``convert.train_state_from_jax``.
"""
from __future__ import annotations

import json
import os
import queue
import struct
import threading
import zipfile
from typing import Optional

import numpy as np
import torch

from repro_torch.launch.mesh import block_index as _block

__all__ = ["save", "restore", "gather_state", "latest_step", "load_tree", "AsyncCheckpointer"]

# leaves waiting for rank 0's writer thread: with the one it writes and the
# one being gathered, rank 0's host holds three
QUEUE_LEAVES = 1
_ABORT = object()        # the gathers failed: the writer drops the temporary file
CHUNK = 64 << 20         # bytes a member is written in, and a block read in


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _leaf_specs(node, spec, prefix, out):
    """{path: (leaf, spec)} of a tree and its spec tree (a ``None`` subtree
    replicates every leaf under it)."""
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        out[prefix] = (node, spec)
        return out
    for k, v in items:
        _leaf_specs(v, None if spec is None else spec[k], f"{prefix}/{k}" if prefix else str(k),
                    out)
    return out


def _to_numpy(x):
    """(numpy array, dtype name) of a leaf; bfloat16 as its 16-bit pattern."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    return x, str(x.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A tensor over ``a`` (read for it, so writable and its own)."""
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _mesh_of(mesh):
    if mesh is not None:
        return mesh
    from repro_torch.launch.sharding import current_mesh

    mesh = current_mesh()
    if mesh is None:
        raise ValueError("sharding_tree given: no mesh given and no mesh context")
    return mesh


def _sharded(spec) -> bool:
    return spec is not None and any(spec)


class _NpzWriter:
    """A checkpoint written a leaf at a time, in sorted path order (module
    note): members ``a0``, ``a1``, ... of the temporary npz, then the rename
    and the manifest (:meth:`close`)."""

    def __init__(self, ckpt_dir: str, step: int):
        os.makedirs(ckpt_dir, exist_ok=True)
        self.dir, self.step = ckpt_dir, step
        self.tmp = os.path.join(ckpt_dir, f".tmp_step_{step}.npz")
        self.zip = zipfile.ZipFile(self.tmp, mode="w", compression=zipfile.ZIP_STORED,
                                   allowZip64=True)
        self.names, self.dtypes = [], {}

    def add(self, name: str, array: np.ndarray, dtype: str) -> None:
        if self.names and name <= self.names[-1]:
            raise ValueError(f"checkpoint leaves out of order: {name!r} after "
                             f"{self.names[-1]!r}")
        with self.zip.open(f"a{len(self.names)}.npy", "w", force_zip64=True) as f:
            _write_npy(f, array)
        self.names.append(name)
        self.dtypes[name] = dtype

    def close(self, extra: Optional[dict]) -> str:
        self.zip.close()
        final = os.path.join(self.dir, f"step_{self.step}.npz")
        os.replace(self.tmp, final)
        manifest = {"step": self.step, "names": self.names, "extra": extra or {},
                    "dtypes": self.dtypes}
        mtmp = os.path.join(self.dir, f".tmp_step_{self.step}.json")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(self.dir, f"step_{self.step}.json"))
        return final


def _write_npy(f, array: np.ndarray) -> None:
    """``np.lib.format.write_array(f, array)``'s bytes (the same header,
    then the elements in C order), written from the array's own memory in
    ``CHUNK`` pieces, where ``write_array`` copies each piece first."""
    array = np.asarray(array)
    if not array.flags.c_contiguous:
        array = array.copy(order="C")
    header = np.lib.format.header_data_from_array_1_0(array)
    try:
        np.lib.format.write_array_header_1_0(f, header)
    except ValueError:               # a header too long for format 1.0, as write_array does
        np.lib.format.write_array_header_2_0(f, header)
    data = memoryview(array.reshape(-1).view(np.uint8))
    for i in range(0, len(data), CHUNK):
        f.write(data[i:i + CHUNK])


def _write(ckpt_dir: str, step: int, flat: dict, extra: Optional[dict]) -> str:
    """Write {path: (array, dtype name)} atomically (module note)."""
    writer = _NpzWriter(ckpt_dir, step)
    try:
        for k in sorted(flat):
            writer.add(k, *flat[k])
    except BaseException:
        writer.zip.close()
        raise
    return writer.close(extra)


def _whole_on_rank0(x: torch.Tensor, spec, mesh, stage: Optional[torch.Tensor] = None):
    """The whole leaf of the blocks ``x`` under ``spec`` as (host array,
    dtype name) on rank 0, None on the other ranks: the distinct blocks
    gathered onto rank 0 over the ranks whose coordinates off the spec's
    mesh axes are rank 0's, each copied into its place on the host
    (through ``stage``, pinned host bytes for a block on the card), the
    gathered blocks freed before it returns.  A collective of the world
    (every rank calls it, in one order)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import axes_group

    names = list(mesh.mesh_dim_names)
    axes, shape = [], list(x.shape)
    for d, ax in enumerate(spec):
        dim_axes = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        axes += dim_axes
        for a in dim_axes:
            shape[d] *= mesh.size(names.index(a))
    group, _, n = axes_group(mesh, tuple(axes))
    ranks = dist.get_process_group_ranks(group)
    if 0 not in ranks:
        return None
    x = x.contiguous()
    if dist.get_rank() != 0:
        dist.gather(x, dst=0, group=group)
        return None
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.gather(x, gather_list=parts, dst=0, group=group)
    host = torch.empty(shape, dtype=x.dtype)
    for r, part in zip(ranks, parts):
        if stage is not None:
            part = stage[:part.numel() * part.element_size()].view(part.dtype) \
                .view(part.shape).copy_(part)
        host[_block(mesh, spec, tuple(shape), rank=r)].copy_(part)
    del parts
    return _to_numpy(host)


def _rank0_leaves(state, sharding_tree, mesh):
    """Yield (path, array, dtype name) of every leaf of the sharded
    ``state``, whole, in the file's order on rank 0; the other ranks yield
    nothing and take part in the gathers (:func:`_whole_on_rank0`)."""
    import torch.distributed as dist

    flat = _leaf_specs(state, sharding_tree, "", {})
    root = dist.get_rank() == 0
    blocks = [x for x, spec in flat.values() if _sharded(spec) and x.is_cuda]
    # rank 0 copies each gathered block off the card through one pinned buffer
    stage = torch.empty(max(x.numel() * x.element_size() for x in blocks), dtype=torch.uint8,
                        pin_memory=True) if root and blocks else None
    for path in sorted(flat):
        leaf, spec = flat[path]
        if _sharded(spec):
            got = _whole_on_rank0(leaf, spec, mesh, stage)
        else:
            got = _to_numpy(leaf) if root else None
        if got is not None:
            yield (path,) + got


def save(ckpt_dir: str, step: int, state, extra: Optional[dict] = None, sharding_tree=None,
         mesh=None) -> str:
    """Write ``state`` (nested dicts and lists of tensors or arrays) as the
    checkpoint of ``step``; returns the ``.npz`` path.  With
    ``sharding_tree`` (module note) ``state`` holds the rank's blocks on
    ``mesh`` (the mesh context's when None): every rank calls it, and rank
    0 writes the file of the whole state, a leaf at a time."""
    if sharding_tree is None:
        return _write(ckpt_dir, step, {k: _to_numpy(v) for k, v in _flatten(state).items()},
                      extra)
    import torch.distributed as dist

    mesh = _mesh_of(mesh)
    writer = _NpzWriter(ckpt_dir, step) if dist.get_rank() == 0 else None
    try:
        for path, array, dtype in _rank0_leaves(state, sharding_tree, mesh):
            writer.add(path, array, dtype)
    except BaseException:
        if writer is not None:
            writer.zip.close()
        raise
    if writer is None:
        return os.path.join(ckpt_dir, f"step_{step}.npz")
    return writer.close(extra)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(fn[len("step_"):-len(".json")]) for fn in os.listdir(ckpt_dir)
             if fn.startswith("step_") and fn.endswith(".json")]
    return max(steps) if steps else None


def _load(ckpt_dir: str, step: int):
    with open(os.path.join(ckpt_dir, f"step_{step}.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(ckpt_dir, f"step_{step}.npz")) as data:
        flat = {k: data[f"a{i}"] for i, k in enumerate(manifest["names"])}
    return flat, manifest


def load_tree(ckpt_dir: str, step: int):
    """(nested dict of numpy arrays keyed by the path parts, extra); a
    bfloat16 leaf comes back as its 16-bit pattern, a ``uint16`` array."""
    flat, manifest = _load(ckpt_dir, step)
    tree = {}
    for path, a in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        if manifest["dtypes"].get(path) == "bfloat16":
            a = np.ascontiguousarray(a).view(np.uint16)
        node[leaf] = a
    return tree, manifest["extra"]


def _member_array(zf: zipfile.ZipFile, fd: int, name: str):
    """(dtype, shape, offset in the file) of the array of the stored npz
    member ``name``: its local header read for where the member's bytes
    begin, then its ``.npy`` header."""
    info = zf.getinfo(name)
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{name}: a compressed member (np.savez_compressed); a checkpoint's "
                         f"members are stored")
    head = os.pread(fd, 30, info.header_offset)
    if len(head) != 30 or head[:4] != b"PK\x03\x04":
        raise ValueError(f"{name}: no zip local header at {info.header_offset}")
    n_name, n_extra = struct.unpack("<HH", head[26:30])
    start = info.header_offset + 30 + n_name + n_extra
    with os.fdopen(os.dup(fd), "rb") as f:
        f.seek(start)
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:
            raise ValueError(f"{name}: .npy format {version}")
        offset = f.tell()
    if fortran:
        raise ValueError(f"{name}: a Fortran-order array")
    if offset + int(np.prod(shape)) * dtype.itemsize > start + info.file_size:
        raise ValueError(f"{name}: the array runs past its member")
    return dtype, tuple(shape), offset


def _pread_into(fd: int, buf: memoryview, pos: int) -> None:
    while len(buf):
        n = os.preadv(fd, [buf], pos)
        if n <= 0:
            raise EOFError(f"checkpoint ends at byte {pos}")
        buf, pos = buf[n:], pos + n


def _read_block(fd: int, offset: int, dtype, shape, index=None) -> np.ndarray:
    """The block ``index`` (slices; the whole array when None) of the
    C-order array of ``dtype`` and ``shape`` at ``offset`` of the file
    ``fd``.  The block's rows of dim 0 lie together in the file: a block
    that cuts dim 0 alone is read straight into place, any other in pieces
    of whole rows of about ``CHUNK`` bytes, each piece's part of the block
    kept (a few large reads, where one read a cut row would be many small
    ones)."""
    index = tuple(index or ()) + (slice(None),) * (len(shape) - len(index or ()))
    bounds = [s.indices(n)[:2] for s, n in zip(index, shape)]
    out = np.empty(tuple(hi - lo for lo, hi in bounds), dtype)
    if not shape:
        _pread_into(fd, memoryview(out.reshape(1).view(np.uint8)), offset)
        return out
    row = dtype.itemsize * int(np.prod(shape[1:]))      # the bytes of a row of dim 0
    lo, hi = bounds[0]
    if not out.size or all(b == (0, n) for b, n in zip(bounds[1:], shape[1:])):
        _pread_into(fd, memoryview(out.reshape(-1).view(np.uint8)), offset + lo * row)
        return out
    rest = (slice(None),) + tuple(slice(a, b) for a, b in bounds[1:])
    step = max(1, CHUNK // row)
    piece = np.empty((min(step, hi - lo),) + tuple(shape[1:]), dtype)
    for r in range(lo, hi, step):
        n = min(step, hi - r)
        _pread_into(fd, memoryview(piece[:n].reshape(-1).view(np.uint8)), offset + r * row)
        out[r - lo:r - lo + n] = piece[:n][rest]
    return out


def restore(ckpt_dir: str, step: int, like, device="cuda", sharding_tree=None, mesh=None):
    """Restore into the structure of ``like`` (nested dicts and lists of
    tensors or anything with a ``shape``), each leaf on ``device``, read a
    leaf at a time.  ``sharding_tree`` (shaped like ``like``; a ``None``
    leaf is replicated) places each leaf by its spec on ``mesh``, the mesh
    context's when None (module note): ``like`` then holds the rank's block
    shapes, and a rank reads only its blocks.  Returns (state, extra)."""
    with open(os.path.join(ckpt_dir, f"step_{step}.json")) as f:
        manifest = json.load(f)
    where = {k: f"a{i}.npy" for i, k in enumerate(manifest["names"])}
    dtypes = manifest["dtypes"]
    if sharding_tree is not None:
        mesh = _mesh_of(mesh)
    flat = _leaf_specs(like, sharding_tree, "", {})
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    got = {}
    with zipfile.ZipFile(path) as zf:
        fd = os.open(path, os.O_RDONLY)
        try:
            for p, (node, spec) in flat.items():
                if p not in where:
                    raise KeyError(f"checkpoint step {step} in {ckpt_dir} has no leaf {p!r}")
                dtype, shape, offset = _member_array(zf, fd, where[p])
                index = _block(mesh, spec, shape) if _sharded(spec) else None
                a = _read_block(fd, offset, dtype, shape, index)
                if tuple(a.shape) != tuple(node.shape):
                    raise ValueError(f"{p}: checkpoint block {tuple(a.shape)} of {shape}, "
                                     f"expected {tuple(node.shape)}")
                got[p] = _from_numpy(a, dtypes.get(p, str(dtype))).to(device)
                del a
        finally:
            os.close(fd)
    return _unflatten_like(like, got, ""), manifest["extra"]


def _unflatten_like(node, got, prefix):
    if isinstance(node, dict):
        return {k: _unflatten_like(v, got, f"{prefix}/{k}" if prefix else str(k))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_unflatten_like(v, got, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(node)]
    return got[prefix]


def gather_state(state, sharding_tree, mesh):
    """The whole state on every rank from each rank's blocks (the inverse
    of ``restore(sharding_tree=)``): each sharded dim all-gathered over its
    mesh axes (several axes as one group, row-major,
    ``launch.mesh.axes_group``) and its blocks concatenated in rank
    order."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import axes_group

    def build(node, spec):
        if isinstance(node, dict):
            return {k: build(v, None if spec is None else spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, None if spec is None else spec[i]) for i, v in enumerate(node)]
        if spec is None or not any(spec):
            return node
        for d, ax in enumerate(spec):
            if not ax:
                continue
            group, _, n = axes_group(mesh, ax)
            x = node.contiguous()
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
            node = torch.cat(parts, dim=d)
        return node

    return build(state, sharding_tree)


class AsyncCheckpointer:
    """Background-thread saver.  The whole state is copied to host memory
    before ``save_async`` returns and the files are written on a thread.
    With ``sharding_tree`` every rank calls ``save_async``: the gathers run
    on the caller's thread, and rank 0's thread writes each leaf as it
    comes off a queue of ``QUEUE_LEAVES`` (module note).  ``wait`` joins
    the write and raises what it raised."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _start(self, work):
        def run():
            try:
                work()
            except BaseException as e:       # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def save_async(self, ckpt_dir: str, step: int, state, extra=None, sharding_tree=None,
                   mesh=None):
        self.wait()
        if sharding_tree is None:
            host = {k: (np.array(a, copy=True), d)
                    for k, (a, d) in ((k, _to_numpy(v)) for k, v in _flatten(state).items())}
            self._start(lambda: _write(ckpt_dir, step, host, extra))
            return
        import torch.distributed as dist

        mesh = _mesh_of(mesh)
        if dist.get_rank() != 0:
            for _ in _rank0_leaves(state, sharding_tree, mesh):
                pass
            return
        leaves: queue.Queue = queue.Queue(maxsize=QUEUE_LEAVES)
        writer = _NpzWriter(ckpt_dir, step)

        def work():
            try:
                while (item := leaves.get()) is not None:
                    if item is _ABORT:
                        writer.zip.close()
                        return
                    writer.add(*item)
            except BaseException:
                writer.zip.close()
                while leaves.get() not in (None, _ABORT):   # let the gathers run to their end
                    pass
                raise
            writer.close(extra)

        self._start(work)
        done = False
        try:
            for item in _rank0_leaves(state, sharding_tree, mesh):
                leaves.put(item)
            done = True
        finally:
            leaves.put(None if done else _ABORT)
