"""The JAX package's dry run (``repro.launch.dryrun.run_cell``) of a few
cells on meshes of 8 forced host devices, run as a subprocess for
``tests/test_torch_dryrun.py``.

    python tests/_torch_jax_dryrun.py OUT_JSON CELLS_JSON

JAX's device count is fixed when it first initialises, so this file sets
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and
``JAX_PLATFORMS=cpu`` and initialises JAX before it imports
``repro.launch.dryrun`` (whose first lines ask for 512 devices).  Each cell
``[arch, shape, mesh shape]`` runs on a directly built ``jax.sharding.Mesh``
(``Auto`` axes; ``jax.make_mesh``'s ``Explicit`` axes fail in this JAX) with
JAX's default ``ParallelConfig`` and its default cost extrapolation (XLA's
cost analysis counts a scanned layer once).  Writes ``{"rows": [...],
"skip": {"arch/shape": reason}}`` for every ``ARCHS`` x ``SHAPES`` pair.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

import json  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

DEVICES = jax.devices()

from jax.sharding import Mesh  # noqa: E402

from repro.configs import ARCHS, SHAPES, ParallelConfig  # noqa: E402
from repro.launch.dryrun import run_cell, skip_reason  # noqa: E402


def main(out, cells):
    assert len(DEVICES) == 8, DEVICES
    rows = []
    for arch, shape, ms in cells:
        axes = ("data", "model") if len(ms) == 2 else ("pod", "data", "model")
        mesh = Mesh(np.array(DEVICES[:int(np.prod(ms))]).reshape(tuple(ms)), axes)
        rows.append(run_cell(arch, shape, False, ParallelConfig(), verbose=False, mesh=mesh))
    skip = {f"{a}/{s}": skip_reason(a, s) for a in ARCHS for s in SHAPES}
    with open(out, "w") as f:
        json.dump({"rows": rows, "skip": skip}, f, default=float)


if __name__ == "__main__":
    main(sys.argv[1], json.loads(sys.argv[2]))
