"""The port's dry run (``repro_torch.launch.dryrun``) of a few cells, run as
a subprocess for ``tests/test_torch_dryrun.py`` (each cell makes and
destroys a fake process group, which must not meet a test's own world).

    python tests/_torch_dryrun_cells.py OUT_JSON CELLS_JSON

Writes ``{"rows": [...], "extrapolation": {...}, "meshes": {...}}``: each
cell ``[arch, shape, mesh shape]`` with JAX's default layout and the CLI's
default cost extrapolation; reduced configs' rows with and without the
extrapolation; the production meshes made over fake worlds of 256 and 512
ranks, and a two-axis group made under ``FakeTensorMode``.
"""
import json
import sys

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ParallelConfig
from repro_torch.launch.dryrun import fake_world, run_cell
from repro_torch.launch.mesh import axes_group, make_production_mesh
from repro_torch.launch.sharding import MeshShape

PAR = ParallelConfig(fsdp=True, seq_shard=True, ep=True, remat="layer")
# reduced configs of 4 layers (qwen2, decode) and 3 (mamba2, the train step
# and decode): each period the same ops
REDUCED = {("qwen2-72b", "decode_32k"): dict(n_layers=4, d_model=256, d_ff=512, n_heads=4,
                                             n_kv_heads=2, head_dim=64, vocab=1024),
           ("mamba2-370m", "train_4k"): dict(n_layers=3, d_model=256, vocab=1024,
                                             ssm_state=32, ssm_head_dim=32),
           ("mamba2-370m", "decode_32k"): dict(n_layers=3, d_model=256, vocab=1024,
                                               ssm_state=32, ssm_head_dim=32)}
KEYS = ("hlo_flops_per_dev", "bytes_per_dev", "collectives", "memory", "cost_source")


def _mesh(ms):
    return MeshShape(("data", "model") if len(ms) == 2 else ("pod", "data", "model"),
                     tuple(ms))


def main(out, cells):
    rows = [run_cell(a, s, False, PAR, verbose=False, mesh=_mesh(ms)) for a, s, ms in cells]
    extrap = {}
    for (arch, shape), patch in REDUCED.items():
        extrap[f"{arch}/{shape}"] = {
            mode: {k: r[k] for k in KEYS}
            for mode, r in (("extrapolated", run_cell(arch, shape, False, PAR, verbose=False,
                                                      mesh=_mesh((4, 2)), cfg_patch=patch)),
                            ("full", run_cell(arch, shape, False, PAR, verbose=False,
                                              mesh=_mesh((4, 2)), cfg_patch=patch,
                                              extrapolate=False)))}
    meshes = {}
    for n, multi in ((256, False), (512, True)):
        with fake_world(n):
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            with FakeTensorMode():
                _, index, size = axes_group(mesh, tuple(mesh.mesh_dim_names[:-1]))
            meshes[str(n)] = dict(names=list(mesh.mesh_dim_names), shape=list(mesh.shape),
                                  group=[index, size])
    with open(out, "w") as f:
        json.dump({"rows": rows, "extrapolation": extrap, "meshes": meshes}, f, default=float)


if __name__ == "__main__":
    main(sys.argv[1], json.loads(sys.argv[2]))
