"""Roofline analysis of a dry-run cell (``repro.launch.roofline``), with the
NVIDIA H100 SXM's constants.

Hardware constants (H100 SXM5 80 GB, NVIDIA's data sheet, dense rates):

    HBM_BW     3.35e12 B/s   HBM3 memory bandwidth
    INT8_OPS   1979e12 op/s  int8 tensor-core rate (dense; 3958 with sparsity)
    PEAK_FLOPS  989e12 FLOP/s bf16 tensor-core rate (dense; 1979 with sparsity)
    NVLINK_BW   450e9 B/s    NVLink 4 per direction (900 GB/s bidirectional)

compute    term = per-device FLOPs / PEAK_FLOPS
memory     term = per-device bytes accessed / HBM_BW
collective term = per-device collective output bytes / NVLINK_BW

JAX's cell reads XLA's cost analysis and the post-SPMD HLO; the port's dry
run (``launch/dryrun.py``) records rank 0's step on fake tensors: the FLOPs
``torch.utils.flop_counter`` counts, the bytes every op reads and writes,
and the collectives each rank issues, which :func:`collective_bytes` sums
by kind under JAX's keys.  ``MODEL_FLOPS`` (6 N D train, 2 N tokens serve,
:func:`model_flops`) over the FLOPs of all devices is the usefulness ratio.
:func:`param_count` and :func:`model_flops` are JAX's, framework-free.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["HW", "HBM_BW", "INT8_OPS", "PEAK_FLOPS", "NVLINK_BW", "COLLECTIVES",
           "collective_bytes", "roofline_report", "model_flops", "param_count", "Roofline"]

HBM_BW = 3.35e12          # bytes/s, H100 SXM HBM3 (data sheet)
INT8_OPS = 1979e12        # op/s, H100 SXM dense int8 tensor core (data sheet)
PEAK_FLOPS = 989e12       # FLOP/s, H100 SXM dense bf16 tensor core (data sheet)
NVLINK_BW = 450e9         # bytes/s, H100 SXM NVLink 4, one direction (data sheet)

HW = dict(peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW, nvlink_bw=NVLINK_BW, int8_ops=INT8_OPS)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Sum the output bytes of the collectives of a run, given as
    ``(kind, bytes)`` pairs (``launch/dryrun.py`` records them), by kind:
    JAX's keys (``COLLECTIVES``, each present) and ``_total``; a kind JAX
    has no key for keeps its own."""
    out = {k: 0 for k in COLLECTIVES}
    for kind, nbytes in records:
        out[kind] = out.get(kind, 0) + int(nbytes)
    out["_total"] = sum(v for k, v in out.items() if k != "_total")
    return out


def param_count(cfg) -> int:
    """Analytic parameter count (total / active for MoE)."""
    D, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    embed = V * D * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        din = cfg.ssm_expand * D
        per = D * din * 2 + D * (2 * cfg.ssm_state) + D * (din // cfg.ssm_head_dim) + din * D
        return embed + L * per
    hd = cfg.head_dim_
    attn = D * cfg.n_heads * hd + 2 * D * cfg.n_kv_heads * hd + cfg.n_heads * hd * D
    mlp_mult = 3 if cfg.act == "silu" else 2
    total = embed
    active = embed
    for kind in cfg.layer_kinds():
        if kind == "recurrent":
            R = cfg.d_rnn
            t = 2 * D * R + 2 * R * R + R * D
        else:
            t = attn
        if cfg.family == "moe" and kind != "dense_ffn":
            e_all = cfg.n_experts * mlp_mult * D * cfg.moe_d_ff
            e_act = (cfg.top_k + cfg.n_shared_experts) * mlp_mult * D * cfg.moe_d_ff
            total += t + e_all + D * cfg.n_experts
            active += t + e_act
            continue
        ff = mlp_mult * D * cfg.d_ff
        total += t + ff
        active += t + ff
    if cfg.family == "encdec":
        # the encoder's layers (attention + MLP) and the decoder's
        # cross-attention, as JAX approximates them
        total += cfg.n_enc_layers * (attn + mlp_mult * D * cfg.d_ff) + L * attn
        active = total
    return int(total if cfg.family != "moe" else active)


def model_flops(cfg, shape) -> float:
    """6*N*D for train (N_active for MoE), 2*N*tokens for serving."""
    n = param_count(cfg)
    toks = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    if shape.kind == "train":
        return 6.0 * n * toks
    return 2.0 * n * toks


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops: float
    peak_bytes_per_dev: Optional[float] = None

    @property
    def t_compute(self):
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes_per_dev / NVLINK_BW

    @property
    def dominant(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self):
        total = self.flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self):
        """The useful model FLOPs' time at peak over the dominant term's."""
        t_model = self.model_flops / self.chips / PEAK_FLOPS
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_model / t_bound if t_bound else 0.0

    def row(self):
        """JAX's row keys (``hlo_flops_per_dev`` names the per-device FLOPs
        whatever counted them)."""
        return dict(
            arch=self.arch, shape=self.shape, mesh=self.mesh, chips=self.chips,
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, dominant=self.dominant,
            model_flops=self.model_flops, hlo_flops_per_dev=self.flops_per_dev,
            useful_ratio=self.useful_ratio,
            roofline_fraction=self.roofline_fraction,
            peak_bytes_per_dev=self.peak_bytes_per_dev,
        )


def roofline_report(arch, shape, mesh_name, chips, cost, collectives, cfg, shape_cfg,
                    peak_bytes=None) -> Roofline:
    """The :class:`Roofline` of a cell: ``cost`` {"flops", "bytes accessed"}
    per device, ``collectives`` the run's ``(kind, bytes)`` records."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_dev=float(cost.get("flops", 0.0)),
        bytes_per_dev=float(cost.get("bytes accessed", 0.0)),
        coll_bytes_per_dev=float(collective_bytes(collectives)["_total"]),
        model_flops=model_flops(cfg, shape_cfg), peak_bytes_per_dev=peak_bytes,
    )
