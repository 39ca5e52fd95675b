"""Model / shape / parallelism configuration dataclasses (the port's own
copy of ``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "ParallelConfig", "AxPolicy", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class AxPolicy:
    """SWAPPER approximate-matmul policy.

    backend:
      'kernel' — the hand-written CUDA ``ax_matmul`` kernel (any family)
      'emul'   — the plain PyTorch reference (tests)
      'mxu'    — the separable families as one K-stacked int8 product:
                 route T of the CUDA kernel on the card, the limbs and one
                 integer matmul on the CPU (``quant.ax``)
    """

    mult_name: str = "mul8s_trunc0_4"
    swap_operand: str = "A"
    swap_bit: int = 3
    swap_value: int = 0
    swap_enabled: bool = True
    backend: str = "mxu"
    targets: Tuple[str, ...] = ("mlp", "attn_out")

    @property
    def swap(self):
        from repro_torch.core.swapper import SwapConfig

        if not self.swap_enabled:
            return None
        return SwapConfig(self.swap_operand, self.swap_bit, self.swap_value)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    act: str = "silu"           # silu (swiglu) | gelu (plain 2-mat mlp)
    tie_embeddings: bool = False
    local_window: int = 0
    pattern: Tuple[str, ...] = ()
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense: int = 0
    moe_capacity: float = 1.25
    d_rnn: int = 0
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    n_enc_layers: int = 0
    mrope: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    ax: Optional[AxPolicy] = None
    pad_vocab_multiple: int = 1

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return -(-self.vocab // m) * m if m > 1 else self.vocab

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Resolved per-layer kind list of length n_layers."""
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        kinds = []
        if self.first_dense:
            kinds += ["dense_ffn"] * self.first_dense
        period = self.pattern or ("global",)
        i = 0
        while len(kinds) < self.n_layers:
            kinds.append(period[i % len(period)])
            i += 1
        return tuple(kinds[: self.n_layers])


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The JAX package's distribution knobs, with the fields of
    ``repro.configs.base.ParallelConfig``, as the port's one-card train
    step reads them (``train/train_step.py``):

    * ``remat`` — ``'none'``, or ``'layer'`` (``torch.utils.checkpoint``
      around each layer of a train forward); ``'dots'`` has no counterpart
      and raises;
    * ``grad_accum`` — microbatches per step, gradients summed in f32;
    * ``fsdp``, ``seq_shard``, ``ep`` and ``dp_only`` shard the train step
      over a device mesh, ROADMAP queue 1, item 8b: set, the train step
      raises.  The serving mesh's rules read them
      (``launch/sharding.axis_rules``).  Their defaults are the one-card
      values here (the JAX defaults shard);
    * ``grad_compress`` compresses the all-reduce, which one card does not
      run: anything but ``'none'`` raises (the optimizer's own
      ``AdamWConfig.compress`` is ported);
    * ``scan_layers`` is accepted and has no effect: the port runs its
      layers as a list either way.

    JAX's ``donate`` (buffer donation) has no field here: the optimizer
    returns new tensors and donates nothing.
    """

    fsdp: bool = False
    seq_shard: bool = False
    remat: str = "layer"         # 'none' | 'layer' | 'dots'
    grad_accum: int = 1
    grad_compress: str = "none"
    scan_layers: bool = True
    ep: bool = False
    dp_only: bool = False
