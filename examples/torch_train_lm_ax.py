"""Train a ~100M-class LM on the PyTorch port with SWAPPER approximate
matmuls (the ``mxu`` backend: route T of the CUDA kernel on the card), with
checkpoints and supervised restarts (``examples/train_lm_ax.py`` with
``repro_torch``).

    PYTHONPATH=src python examples/torch_train_lm_ax.py [--steps 300] [--device cpu] [--smoke]
"""
import argparse
import dataclasses
import os
import tempfile

import torch

import repro_torch.configs as CFG
import repro_torch.train as T
from repro_torch.configs.base import AxPolicy
from repro_torch.train.optimizer import tree_leaves


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="3 steps of a 2-layer, 64-wide model on 2 x 32 tokens")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary one)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    dev = torch.device(args.device)
    if args.smoke:
        args.steps, args.d_model, args.layers = 3, 64, 2
    batch, seq = (2, 32) if args.smoke else (16, 128)
    base = CFG.reduced(CFG.ARCHS["qwen2-72b"])
    cfg = dataclasses.replace(
        base, name="qwen2-100m-ax", d_model=args.d_model, n_layers=args.layers,
        d_ff=args.d_model * 4, n_heads=8, n_kv_heads=4, head_dim=args.d_model // 8,
        vocab=8192,
        ax=AxPolicy(mult_name="mul8s_trunc0_4", backend="mxu", targets=("mlp",)))
    opt = T.AdamWConfig(lr=1e-3, warmup=20)
    par = CFG.ParallelConfig(remat="none", fsdp=False, seq_shard=False)
    step = T.make_train_step(cfg, par, opt)
    stream = T.SyntheticStream(T.DataConfig(cfg.vocab, seq, batch, seed=0, mode="arith"))

    def make_state():
        state = T.fresh_train_state(cfg, opt, seed=0, device=dev)
        n = sum(t.numel() for t in tree_leaves(state["params"]))
        print(f"params: {n / 1e6:.1f}M, ax={cfg.ax.mult_name} swap={cfg.ax.swap.short()}, "
              f"device {dev}")
        return state

    every = max(1, min(25, args.steps))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = args.ckpt_dir or os.path.join(tmp, "ckpt")
        state, log = T.run_supervised(
            make_state, step, stream, args.steps,
            T.FaultConfig(ckpt_dir=ckpt, ckpt_every=min(100, args.steps)),
            on_step=lambda i, m: (i + 1) % every == 0 and print(
                f"step {i + 1}: loss={float(m['loss']):.4f}"))
    print("done:", log)
    return state, log


if __name__ == "__main__":
    main()
