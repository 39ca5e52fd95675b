"""The train CLI of the port (``repro.launch.train``), on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-72b --smoke \\
        --steps 200 --batch 8 --seq 128 [--ax] [--adaptive] [--ckpt-dir DIR] \\
        [--device cpu]

``--smoke`` trains the reduced config of the same family.  The run is
supervised (``train.fault.run_supervised``): a checkpoint every
``--ckpt-every`` steps, a restart from the newest one on failure, a
straggler count.  ``--ax`` and ``--adaptive`` train through the SWAPPER
projection (``AxPolicy(backend="mxu")``).  With ``--adaptive`` every step
runs under the controller's swap triples and returns its telemetry, which
the controller observes one step late (step i-1's records after step i was
issued); re-tuned policies are published to ``<ckpt_dir>/policy`` (the
fleet ``PolicyStore`` format) and a restarted job resumes the adapted
policy from there.  ``--device`` (default ``cuda``) chooses where it runs.
There is no mesh: the sharded step is ROADMAP queue 1, item 8b.  The
synthetic stream holds tokens only, so the encoder-decoder (whisper-base),
whose batches need frames, exits, as the JAX CLI cannot train it either.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs import ARCHS, ParallelConfig, reduced
from repro_torch.configs.base import AxPolicy
from repro_torch.train import (AdamWConfig, DataConfig, FaultConfig, SyntheticStream,
                               fresh_train_state, make_train_step, run_supervised)
from repro_torch.train.optimizer import tree_leaves


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-72b", help=f"one of {sorted(ARCHS)}")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "layer", "dots"])
    ap.add_argument("--compress", default="none", choices=["none", "bf16"])
    ap.add_argument("--ax", action="store_true", help="SWAPPER approximate matmuls")
    ap.add_argument("--tile-rows", type=int, default=0, metavar="N",
                    help="per-row-tile adaptation granularity for --adaptive "
                         "(0 = scalar configs)")
    ap.add_argument("--adaptive", action="store_true",
                    help="online adaptive SWAPPER (telemetry + drift re-tune)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None) and train; returns
    (state, log, controller or None)."""
    args = _parser().parse_args(argv)
    if args.arch not in ARCHS:
        raise SystemExit(f"--arch {args.arch}: not an architecture of the port; it has "
                         f"{sorted(ARCHS)}")
    if ARCHS[args.arch].family == "encdec":
        raise SystemExit(f"--arch {args.arch}: the synthetic stream has no frames for the "
                         f"encoder-decoder (nor has the JAX CLI's); train it through "
                         f"train.make_train_step with frames in the batch")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass --device cpu)")
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduced(cfg)
    if args.ax or args.adaptive:
        cfg = dataclasses.replace(cfg, ax=AxPolicy(backend="mxu"))
    par = ParallelConfig(remat=args.remat, grad_accum=args.grad_accum)
    if args.adaptive:
        print(f"[adaptive] forcing remat=none (was {args.remat}), grad_accum=1 (was "
              f"{args.grad_accum}): the telemetry records leave the step's own forward")
        par = dataclasses.replace(par, remat="none", grad_accum=1)
    opt = AdamWConfig(lr=args.lr, compress=args.compress)
    stream = SyntheticStream(DataConfig(cfg.vocab, args.seq, args.batch, seed=0, mode="arith"))
    step = make_train_step(cfg, par, opt, adaptive=args.adaptive, tile_rows=args.tile_rows)

    controller = None
    if args.adaptive:
        from repro_torch.fleet import PolicyStore
        from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy
        from repro_torch.runtime.telemetry import finish_host_copy, start_host_copy

        # re-tunes publish versioned policies beside the train checkpoints:
        # a restarted job resumes the adapted policy, not the offline one
        store = PolicyStore(os.path.join(args.ckpt_dir, "policy"))
        controller = AdaptiveController(
            SwapPolicy.from_ax_policy(cfg.ax), targets=cfg.ax.targets,
            cfg=AdaptiveConfig(tile_rows=args.tile_rows),
            log_fn=lambda line: print(f"[adaptive] {line}"), store=store, device=device)
        if controller.resume_from_store():
            print(f"[adaptive] resumed policy v{store.current_version()} from {store.root}")
        controller.warmup()
        pending = [None]      # the one-step-stale observe keeps the device busy

        def step_fn(state, batch):
            state, metrics = step(state, batch, controller.dyn_tree())
            copy = start_host_copy(metrics.pop("ax_telemetry"))
            if pending[0] is not None:
                controller.observe(finish_host_copy(pending[0]))
            pending[0] = copy
            return state, metrics
    else:
        step_fn = step

    def make_state():
        state = fresh_train_state(cfg, opt, seed=0, device=device)
        n = sum(t.numel() for t in tree_leaves(state["params"]))
        print(f"arch={cfg.name} params={n / 1e6:.1f}M ax={'on' if cfg.ax else 'off'} "
              f"device={device}")
        return state

    t0 = time.time()

    def on_step(i, metrics):
        if (i + 1) % args.log_every == 0:
            print(f"step {i + 1}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0) / (i + 1):.3f}s/step)")

    state, log = run_supervised(make_state, step_fn, stream, args.steps,
                                FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
                                on_step=on_step)
    if controller is not None and pending[0] is not None:
        controller.observe(finish_host_copy(pending[0]))      # the last step's records
        print(f"[adaptive] {controller.telemetry.describe()}")
        print(f"[adaptive] re-tunes: {len(controller.retunes)} store "
              f"v{controller.store.current_version()} final {controller.policy.describe()}")
    print(f"done: {log}")
    return state, log, controller


if __name__ == "__main__":
    main()
