"""Serve a small model on the PyTorch port with batched requests: prefill
and decode with a KV cache (``examples/serve_decode.py`` with
``repro_torch``).

    PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu] [--smoke]

The reduced gemma3 (local:global attention) with random weights from a
seed, exact projections, greedy tokens.  On the card the decode step runs
as a CUDA graph.
"""
import argparse

import numpy as np
import torch

import repro_torch.configs as CFG
import repro_torch.models as M
from repro_torch.serve import ServeConfig, generate


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="2 prompts of 16 tokens, 4 new tokens (else 4 x 48, 24)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    dev = torch.device(args.device)
    batch, prompt_len, new = (2, 16, 4) if args.smoke else (4, 48, 24)
    cfg = CFG.reduced(CFG.ARCHS["gemma3-27b"])       # local:global attention family
    params = M.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len)))
    with torch.inference_mode():
        out = generate(params, {"tokens": prompts}, cfg,
                       ServeConfig(max_new_tokens=new, temperature=0.0))
    print(f"arch family: {cfg.family}, pattern: {cfg.pattern}, device: {dev}")
    print("generated token ids:")
    print(out.cpu().numpy())
    return out


if __name__ == "__main__":
    main()
