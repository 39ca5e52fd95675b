"""Fleet-scale adaptive serving of the PyTorch port: N ranks, one global
policy (``examples/fleet_serve.py`` with ``repro_torch``).

    PYTHONPATH=src python examples/torch_fleet_serve.py [--device cpu] [--ranks N]
        [--backend nccl|gloo]

Spawns N ranks (the visible cards by default; ``--device cpu --ranks N``
on the CPU; ``--backend gloo`` lets them share one card) that form a
1-D fleet mesh.  Every rank runs the mesh-sharded continuous batcher over
the same waves of requests and serves its block of the 8 slots; each wave's
telemetry is aggregated over the mesh after every observed step, so each
rank's controller sees the fleet record.  From wave 3 one slot's traffic
(on one shard) drifts to a degenerate token stream; the controllers detect
the diluted fleet shift, re-tune from their gathered operand buffers, and
rank 0 publishes the new policy to a ``PolicyStore``.  A ``PolicyReader``
replica on every rank polls the store after each wave and adopts the same
version: a policy is a value, so no decode program is captured anew.
"""
import argparse
import dataclasses
import tempfile

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.configs as CFG
from repro_torch.configs.base import AxPolicy
from repro_torch.fleet import BatcherConfig, ContinuousBatcher, PolicyReader, PolicyStore, Request
from repro_torch.launch.mesh import spawn
from repro_torch.models import init_params
from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy
from repro_torch.serve import graph as G

N_SLOTS = 8
DRIFT_SLOT = 3
N_WAVES = 7
WARMUP_WAVES = 3        # detector disarmed while the EW telemetry converges
DRIFT_WAVE = 3          # waves >= this route degenerate traffic to one slot
FLEET_THRESHOLD = 0.0023  # ~1/N_SLOTS of a single-host threshold


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks of the fleet mesh (default: the visible cards; 2 on the CPU)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="nccl on the card by default; gloo lets ranks share one card")
    return ap


def rank_main(rank, mesh, device, store_dir):
    """One rank of the fleet; prints on rank 0 only."""
    say = print if rank == 0 else (lambda *a, **k: None)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" \
        else torch.device("cpu")
    n = mesh.size()
    cfg = dataclasses.replace(CFG.reduced(CFG.ARCHS["qwen2-72b"]), n_layers=2,
                              ax=AxPolicy(backend="mxu"))
    params = init_params(cfg, seed=0, device=dev)
    store = PolicyStore(store_dir)
    # disarmed (a huge threshold) during warm-up; then the reference is
    # rebased to the converged snapshot and the detector armed with the
    # fleet threshold: a one-slot anomaly reaches the controller diluted
    # over N_SLOTS slots, so it is ~1/N of a single-host setting
    controller = AdaptiveController(
        SwapPolicy.from_ax_policy(cfg.ax), targets=cfg.ax.targets,
        cfg=AdaptiveConfig(decay=0.12, drift_threshold=10.0, min_observe_steps=2,
                           cooldown_steps=2),
        store=store if rank == 0 else None,
        log_fn=lambda line: say(f"  [controller] {line}"), device=dev)
    if rank == 0:
        controller.resume_from_store()
    dist.barrier()
    controller.warmup()
    replica = PolicyReader(store, cfg.ax.targets, name=f"r{rank}", device=dev)
    say(f"mesh={tuple(mesh.shape)} ranks={n} backend={dist.get_backend()} "
        f"store={store_dir}")
    say(f"start: {controller.policy.describe()}\n")

    bat = ContinuousBatcher(params, cfg,
                            BatcherConfig(n_slots=N_SLOTS, prompt_buckets=(16,),
                                          new_token_bucket=8),
                            adaptive=controller, mesh=mesh)
    rng = np.random.default_rng(0)
    rid = 0
    captures = None
    for wave in range(N_WAVES):
        for slot in range(N_SLOTS):
            if wave >= DRIFT_WAVE and slot == DRIFT_SLOT:
                # the drifted slot: degenerate single-token traffic (an
                # extreme bit-occupancy shift in its quantized activations)
                toks = np.full(16, 7, np.int32)
            else:
                toks = rng.integers(0, cfg.vocab, 16).astype(np.int32)
            bat.submit(Request(rid, toks, max_new=8))
            rid += 1
        shard = DRIFT_SLOT // (N_SLOTS // n)
        say(f"wave {wave}" + (f" <- drift on slot {DRIFT_SLOT} (shard {shard})"
                              if wave >= DRIFT_WAVE else ""))
        bat.step()
        if wave == 0:
            captures = G.captures_by_kind()
        if wave == WARMUP_WAVES - 1:
            controller.rebase_reference(threshold=FLEET_THRESHOLD)
            say(f"  [controller] warm-up done: reference rebased, detector armed at "
                f"{FLEET_THRESHOLD}")
        dist.barrier()        # rank 0's publishes land before the replicas poll
        adopted = [None] * n
        dist.all_gather_object(adopted, (replica.version, replica.policy.describe())
                               if replica.poll() else None)
        for i, a in enumerate(adopted):
            if a is not None:
                say(f"  [replica {i}] adopted policy v{a[0]}: {a[1]}")

    say(f"\n{bat.describe()}")
    say(f"controller: {len(controller.retunes)} re-tune(s), "
        f"store v{store.current_version()}")
    say(f"final: {controller.policy.describe()}")
    finals = [None] * n
    dist.all_gather_object(finals, (replica.version,
                                    replica.policy.configs_equal(controller.policy)))
    for i, (v, same) in enumerate(finals):
        say(f"replica {i}: v{v} configs_equal(writer)={same}")
    new = {k: c - captures.get(k, 0) for k, c in G.captures_by_kind().items()}
    say(f"decode programs captured after the first wave: {sum(new.values())} (none "
        f"anew across waves, drift, re-tunes and adoptions; {device})")
    return len(controller.retunes), store.current_version(), [v for v, _ in finals]


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass --device cpu)")
    n = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 2)
    store_dir = tempfile.mkdtemp(prefix="fleet_policy_")
    return spawn(rank_main, n, args=(args.device, store_dir), device=args.device,
                 backend=args.backend, timeout_s=900,
                 threads=1 if args.device == "cpu" else None)


if __name__ == "__main__":
    main()
