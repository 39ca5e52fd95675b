"""The serve CLI of the port (``repro.launch.serve``): batched prefill and
decode, adaptive serving, and the continuous-batching fleet front end.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --ax \\
        [--adaptive] [--fleet 1 --token-granular] [--device cpu]

``--adaptive`` attaches the online adaptive SWAPPER runtime: the decode step
streams operand and error telemetry, a drift detector scores the live
operand distribution against the tuned one, and on drift the controller
re-tunes the swap configs in place, capturing nothing anew.  Under
``--smoke`` a synthetic weight drift is injected mid-generation
(``--drift-at``, :func:`drift_hook`).  ``--tile-rows N`` switches the
runtime to per-row-tile configs and telemetry.

``--fleet 1`` serves through the continuous batcher
(``fleet/scheduler.py``) on one card: variable-length seeded requests in
fixed decode slots, one fused adaptive wave per dispatch or, with
``--token-granular``, one token step per step with mid-flight admission;
re-tunes publish through the versioned ``PolicyStore`` (``--policy-store``)
behind a canary, an SLO engine reads the batcher's latencies, and each
replica's ``PolicyReader`` reports its staleness at the end.
``--eos-id``, ``--arrival-rate`` (a Poisson trace through
``run_arrivals``), ``--async-admission`` and ``--chaos-plan`` (a
``fleet.chaos`` fault plan; the drain survives an injected replica kill)
work as in the JAX package.

``--fleet N`` with N > 1 serves over an N-rank fleet mesh
(``launch/mesh.py``): the CLI spawns the N ranks itself (a ``FileStore``
rendezvous in a temporary directory, ``--world-timeout`` seconds at most),
or, run under ``torchrun``, joins the world of its environment.  Every rank
runs the mesh-sharded batcher over the same seeded requests and serves its
block of the slots; rank 0 writes the policy store, the others' controllers
take the same decisions from the same fleet records, each rank polls its
own ``PolicyReader``, and only rank 0 prints the summary (and runs the
observability exports).  ``--backend`` is ``nccl`` by default on the card;
``gloo`` lets several ranks share one card; ``--device cpu`` runs ``gloo``
ranks on the CPU.

Observability (``repro_torch.obs``): ``--metrics-port`` serves Prometheus
``/metrics`` (``--metrics-hold`` keeps it up after the run), ``--obs-dir``
writes ``trace.json``, ``metrics.prom`` and ``metrics.jsonl`` at exit,
``--statsd`` / ``--statsd-mirror`` and ``--otlp-out`` push the registry at
exit, ``--device-trace DIR`` wraps the run in a ``torch.profiler`` trace;
at exit the histogram bucket coverage is checked.  There is no compile
listener: the port has no XLA.

``--device`` (default ``cuda``) chooses where the model runs; ``cpu`` runs
the plain kernels.  ``--arch`` takes every architecture of
``repro_torch.configs.ARCHS``, with the JAX CLI's prompt: tokens for a
decoder-only model; for whisper-base, the encoder-decoder, seeded normal
frame embeddings ``(batch, prompt_len, d_model)`` in bf16 and 8 seeded
decoder tokens.  Whisper serves statically only: ``--adaptive`` and
``--fleet`` exit, as far as the JAX package cannot do them either (its
adaptive decode fails on whisper, its batcher has no frames).

``--autotune`` runs a quick timed sweep of the kernel schedule
(``kernels/autotune.py``) over the decode projections this config
dispatches, at ``--batch`` rows: (batch, d_model, d_model), (batch,
d_model, d_ff) and (batch, d_ff, d_model) for the config's backend.  It
installs the winners before the first serve and, with
``--schedule-store DIR``, publishes them to a ``ScheduleStore`` for other
replicas.  The sweep launches the kernels already built (a schedule is
run-time ints), and a CUDA graph keeps the launch shapes of its capture.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import AxPolicy
from repro_torch.launch.sharding import current_groups, current_tp
from repro_torch.models import init_params
from repro_torch.serve import ServeConfig, generate

__all__ = ["drift_hook", "main"]


def _tree_map(fn, t):
    if isinstance(t, dict):
        return {k: _tree_map(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree_map(fn, v) for v in t]
    return fn(t)


def drift_hook(at_step: int, scale: float):
    """A ``generate`` param_hook that, at ``at_step`` (once), returns new
    params in which every other row of each weight's *input*
    (second-to-last) axis is multiplied by ``scale``.  Weight quantization
    reduces over exactly that axis, so the alternating pattern inside each
    column shifts the int8 code distribution of the quantized weights; a
    uniform scale would be quantization invariant.  The input params are
    left as they are (the JAX package's ``jax.tree.map`` is functional too),
    so for one step both copies are alive.

    Under a model-sharded mesh context the params are the rank's blocks
    (``launch.parallel.serve_params``) and the rows are marked by their
    index in the whole weight (``MeshGroups.block_starts``), so the result
    is the blocks of the hook's result on the whole weights; a block with
    no noted offsets raises ``ValueError``."""
    done = {"fired": False}

    def perturb(w, groups):
        if w.dim() < 2:
            return w
        starts = None
        if groups is not None:
            starts = groups.block_starts(w)
            if starts is None:
                raise ValueError("drift_hook under a model-sharded mesh needs the rank's "
                                 "blocks from launch.parallel.serve_params")
        row0 = starts[-2] if starts else 0
        mask = ((torch.arange(w.shape[-2], device=w.device) + row0) % 2 == 0)[:, None]
        out = torch.where(mask, w * scale, w)
        if starts is not None:
            groups.note_block(out, starts)
        return out

    def hook(step, params):
        if step != at_step or done["fired"]:
            return params
        done["fired"] = True
        groups = current_groups() if current_tp() is not None else None
        return _tree_map(lambda w: perturb(w, groups), params)

    return hook


@contextlib.contextmanager
def _observability(args):
    """Driver-level observability, all opt-in (module note).  At exit the
    trace and snapshots are written, the exporters pushed, and any
    histogram whose +Inf bucket holds more than 5% of its observations
    warns."""
    enabled = (args.metrics_port is not None or args.obs_dir
               or args.device_trace or args.statsd or args.otlp_out)
    if not enabled:
        yield
        return
    server = (obs.start_metrics_server(args.metrics_port)
              if args.metrics_port is not None else None)
    if server is not None:
        print(f"[obs] serving /metrics on port {server.port}")
    exporters = []
    if args.statsd:
        exporters.append(obs.StatsdExporter.from_spec(
            args.statsd, mirror=args.statsd_mirror))
        print(f"[obs] statsd push -> udp://{args.statsd}"
              + (f" (mirror {args.statsd_mirror})" if args.statsd_mirror else ""))
    if args.otlp_out:
        exporters.append(obs.OtlpJsonExporter(args.otlp_out))
        print(f"[obs] otlp-json push -> {args.otlp_out}")
    rec = None
    if args.obs_dir:
        os.makedirs(args.obs_dir, exist_ok=True)
        rec = obs.TraceRecorder()
        obs.install_recorder(rec)
    dev = (obs.device_trace(args.device_trace, device=args.device) if args.device_trace
           else contextlib.nullcontext())
    try:
        with dev:
            yield
    finally:
        if args.obs_dir:
            obs.install_recorder(None)
            rec.save(os.path.join(args.obs_dir, "trace.json"))
            with open(os.path.join(args.obs_dir, "metrics.prom"), "w") as f:
                f.write(obs.prometheus_text())
            obs.write_snapshot(os.path.join(args.obs_dir, "metrics.jsonl"),
                               run=" ".join(f"{k}={v}" for k, v in sorted(
                                   vars(args).items()) if v))
            print(f"[obs] trace + metrics snapshots written to {args.obs_dir}")
        if exporters:
            n = obs.push_all(exporters)
            print(f"[obs] pushed {n} payload units through {len(exporters)} backend(s)")
            for e in exporters:
                e.close()
        findings = obs.default_registry().check_bucket_coverage()
        if findings:
            print(f"[obs] {len(findings)} histogram series exceeded the "
                  f"+Inf-bucket coverage threshold (see warnings)")
        if server is not None:
            if args.metrics_hold > 0:
                print(f"[obs] holding /metrics open {args.metrics_hold}s")
                time.sleep(args.metrics_hold)
            server.close()


def _run_autotune(args, cfg, device):
    """``--autotune``: tune the decode projections' signatures, install the
    table process-wide before the first serve, and publish it when asked
    (module note)."""
    from repro_torch.kernels import install_table
    from repro_torch.kernels.autotune import ScheduleStore, tune_table

    ax = cfg.ax if cfg.ax is not None else AxPolicy(backend="mxu")
    rows = max(args.batch, 1)
    shapes = {(rows, cfg.d_model, cfg.d_model)}
    if cfg.d_ff:
        shapes.add((rows, cfg.d_model, cfg.d_ff))
        shapes.add((rows, cfg.d_ff, cfg.d_model))
    table, reports = tune_table(sorted(shapes), ax.mult_name, backends=(ax.backend,),
                                quick=True, device=device)
    install_table(table)
    for rep in reports:
        print(f"[autotune] {rep['sig']}: {rep['winner']} "
              f"best={rep['best_us']:.0f}us default={rep['default_us']:.0f}us")
    if args.schedule_store:
        v = ScheduleStore(args.schedule_store).publish(table)
        print(f"[autotune] published schedule table v{v} "
              f"({len(table)} entries) to {args.schedule_store}")
    return table, reports


def _run_fleet(args, cfg, device, mesh=None):
    """The continuous batcher over a policy store (module note); ``mesh``
    shards it over the ranks of a fleet mesh, every rank running this."""
    from repro_torch.fleet import (BatcherConfig, ContinuousBatcher, PolicyReader,
                                   PolicyStore, Request, chaos, poisson_arrivals)
    from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy

    n = args.fleet
    rank = dist.get_rank() if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    harness = None
    if args.chaos_plan:
        plan = chaos.FaultPlan.load(args.chaos_plan)
        harness = chaos.install(plan)
        say(f"[chaos] {plan.describe()}")
    # slots must divide over the ranks: the default rounds 4 up to a multiple
    slots = args.slots or n * max(1, -(-4 // n))
    store = PolicyStore(args.policy_store)
    # guarded rollout: re-tune winners are canaried on a holdout before
    # promotion, and a regressed adoption rolls CURRENT back.  Rank 0 writes
    # the store; every rank's controller takes the same decisions from the
    # same fleet records
    controller = AdaptiveController(
        SwapPolicy.from_ax_policy(cfg.ax), targets=cfg.ax.targets,
        cfg=AdaptiveConfig(min_observe_steps=2, cooldown_steps=2,
                           tile_rows=args.tile_rows, canary=True),
        store=store if rank == 0 else None, log_fn=lambda line: say(f"[fleet] {line}"),
        device=device)
    resumed = controller.resume_from_store() if rank == 0 else False
    if mesh is not None:
        dist.barrier()
        if rank > 0:
            controller.adopt(store.load_current()[1])
    say(f"[fleet] replicas={n} device={device} slots={slots} store={store.root} "
        f"{'resumed v' + str(store.current_version()) if resumed else 'fresh'}"
        + (f" mesh={tuple(mesh.shape)} backend={dist.get_backend()}" if mesh is not None
           else ""))
    controller.warmup()
    # latency SLOs on the batcher's TTFT/e2e stream, QoR guard bands per
    # target; an alerting QoR SLO vetoes canary promotion
    slo = obs.SLOEngine(obs.default_serving_slos(qor_targets=cfg.ax.targets),
                        audit=controller.audit)
    controller.attach_slo(slo)

    params = init_params(cfg, seed=0, device=device)
    bcfg = BatcherConfig(n_slots=slots, prompt_buckets=(args.prompt_len,),
                         new_token_bucket=args.new_tokens, temperature=args.temperature,
                         token_granular=args.token_granular, eos_id=args.eos_id,
                         async_admission=args.async_admission)
    bat = ContinuousBatcher(params, cfg, bcfg, adaptive=controller, mesh=mesh)
    bat.attach_slo(slo)
    # one PolicyReader per replica (one per rank on a mesh): each adopts the
    # policy current at spin-up and reports its staleness until it polls
    names = [f"r{i}" for i in range(n)] if mesh is None else [f"r{rank}"]
    readers = [PolicyReader(store, cfg.ax.targets, tile_rows=args.tile_rows,
                            name=nm, device=device) for nm in names]
    rng = np.random.default_rng(0)
    requests = []
    for rid in range(args.requests):
        L = int(rng.integers(max(args.prompt_len // 2, 1), args.prompt_len + 1))
        requests.append(Request(rid, rng.integers(0, cfg.vocab, L),
                                max_new=int(rng.integers(1, args.new_tokens + 1))))
    source = None
    if args.arrival_rate > 0:
        source = poisson_arrivals(requests, args.arrival_rate, seed=0)
        say(f"[fleet] arrival trace: {len(source)} requests @ "
            f"{args.arrival_rate} req/s (Poisson, seed 0)")
    else:
        for r in requests:
            bat.submit(r)
    t0 = time.time()
    done = []
    while True:                # supervise the drain: an injected replica
        try:                   # kill restarts it (faults fire once per plan)
            done.extend(bat.run_arrivals(source) if source is not None else bat.run())
            break
        except chaos.InjectedFault as e:
            say(f"[chaos] survived injected crash ({e}); resuming drain")
    dt = time.time() - t0
    toks = sum(len(c.tokens) for c in done)
    say(f"[fleet] {bat.describe()}")
    say(f"[fleet] served {len(done)} requests / {toks} tokens in {dt:.2f}s "
        f"(incl. graph captures)")
    ls = bat.latency_summary()
    if "queue_delay_p99" in ls:
        say(f"[fleet] queue delay p50={ls['queue_delay_p50']:.4f}s "
            f"p99={ls['queue_delay_p99']:.4f}s "
            f"ttft p99={ls.get('ttft_p99', float('nan')):.4f}s")
    if bat.stats.get("eos_retired"):
        say(f"[fleet] eos-retired: {bat.stats['eos_retired']}")
    say(f"[fleet] {controller.telemetry.describe()}")
    say(f"[fleet] {bat.qor.describe()}")
    say(f"[fleet] {slo.describe()}")
    say(f"[fleet] re-tunes: {len(controller.retunes)} "
        f"tile re-tunes: {len(controller.tile_retunes)} "
        f"store v{store.current_version()} {controller.policy.describe()}")
    if mesh is not None:
        dist.barrier()         # rank 0's publishes are in before the readers look
    stale = _fleet_views([(r.version, r.staleness()) for r in readers], mesh)
    say("[fleet] replica staleness (versions behind CURRENT): "
        + " ".join(f"r{i}=v{v}+{s}" for i, (v, s) in enumerate(stale)))
    for r in readers:
        try:
            r.poll()
        except chaos.InjectedFault as e:
            say(f"[chaos] reader {r.name} survived injected crash ({e}); re-polling")
            r.poll()
    after = _fleet_views([(r.version, r.staleness()) for r in readers], mesh)
    say(f"[fleet] after poll: staleness={[s for _, s in after]} "
        f"(all replicas adopted v{store.current_version()})")
    if harness is not None:
        say(f"[chaos] {harness.describe()}")
        if controller.rollbacks:
            say(f"[chaos] rollbacks: {controller.rollbacks}")
        chaos.uninstall()
    return bat, done


def _fleet_views(local: list, mesh) -> list:
    """Every replica's (version, staleness), gathered from the ranks of a
    mesh in rank order."""
    if mesh is None:
        return local
    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, local)
    return [v for part in views for v in part]


def _fleet_rank(rank, mesh, args, cfg):
    """One rank of ``--fleet N`` (module note): rank 0 runs the
    observability exports and returns the batcher's stats, describe line
    and completions."""
    device = torch.device("cuda", torch.cuda.current_device()) if args.device != "cpu" \
        else torch.device("cpu")
    if args.autotune:          # each rank tunes its own card; rank 0 reports
        quiet = contextlib.nullcontext() if rank == 0 else \
            contextlib.redirect_stdout(io.StringIO())
        with quiet:
            _run_autotune(args, cfg, device)
    obs_ctx = _observability(args) if rank == 0 else contextlib.nullcontext()
    with obs_ctx:
        bat, done = _run_fleet(args, cfg, device, mesh=mesh)
    return dict(stats=dict(bat.stats), describe=bat.describe()), done


def _serve_fleet_mesh(args, cfg, device):
    """``--fleet N`` for N > 1: join the world of ``torchrun``, or spawn the
    N ranks; returns rank 0's (summary, completions)."""
    from .mesh import default_backend, make_fleet_mesh, spawn

    backend = args.backend or default_backend(device)
    if device.type == "cpu" and backend != "gloo":
        raise SystemExit(f"--backend {backend}: CPU ranks use gloo")
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        mesh = make_fleet_mesh(args.fleet, device=device.type, backend=backend)
        try:
            return _fleet_rank(dist.get_rank(), mesh, args, cfg)
        finally:
            dist.destroy_process_group()
    return spawn(_fleet_rank, args.fleet, args=(args, cfg), device=device.type,
                 backend=backend, timeout_s=args.world_timeout,
                 threads=1 if device.type == "cpu" else None)[0]


def _run_single(args, cfg, device):
    controller = None
    param_hook = None
    if args.adaptive:
        from repro_torch.runtime import AdaptiveConfig, AdaptiveController, SwapPolicy

        policy = SwapPolicy.from_ax_policy(cfg.ax)
        controller = AdaptiveController(
            policy, targets=cfg.ax.targets,
            cfg=AdaptiveConfig(min_observe_steps=2, cooldown_steps=4,
                               tile_rows=args.tile_rows),
            log_fn=lambda line: print(f"[adaptive] {line}"), device=device)
        controller.warmup()
        drift_at = args.drift_at
        if drift_at is None:
            drift_at = args.new_tokens // 3 if args.smoke else -1
        if drift_at >= 0:
            param_hook = drift_hook(drift_at, args.drift_scale)
            print(f"[drift] step {drift_at}: synthetic weight drift (x{args.drift_scale})")
        print(f"[adaptive] {policy.describe()}")

    params = init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        frames = rng.normal(0, 1, (args.batch, args.prompt_len, cfg.d_model))
        prompt = {"frames": torch.from_numpy(frames).to(torch.bfloat16),
                  "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (args.batch, 8)))}
    else:
        prompt = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)))}
    t0 = time.time()
    out = generate(params, prompt, cfg,
                   ServeConfig(max_new_tokens=args.new_tokens, temperature=args.temperature),
                   adaptive=controller, param_hook=param_hook).cpu().numpy()
    dt = time.time() - t0
    toks = out.size
    print(f"arch={cfg.name} generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. graph captures)")
    print(out[:, :16])

    if controller is not None:
        print(f"[adaptive] {controller.telemetry.describe()}")
        print(f"[adaptive] re-tunes: {len(controller.retunes)} "
              f"tile re-tunes: {len(controller.tile_retunes)} "
              f"final {controller.policy.describe()}")
        if args.policy_out:
            controller.policy.save(args.policy_out)
            print(f"[adaptive] policy written to {args.policy_out}")
    return out, controller


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-72b", help=f"one of {sorted(ARCHS)}")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ax", action="store_true")
    ap.add_argument("--adaptive", action="store_true",
                    help="online SWAPPER runtime (telemetry + drift-triggered re-tune)")
    ap.add_argument("--tile-rows", type=int, default=0, metavar="N",
                    help="per-row-tile adaptation granularity (0 = scalar configs; "
                         "N > 0 = N-row-tile config grids + tile telemetry, with "
                         "--adaptive/--fleet)")
    ap.add_argument("--drift-at", type=int, default=None,
                    help="decode step at which to inject synthetic drift "
                         "(default: new_tokens//3 with --adaptive --smoke; -1 disables)")
    ap.add_argument("--drift-scale", type=float, default=0.05)
    ap.add_argument("--policy-out", default=None,
                    help="write the final (possibly re-tuned) SwapPolicy JSON here")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve through the continuous batcher + policy store "
                         "(implies --adaptive) over an N-rank fleet mesh")
    ap.add_argument("--token-granular", action="store_true",
                    help="--fleet: per-slot positions + mid-flight admission")
    ap.add_argument("--eos-id", type=int, default=None, metavar="TOK",
                    help="--fleet: a slot retires the moment it samples TOK")
    ap.add_argument("--arrival-rate", type=float, default=0.0, metavar="RPS",
                    help="--fleet: submit requests as a Poisson arrival trace at RPS "
                         "req/s instead of pre-loading the queue")
    ap.add_argument("--async-admission", action="store_true",
                    help="--fleet --token-granular: launch a freed slot's prefill and "
                         "splice it at the next step boundary")
    ap.add_argument("--slots", type=int, default=0,
                    help="--fleet decode slots (default 4 rounded up to a multiple of N)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="--fleet N > 1: the ranks' backend (nccl on the card by default; "
                         "gloo lets ranks share one card; always gloo on the CPU)")
    ap.add_argument("--world-timeout", type=float, default=900.0, metavar="S",
                    help="--fleet N > 1: kill the spawned ranks after S seconds")
    ap.add_argument("--requests", type=int, default=16,
                    help="--fleet synthetic request count")
    ap.add_argument("--policy-store",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_policy_store"),
                    help="--fleet PolicyStore root directory")
    ap.add_argument("--autotune", action="store_true",
                    help="warm-up: a quick timed kernel-schedule sweep over this config's "
                         "decode shapes, installed before serving (kernels.autotune)")
    ap.add_argument("--schedule-store", default=None, metavar="DIR",
                    help="with --autotune: also publish the tuned table to this "
                         "ScheduleStore directory (replicas adopt it with a "
                         "ScheduleReader)")
    ap.add_argument("--chaos-plan", default=None, metavar="PATH",
                    help="--fleet: install a fleet.chaos FaultPlan JSON")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="P",
                    help="serve Prometheus /metrics on this port for the whole run "
                         "(0 = ephemeral, printed at startup)")
    ap.add_argument("--metrics-hold", type=float, default=0.0, metavar="S",
                    help="keep /metrics up S seconds after serving finishes")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="write Chrome trace + Prometheus/JSONL metric snapshots here "
                         "at exit")
    ap.add_argument("--device-trace", default=None, metavar="DIR",
                    help="wrap the run in a torch.profiler trace (DIR/device_trace.json)")
    ap.add_argument("--statsd", default=None, metavar="HOST:PORT",
                    help="push the metric registry as StatsD UDP datagrams at exit")
    ap.add_argument("--statsd-mirror", default=None, metavar="FILE",
                    help="also append every StatsD line to FILE (requires --statsd)")
    ap.add_argument("--otlp-out", default=None, metavar="PATH|URL",
                    help="push one OTLP-JSON resourceMetrics payload at exit: append "
                         "to PATH (.jsonl) or POST to an http(s):// endpoint")
    return ap


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None) and serve; returns the
    fleet's ``(batcher, completions)`` (for N > 1, rank 0's ``(summary,
    completions)``, the summary holding the batcher's ``stats`` and
    ``describe`` line) or the single serve's ``(tokens, controller)``."""
    args = _parser().parse_args(argv)
    if args.arch not in ARCHS:
        raise SystemExit(f"--arch {args.arch}: not an architecture of the port; it has "
                         f"{sorted(ARCHS)}")
    if ARCHS[args.arch].family == "encdec" and (args.adaptive or args.fleet):
        raise SystemExit(f"--arch {args.arch}: the encoder-decoder serves statically only; "
                         f"--adaptive and --fleet exit, as the JAX package cannot serve it "
                         f"so either (ROADMAP queue 3)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass --device cpu)")
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduced(cfg)
    if args.ax or args.adaptive or args.fleet:
        cfg = dataclasses.replace(cfg, ax=AxPolicy(backend="mxu"))
    if args.autotune and args.fleet <= 1:
        _run_autotune(args, cfg, device)
    if args.fleet > 1:
        return _serve_fleet_mesh(args, cfg, device)
    with _observability(args):
        if args.fleet:
            return _run_fleet(args, cfg, device)
        return _run_single(args, cfg, device)


if __name__ == "__main__":
    main()
