"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--full] [--device cuda]``.

The port of ``repro.launch.train``: a training loop (the reduced config
by default; ``--full`` for the full one), with periodic asynchronous
checkpoints, exact resume (``--resume`` restores the latest checkpoint
under ``--ckpt-dir`` and the data iterator's position), a straggler
watchdog, and optional int8 error-feedback gradient compression.  Runs
on the CUDA card unless ``--device`` says otherwise.

Meshes: under ``torchrun`` (``WORLD_SIZE`` set) the process group of the
launched ranks is started (NCCL on ``cuda``, gloo on ``cpu``) and the
state is sharded by ``Plan(mesh, fsdp=cfg.fsdp)`` over ``--mesh``:
``host`` (``make_host_mesh``: ``(world / 2, 2)`` over every launched
rank, ``(world, 1)`` for an odd world), ``pod`` (16x16) or ``2pod``
(2x16x16; these two need 256 or 512 ranks and raise otherwise).  One
process with ``--mesh host`` trains unsharded, as a one-rank mesh holds
every tensor whole.  Every rank
draws the same batches and takes its chunk; only rank 0 prints and
writes checkpoints.

Each logged step prints the reference's line (loss, gradient norm,
tokens/s over the steps since the last line) and the card's peak
memory.
``main`` returns ``(state, log)``: the final train state and one dict a
step (``step``, ``loss``, ``grad_norm``, ``ms``: the step's wall time).
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (ensure_process_group, make_host_mesh,
                                     make_production_mesh)
from repro_torch.sharding.plan import Plan, use_plan
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, DataIterator
from repro_torch.train.elastic import StepWatchdog
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: reduced)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "int8_pod"])
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "2pod"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch) if args.full else \
        configs.get_reduced(args.arch)
    if cfg.family == "audio":
        dkind, d_model = "audio", cfg.d_model
    elif cfg.family == "vlm":
        dkind, d_model = "vlm", cfg.d_model
    else:
        dkind, d_model = "lm", 0
    if args.batch % cfg.microbatch:
        cfg = cfg.replace(microbatch=1)

    plan = None
    if "WORLD_SIZE" in os.environ or args.mesh != "host":
        ensure_process_group(device.type)
        if device.type == "cuda":
            device = resolve_device(f"cuda:{torch.cuda.current_device()}")
        world = dist.get_world_size()
        model_ax = 2 if world % 2 == 0 else 1
        mesh = {"host": lambda: make_host_mesh(world // model_ax, model_ax,
                                               device_type=device.type),
                "pod": lambda: make_production_mesh(
                    multi_pod=False, device_type=device.type),
                "2pod": lambda: make_production_mesh(
                    multi_pod=True, device_type=device.type)}[args.mesh]()
        plan = Plan(mesh=mesh, fsdp=cfg.fsdp)
    writer = ckpt.is_writer()
    say = print if writer else (lambda *a, **k: None)

    opt = get_optimizer(cfg.optimizer)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed, kind=dkind,
                    d_model=d_model, n_prefix=cfg.n_prefix)
    it = DataIterator(dc)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(cfg, opt, device=device, generator=gen,
                             plan=plan)

    start = 0
    if args.resume and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, extra = ckpt.restore(args.ckpt_dir, last, state,
                                        placements=plan)
            it.load_state_dict(extra)
            start = last
            say(f"resumed from step {last}")

    step_fn = make_train_step(cfg, opt,
                              grad_compression=args.grad_compression)
    saver = ckpt.AsyncSaver()
    wd = StepWatchdog(timeout_s=600.0,
                      on_timeout=lambda s, dt: say(
                          f"!! step {s} straggling ({dt:.0f}s)"))
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    log = []
    t0, since = time.perf_counter(), 0
    for i in range(start, args.steps):
        batch = next(it)
        ts = time.perf_counter()
        with wd.step(i), use_plan(plan):
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])          # waits for the step
            gn = float(metrics["grad_norm"])
        log.append({"step": i + 1, "loss": loss, "grad_norm": gn,
                    "ms": 1e3 * (time.perf_counter() - ts)})
        since += 1
        if (i + 1) % args.log_every == 0 or i == start:
            dt = time.perf_counter() - t0
            tput = dc.global_batch * dc.seq_len * since / dt
            mem = ""
            if on_card:
                gib = torch.cuda.max_memory_allocated(device) / 2**30
                mem = f"  peak {gib:.2f} GiB"
            say(f"step {i+1:5d}  loss {loss:.4f}  |g| {gn:.3f}  "
                  f"{tput:,.0f} tok/s{mem}", flush=True)
            t0, since = time.perf_counter(), 0
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            saver.save(state, args.ckpt_dir, i + 1, extra=it.state_dict())
    saver.wait()
    say("done.")
    return state, log


if __name__ == "__main__":
    main()
