"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--full] [--device cuda]``.

The port of ``repro.launch.train``: a training loop on one device (the
reduced config by default; ``--full`` for the full one), with periodic
asynchronous checkpoints, exact resume (``--resume`` restores the
latest checkpoint under ``--ckpt-dir`` and the data iterator's
position), a straggler watchdog, and optional int8 error-feedback
gradient compression.  Only ``--mesh host`` exists: the pod meshes wait
for the sharded port.  Runs on the CUDA card unless ``--device`` says
otherwise.

Each logged step prints the reference's line (loss, gradient norm,
tokens/s over the steps since the last line) and the card's peak
memory.
``main`` returns ``(state, log)``: the final train state and one dict a
step (``step``, ``loss``, ``grad_norm``, ``ms``: the step's wall time).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
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
    ap.add_argument("--mesh", default="host", choices=["host"])
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

    opt = get_optimizer(cfg.optimizer)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed, kind=dkind,
                    d_model=d_model, n_prefix=cfg.n_prefix)
    it = DataIterator(dc)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(cfg, opt, device=device, generator=gen)

    start = 0
    if args.resume and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, extra = ckpt.restore(args.ckpt_dir, last, state)
            it.load_state_dict(extra)
            start = last
            print(f"resumed from step {last}")

    step_fn = make_train_step(cfg, opt,
                              grad_compression=args.grad_compression)
    saver = ckpt.AsyncSaver()
    wd = StepWatchdog(timeout_s=600.0,
                      on_timeout=lambda s, dt: print(
                          f"!! step {s} straggling ({dt:.0f}s)"))
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    log = []
    t0, since = time.perf_counter(), 0
    for i in range(start, args.steps):
        batch = next(it)
        ts = time.perf_counter()
        with wd.step(i):
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
            print(f"step {i+1:5d}  loss {loss:.4f}  |g| {gn:.3f}  "
                  f"{tput:,.0f} tok/s{mem}", flush=True)
            t0, since = time.perf_counter(), 0
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            saver.save(state, args.ckpt_dir, i + 1, extra=it.state_dict())
    saver.wait()
    print("done.")
    return state, log


if __name__ == "__main__":
    main()
