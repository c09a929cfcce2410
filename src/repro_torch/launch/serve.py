"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
--policy sfs [--full] [--device cuda]``.

Boots the SFS-scheduled continuous-batching engine on a (reduced by
default) model with random weights from ``--seed`` and replays a
FaaSBench-style request stream against it, printing the paper's metrics
(turnaround, RTE, context switches) and the decode rate.  ``--replicas N``
puts N engines over the one model behind the front-tier router (hash
dispatch, :class:`~repro_torch.serving.router.Router`), each with its own
cache.  Runs on the CUDA card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.serving import (Engine, EngineConfig, Request, Router,
                                 summarize)


def synth_workload(n: int, lanes: int, load: float, seed: int = 0,
                   short_frac: float = 0.83):
    """Short-function-dominant stream mirroring the paper's Table-I mix
    (83% short / 17% long, in decode-tick units)."""
    rng = np.random.default_rng(seed)
    svc = np.where(rng.random(n) < short_frac,
                   rng.integers(2, 8, n),          # short: 2-7 tokens
                   rng.integers(40, 120, n))       # long: 40-119 tokens
    mean_iat = svc.mean() / (lanes * load)
    arr = np.cumsum(rng.exponential(mean_iat, n)).astype(int)
    return [Request(rid=i, arrival=int(arr[i]), prompt_len=8,
                    n_tokens=int(svc[i])) for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--policy", default="sfs",
                    choices=["sfs", "cfs", "fifo", "srtf"])
    ap.add_argument("--requests", type=int, default=80)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=192)
    ap.add_argument("--load", type=float, default=1.0)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--synthetic", action="store_true",
                    help="scheduler-only mode (no model execution)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch) if args.full else \
        configs.get_reduced(args.arch)
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only; no serving decode")

    rng = np.random.default_rng(args.seed)
    model = None
    if not args.synthetic:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = Transformer(cfg, device=device, generator=gen)
    # the replicas share the model's weights; each engine has its own cache
    engines = [Engine(EngineConfig(lanes=args.lanes, n_slots=args.slots,
                                   max_len=args.max_len, policy=args.policy),
                      model, device=device)
               for _ in range(args.replicas)]

    wl = synth_workload(args.requests, args.lanes * args.replicas,
                        args.load, args.seed)
    prompts = ({r.rid: rng.integers(0, cfg.vocab, 8) for r in wl}
               if not args.synthetic else None)

    t0 = time.perf_counter()
    if args.replicas > 1:
        # as in the JAX package's launcher, the router is given no
        # prompts: every prefill runs zeros(prompt_len)
        router = Router(engines)
        done = router.run(wl)
        ticks = router.cluster.t
    else:
        done = engines[0].run(wl, prompts=prompts)
        ticks = engines[0].t
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    s = summarize(done)
    decode_tokens = sum(r.tokens_done for r in done)
    s.update(incomplete=sum(r.tokens_done != r.n_tokens for r in done),
             ticks=ticks, prefills=sum(e.n_prefills for e in engines),
             decode_steps=sum(e.n_decode_steps for e in engines),
             decode_tokens=decode_tokens, wall_s=wall,
             decode_tok_per_s=decode_tokens / wall)
    if args.replicas > 1:
        s["dispatch_counts"] = router.cluster.dispatch_counts
    print(f"policy={args.policy} replicas={args.replicas} "
          f"load={args.load} device={device}")
    for k, v in s.items():
        print(f"  {k:20s} {v}")
    return s


if __name__ == "__main__":
    main()
