"""End-to-end example on the PyTorch port: serve qwen2.5-3b with batched
requests through the SFS-scheduled continuous-batching engine, and
compare against CFS lanes on the same stream.

By default it serves the model at full width and depth (3.4 B
parameters, seeded random weights) on the CUDA card: each prefill runs
the hand-written ``flash_attention`` kernel, each tick one
``decode_step`` over the slots with the ``decode_attention`` kernel.
``--reduced`` serves the reduced config (two layers, d_model 64), which
``--device cpu`` runs on the CPU through the kernels' plain versions.

  PYTHONPATH=src python examples/serve_sfs_torch.py
  PYTHONPATH=src python examples/serve_sfs_torch.py --reduced --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get, get_reduced
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models.transformer import Transformer
from repro_torch.serving import Engine, EngineConfig, Request, summarize

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
ap.add_argument("--reduced", action="store_true",
                help="serve the reduced config instead of the full one")
args = ap.parse_args()

print(__doc__)
cfg = (get_reduced if args.reduced else get)("qwen2.5-3b")
model = Transformer(cfg, device=args.device,
                    generator=torch.Generator(args.device).manual_seed(0))
rng = np.random.default_rng(7)

N, LANES = 40, 4
svc = np.where(rng.random(N) < 0.8, rng.integers(2, 8, N),
               rng.integers(30, 60, N))
span = svc.sum() / LANES
arr = np.sort(rng.uniform(0, span, N)).astype(int)
prompts = {i: rng.integers(0, cfg.vocab, 8) for i in range(N)}

for policy in ["sfs", "cfs"]:
    wl = [Request(rid=i, arrival=int(arr[i]), prompt_len=8,
                  n_tokens=int(svc[i])) for i in range(N)]
    eng = Engine(EngineConfig(lanes=LANES, n_slots=16, max_len=96,
                              policy=policy,
                              sched_kw={"adaptive_window": 10}
                              if policy == "sfs" else {}),
                 model, device=args.device)
    flash_kernel.launches = decode_kernel.launches = 0
    t0 = time.perf_counter()
    done = eng.run(wl, prompts=prompts, max_ticks=100_000)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    s = summarize(done)
    print(f"{policy:4s}: {s['n']} requests in {eng.t} ticks "
          f"({time.perf_counter()-t0:.1f}s wall) | median TA "
          f"{s['median_turnaround']:.0f} ticks | RTE>=0.95 "
          f"{s['frac_rte_095']*100:.0f}% | lane switches {s['total_ctx']}")
    print(f"      {eng.n_prefills} prefills, {eng.n_decode_steps} decode "
          f"steps on {model.device}; kernel launches: flash_attention "
          f"{flash_kernel.launches}, decode_attention "
          f"{decode_kernel.launches}")
print("\nshort requests finish in ~their own decode length under SFS; "
      "CFS time-slices everyone and short requests queue behind long ones.")
