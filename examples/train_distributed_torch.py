"""End-to-end training with the PyTorch port: train a small LM with
the full substrate -- sharding plan (under torchrun), async
checkpointing, a simulated preemption and exact resume, the straggler
watchdog -- through ``repro_torch.launch.train``.

  PYTHONPATH=src python examples/train_distributed_torch.py   # one card
  PYTHONPATH=src torchrun --nproc-per-node 8 \\
      examples/train_distributed_torch.py --device cpu        # 8 gloo ranks

One process trains unsharded on its device; under torchrun every rank
holds its shard of the state on a ``(world / 2, 2)`` mesh and rank 0
prints and writes the checkpoints.
"""
import os
import shutil
import sys
import tempfile

import torch.distributed as dist

from repro_torch.launch import train

args = sys.argv[1:]                 # e.g. --device cpu
run_id = os.environ.get("TORCHELASTIC_RUN_ID", str(os.getpid()))
ckdir = os.path.join(tempfile.gettempdir(), f"train_distributed_torch_{run_id}")
common = ["--arch", "qwen2.5-3b", "--batch", "8", "--seq", "128",
          "--ckpt-dir", ckdir, "--ckpt-every", "50", "--log-every", "20"]
rank0 = int(os.environ.get("RANK", "0")) == 0
if rank0:
    print(__doc__)
try:
    # phase 1: 120 steps with checkpoints every 50
    train.main(common + ["--steps", "120"] + args)
    if rank0:
        print("\n-- simulated preemption: restarting from the last "
              "checkpoint --")
    # phase 2: resume exactly and continue to 200
    train.main(common + ["--steps", "200", "--resume"] + args)
finally:
    if dist.is_initialized():
        dist.barrier()
    if rank0:
        shutil.rmtree(ckdir, ignore_errors=True)
if rank0:
    print("\nresume is exact: the data iterator's position rides in the "
          "checkpoint manifest and batch k is a function of (seed, k).")
