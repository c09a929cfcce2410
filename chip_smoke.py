#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi) and the matmul precision
   settings, set explicitly;
2. build the four CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
   sm_90a, all at once (ptxas report printed);
3. each attention kernel against its plain PyTorch version on the card,
   in float32 (atol = rtol = 2e-5) and bfloat16 (2e-2), at qwen2.5-3b's,
   zamba2-1.2b's, chatglm3-6b's, gemma-7b's, qwen3-moe-30b-a3b's (8
   query heads per kv head), dbrx-132b's (6, int8 cache), llava-next-34b's
   (7, int8 cache; flash also at its 600-token prompts) and
   hubert-xlarge's (not causal, D = 80, 512 frames) shapes among others
   (flash: every head dim of the bfloat16 tensor-core kernel and of the
   float32 one up to 256, causal and not, ragged tiles; decode: head dims
   16 to 256, 1 to 16 query heads per kv head, kv_len 0 in some rows, with
   and without the in-flight entry, a short cache and a long one, an int8
   cache with its scales under bfloat16 and float32 q, each call held to
   the kernel variant its shape calls for); with kernel, plain and
   library-call (SDPA; for the int8 cache, which no one PyTorch call
   takes, dequantize + SDPA as context) times by CUDA events, kernel and
   SDPA device-only times (torch.profiler) and the kernel's bound; the
   ssd_scan kernel against its plain version (float32 atol 3e-5 / rtol
   3e-4, bfloat16 x 3e-2) at the serving prefill's shape, a full 256-step
   chunk, zamba2's d_state, an odd head count, a strongly decaying state,
   a dt = 0 tail (which must add exactly nothing), a chunk past one
   128-step segment of S, P = 128 and a ragged Q <= 16 with P and N not
   multiples of 4, with kernel, plain and two-einsum times, the bound
   (contractions at the TF32 tensor-core rate, three products each) and
   the all-float32-FMA bound of the first version;
4. qwen2.5-3b at full width, random weights from a seed, in float32: an
   8-token prefill of 4 prompts and 3 decode steps through the kernels
   and through the plain attention; the logits must agree within
   1e-3 * max|logits|; then mamba2-1.3b and zamba2-1.2b the same way with
   300-token prompts (two SSD chunks, the second ragged) and one slot
   inactive in the decode steps; then chatglm3-6b and gemma-7b (its int8
   KV cache kept) with 8-token prompts; then qwen3-moe-30b-a3b cut to 8
   layers, dbrx-132b cut to 2 (int8 cache), llava-next-34b cut to 8
   (int8 cache; 600-token prompts whose first 576 positions are
   synthetic vision embeddings) and hubert-xlarge whole (the forward
   over 512 frames, not causal); the kernel path must launch flash
   once per attention layer and the decode variant its cache calls for
   once per layer and step; for the MoE models every MoE call's routes
   (each token's top-k set and keep mask) must be the same on both paths,
   except at a router margin below 1e-5 (reported, and that sequence
   left out of the logits check), the drop shares are printed, and no
   decode step may drop an assignment;
5. the main path: ``repro_torch.launch.serve.main`` at full width in
   bfloat16 (48 requests, 4 lanes, 32 slots, max-len 192) on qwen2.5-3b
   under ``sfs`` and ``cfs``, then on mamba2-1.3b, zamba2-1.2b,
   chatglm3-6b, gemma-7b (int8 KV cache), qwen3-moe-30b-a3b and
   llava-next-34b (int8 KV cache; tokens only) under ``sfs``: every
   request completes, no logit is NaN or infinite, no call reaches a
   plain attention version, chatglm3-6b, gemma-7b, qwen3-moe-30b-a3b
   and llava-next-34b decode only through the kernel variant their cache
   calls for (``mma``, ``mma_int8``), every
   prefill launched ssd_scan once per Mamba layer and flash-attention once
   per attention layer or shared-block application, every decode step
   launched decode-attention as often, and the schedule (mean, median and
   P99 turnaround, mean RTE, context switches) equals a ``--synthetic``
   run's with the same arguments;
   "replicas": the same on qwen2.5-3b and zamba2-1.2b under ``sfs`` with
   ``--replicas 2`` (two engines over one model behind the router, each
   with its own cache): every check above with the launches summed over
   the engines, the dispatch counts equal to the ``--synthetic
   --replicas 2`` run's, and every replica given requests; wall s, ms per
   cluster tick and decode tok/s printed beside the card;
6. where the time goes: one more serving run of qwen2.5-3b (16
   requests) and one each of mamba2-1.3b, zamba2-1.2b, gemma-7b,
   qwen3-moe-30b-a3b and llava-next-34b (8 requests)
   under torch.profiler (device activity only), with the card's busy
   share, device operations per tick, the port's kernels' shares and the
   kernels by device time (reported; a Mamba model fails if no ssd_scan
   device time is traced or not one kernel per launch); for
   qwen3-moe-30b-a3b and llava-next-34b also four decode steps of all 32
   slots traced with the host's operators: device ms a step against the
   step's bytes bound, the MoE experts' share, and a failure if any
   operator copies a weight tensor of 64 MB or more;
7. training (``repro_torch.launch.train.main``): qwen2.5-3b at full
   width and depth in bfloat16 (AdamW, batch 8 x 512, one microbatch):
   3 steps with a checkpoint at step 3 (the reference's layout, about
   34 GB), on to step 6 in the same process (the straight run), one
   more step split into forward + backward and optimizer and profiled;
   then the launcher's ``--resume`` restores the checkpoint into a
   fresh state, which must equal the step-3 state bit for bit (a
   position-weighted sum of every tensor's raw bits), and its steps 4-6
   must be within rel 1e-2 of the straight run's losses and gradient
   norms (CUDA's embedding backward may add with atomics); loss, |g|,
   ms per step, tokens/s and peak memory printed;
   mamba2-1.3b at full width and depth (bfloat16, 2 microbatches, scan
   accumulation), 3 steps; "train parity": one float32 step on the card
   against the same step on the host CPU from the same weights and
   batch, for qwen2.5-3b at full width cut to 2 layers (AdamW) and
   reduced llama3-405b (Adafactor, fused, 2 microbatches): the loss to
   rel 1e-5, each gradient to 1e-4 x its max |g|, the params after the
   update (AdamW: where |g| is within 100x that tolerance they may
   differ by up to 2 lr_t); reduced qwen2.5-3b's loss must fall by more
   than 0.3 in 25 steps; no hand-written kernel launches in any of it;
   "sharded training": qwen2.5-3b at full width and depth (bfloat16,
   AdamW, batch 8 x 512) takes 2 steps sharded by ``Plan(mesh,
   fsdp=cfg.fsdp)`` on the ``(1, 1)`` ``("data", "model")`` mesh of
   ``make_host_mesh`` (a one-rank NCCL group) and 2 unsharded steps from
   the same seed and batches: both losses and gradient norms (bit-equal,
   or the first loss within rel 1e-5, the rest within 1e-2),
   ms a step, peak memory, and the collectives of one more sharded step
   by op (the functional collectives DTensor runs, as CommDebugMode
   counts them);
   "dry run": ``python -m repro_torch.launch.dryrun`` on the card's host
   for qwen2.5-3b ``train_4k`` and ``decode_32k`` on pod16x16 and
   qwen3-moe-30b-a3b ``prefill_32k`` on pod2x16x16 (fake process groups
   of 256 and 512 ranks, fake CUDA tensors): each record's per-device
   state and peak bytes, FLOPs, collectives by op and seconds;
8. the group_pick kernel against its plain version on the card, exact
   integer equality over G in {1, 7, 1024}, CAP in {32, 33, 64, 100,
   256, 1024, 4096} (both variants, every register width) and kmax in
   {1, 4, 8, 40}, with heavy vruntime ties, ~30% empty slots, an empty
   row and rows with fewer keys than kmax; kernel, plain and sort-pair
   times, the bound and the empty-launch floor (a one-element PyTorch
   kernel's device time) at the fleet shape; with ``--old-csrc DIR``, an
   earlier ssd_scan.cu and group_pick.cu from DIR built and timed against
   the present ones in turns (old, new, new, old) on the same inputs;
9. "fleet 64x4": the fleet backend at 64 engines x 4 lanes (250
   requests, sfs-aware, history predictor): the CUDA run equals the
   port's own CPU run, and the port's host backends (``engine="tick"``
   and ``engine="vector"``) on the same spec, in every per-request field,
   the dispatch counts, the ETA log and the overload bypasses;
10. the chaos scenario of ``benchmarks/cluster_sweep.py`` (16 x 4 engines,
   load 0.8, faults + retries + shedding) on the card under sfs-aware and
   hash: fingerprint and shed count equal the recorded rows of
   ``benchmarks/baselines/BENCH_cluster.json``;
   "recorded rows": the port's ``engine="vector"`` and ``engine="tick"``
   (host code, in worker processes) on all eight ``elastic`` and
   ``chaos`` rows of that file (loads 0.6 and 0.8, sfs-aware and hash),
   each spec built as ``run_elastic`` and ``run_chaos`` build it:
   ``vector`` reproduces every row's fingerprint and shed count, ``tick``
   the elastic rows' and, on the chaos rows, those of the JAX package's
   own tick backend (``TICK_CHAOS``);
   "des rows": the port's discrete-event simulator (``engine="des"``,
   host code, in the same worker processes) on every recorded DES row:
   the 16 ``layer: "des"`` rows of ``BENCH_cluster.json`` (uniform and
   mixed servers, four dispatch policies, loads 0.8 and 1.0), each
   rebuilt from its provenance through the port's ``from_json`` with the
   workload seed set to each recorded seed, and the 9 rows of
   ``BENCH_predict.json`` (oracle, none, history and class predictors,
   hinted demotion, trace arrivals; requests generated from the recorded
   workload per seed, as ``benchmarks/predict_sweep.py`` does): every
   seed's fingerprint equals the recorded one (the two seeds of
   ``DES_REDRAWN``: the JAX package's own, on the workload digest named
   there), and the pooled request count and short and long p99 equal
   the row's; then the three
   ``GOLDEN_HINTED`` SHA-256s of ``benchmarks/predict_sweep.py``; each
   row's wall (host seconds, the sum over its seeds) is printed;
11. the fleet main path: ``repro_torch.launch.fleet`` at 1024 engines x
   8 lanes, load 0.9, 500,000 requests, seed 11, under sfs-aware and
   hash: fingerprints equal the recorded rows, and group_pick launched
   once per stepped tick and 64 times per chunk;
12. where the fleet's time goes: one short fleet run under
   torch.profiler (device operations per tick, busy share, group_pick's
   share; reported only).

Each phase prints its wall time (``[time]``).  It then prints one JSON
line describing the four kernels (launches summed over phases 5 and 10,
the replica runs included) and, last, the
result line ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32 = 495e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the SSD step's tolerances, as tests/test_kernels.py holds the TPU kernel
SSD_TOL = {"float32": dict(atol=3e-5, rtol=3e-4),
           "bfloat16": dict(atol=3e-2, rtol=3e-2)}
ARCH = "qwen2.5-3b"
SSM_ARCHS = ("mamba2-1.3b", "zamba2-1.2b")
# the rest of the dense family at full width: chatglm3-6b (16 query heads
# per kv head) and gemma-7b (head_dim 256, one query head per kv head,
# the int8 KV cache of its full config)
DENSE_ARCHS = ("chatglm3-6b", "gemma-7b")
# the moe and vlm families at full width and depth: qwen3-moe-30b-a3b
# (128 experts, top-8; 8 query heads per kv head) and llava-next-34b (7
# query heads per kv head, the int8 KV cache of its full config)
FAMILY_ARCHS = ("qwen3-moe-30b-a3b", "llava-next-34b")
# full width, kernel path vs plain path in float32: (arch, prompt length,
# max len, depth; 0 = the config's): qwen3-moe and llava with their depth
# cut to fit float32 on one card, dbrx-132b (which does not fit one card
# at full depth in any dtype) at two layers with its int8 cache, llava
# with 600-token prompts behind its 576-position vision prefix, and
# hubert-xlarge whole, over 512 frames
FAMILY_CHECKS = (("qwen3-moe-30b-a3b", 8, 192, 8), ("dbrx-132b", 8, 192, 2),
                 ("llava-next-34b", 600, 640, 8), ("hubert-xlarge", 512, 0, 0))
# multi-replica serving: two engines over one model behind the router
REPLICA_ARCHS = ("qwen2.5-3b", "zamba2-1.2b")
SERVE_ARGS = ["--full", "--device", "cuda", "--requests", "48", "--lanes",
              "4", "--slots", "32", "--max-len", "192", "--seed", "0"]
BASELINES = ROOT / "benchmarks" / "baselines" / "BENCH_cluster.json"
PREDICT_BASELINES = BASELINES.with_name("BENCH_predict.json")
# benchmarks/predict_sweep.py: GOLDEN_CFG and GOLDEN_HINTED, the SHA-256
# of the (rid, finish, n_ctx, demoted) stream of the oracle predictor's
# DES cluster run on 4 x 4 sfs cores, per dispatch policy
GOLDEN_CFG = dict(n=1200, servers=4, cores=4, load=1.0, seed=17)
GOLDEN_HINTED = {
    "sfs-aware":
        "a96a0323aae69a19d91fee50df050d06243bcb48f2e7a8f1d9ae22dc3bfa0eb0",
    "hash":
        "9eab3216441016fbaf421e55d50231f631dc86b7d685f3cfb9d95ec56cbd46aa",
    "least-outstanding":
        "fc10ad89f5ca614068e133ff26403431c2cae1f4b6d59b19a682776e79baf6a4",
}
# Two recorded DES seeds that the JAX package's own DES does not
# reproduce on an H100 host (numpy 2.3.5, AVX512_SPR) or on a Xeon
# Cooper Lake CPU host (numpy 2.0.2): FaaSBench draws service times with
# np.log and np.exp, whose rounding follows numpy's build and the CPU's
# SIMD path, and for these two seeds the recording host drew a workload
# that differs in the last bits.  Keyed (row, seed), the value is
# (workload digest, the JAX package's fingerprint on that workload);
# tests/test_torch_des_cluster.py holds both packages to them.
DES_REDRAWN = {
    ("cluster uniform hash load=1.0", 7):
        ("dedec7fceaf51ba5", "2192b7c17b866cd0"),
    ("predict history sfs-aware load=0.8 trace", 11):
        ("40c5dacb0f5fd833", "d956802d6159277c"),
}
FLEET = dict(engines=1024, lanes=8, load=0.9, n=500_000, seed=11)
# the chaos scenario of benchmarks/cluster_sweep.py (run_chaos) at load 0.8
CHAOS = dict(
    engines=16, lanes=4, load=0.8, n=20_000, seed=7,
    workload="bimodal:n=20000,seed=7,load=0.8|zipf:funcs=16,s=1.1",
    lifecycle="lifecycle:cold=2,ttl=400,cap=8",
    faults="faults:mttf=1200,mttr=250,blast=4,episodes=3,seed=13,first=800",
    retry="retry:timeout=400,retries=2,backoff=16,shed=10")
# engine="tick" on the four chaos rows, (policy, load) -> (fingerprint,
# shed): what the JAX package's own per-object backend gives
# (tests/test_torch_tick_cluster.py holds it to these).  The recorded rows
# were written by its vector backend, whose groups keep a failed engine's
# adaptive slice across the failure, where the per-object backend builds
# a fresh scheduler; so the two differ from the first recovery on.
TICK_CHAOS = {("sfs-aware", 0.6): ("7d662fc44ff05095", 0),
              ("hash", 0.6): ("8f56c1fe7cd9f425", 0),
              ("sfs-aware", 0.8): ("2acea526c8067119", 5339),
              ("hash", 0.8): ("d88b2c669427900a", 5239)}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def device_line() -> str:
    import torch
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    line = out.strip().splitlines()[torch.cuda.current_device()]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          "matmul.allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    return line


def build_kernels() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[build] {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        # ptxas -v: one "entry ... registers ... spill" summary per kernel
        entry, rows = "?", []
        for ln in path.with_suffix(".log").read_text().splitlines():
            m = re.search(r"entry function '\w*?\d+(flash_fwd_kernel|"
                          r"flash_mma_kernel|decode_mma_kernel|"
                          r"decode_fma_kernel|ssd_scan_kernel|"
                          r"group_pick_reg_kernel)"
                          r"I(\w+?)E[Ev]", ln)
            if m:       # mangled template arguments: f / bf16, Li<n>E, Lb<b>E
                args = re.sub(r"^f(?=L|$)", "f32", m.group(2).replace(
                    "13__nv_bfloat16", "bf16"))
                args = re.sub(r"L[ib](\d+)E?", r",\1", args).lstrip(",")
                entry = f"{m.group(1)}<{args}>"
            elif "entry function" in ln and "group_pick_smem_kernel" in ln:
                entry = "group_pick_smem_kernel"
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m:
                spill = m.group(1)
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                rows.append(f"{entry} regs={m.group(1)} spill={spill}B")
        print(f"[build] {name}: " + "; ".join(rows))


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device-only time of one call: the durations of the kernels it
    launches, traced by torch.profiler (device activity only), without
    the host's launch gaps between them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / iters


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, dtype: str, tol=None) -> float:
    import torch
    tol = tol or dict(atol=TOL[dtype], rtol=TOL[dtype])
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    err = (g - w).abs().max().item()
    if not torch.allclose(g, w, **tol):
        fail(f"{name}: max |kernel - plain| = {err:.3g} beyond "
             f"atol {tol['atol']}, rtol {tol['rtol']}")
    return err


def check_flash(gen) -> dict:
    """Kernel vs plain at each case; returns the main-path record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    # (label, B, S, H, K, D, causal, dtype, timed)
    cases = [("main", 1, 8, 16, 2, 128, True, "bfloat16", True),
             ("main", 1, 8, 16, 2, 128, True, "float32", False),
             ("zamba2", 1, 8, 32, 32, 64, True, "bfloat16", True),
             ("zamba2", 1, 8, 32, 32, 64, True, "float32", False),
             ("long", 1, 2048, 16, 2, 128, True, "bfloat16", True),
             ("gqa", 2, 256, 16, 4, 64, True, "float32", False),
             ("gqa", 2, 256, 16, 4, 64, True, "bfloat16", False),
             ("noncausal", 2, 200, 8, 8, 80, False, "float32", False),
             ("noncausal", 2, 200, 8, 8, 80, False, "bfloat16", False),
             ("d80causal", 1, 300, 16, 2, 80, True, "bfloat16", False),
             ("d80causal", 1, 300, 16, 2, 80, True, "float32", False),
             ("d32", 2, 96, 4, 1, 32, True, "float32", False),
             ("d32", 2, 96, 4, 1, 32, True, "bfloat16", False),
             ("d16", 1, 130, 4, 2, 16, False, "bfloat16", False),
             ("d16causal", 1, 77, 4, 2, 16, True, "bfloat16", False),
             ("d16causal", 1, 77, 4, 2, 16, True, "float32", False),
             # head_dim 256: gemma-7b's prefill (timed), ragged tiles
             ("gemma", 1, 8, 16, 16, 256, True, "bfloat16", True),
             ("gemma", 1, 8, 16, 16, 256, True, "float32", False),
             ("d256", 2, 100, 4, 2, 256, False, "bfloat16", False),
             ("d256", 2, 100, 4, 2, 256, False, "float32", False),
             ("d256causal", 1, 130, 4, 4, 256, True, "bfloat16", False),
             ("d256causal", 1, 130, 4, 4, 256, True, "float32", False),
             ("d256long", 1, 1024, 16, 16, 256, True, "bfloat16", True),
             # chatglm3-6b's prefill: 16 query heads per kv head
             ("chatglm3", 1, 8, 32, 2, 128, True, "bfloat16", False),
             ("chatglm3", 1, 8, 32, 2, 128, True, "float32", False),
             # qwen3-moe-30b-a3b's and llava-next-34b's serving prefills
             # (8 query heads per kv head; 7), llava's 600-token prompts
             # and hubert-xlarge's 512 frames (not causal, D = 80)
             ("qwen3moe", 1, 8, 32, 4, 128, True, "bfloat16", True),
             ("qwen3moe", 1, 8, 32, 4, 128, True, "float32", False),
             ("llava", 1, 8, 56, 8, 128, True, "bfloat16", True),
             ("llava", 1, 8, 56, 8, 128, True, "float32", False),
             ("llava600", 1, 600, 56, 8, 128, True, "float32", False),
             ("hubert", 2, 512, 16, 16, 80, False, "bfloat16", True),
             ("hubert", 2, 512, 16, 16, 80, False, "float32", False)]
    main = None
    for label, B, S, H, K, D, causal, dtype, timed in cases:
        dt = getattr(torch, dtype)
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, S, K, D, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, S, K, D, generator=gen, device="cuda").to(dt)
        out = fk.flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = compare(f"flash {label} {dtype}", out,
                      flash_attention_ref(q, k, v, causal=causal), dtype)
        line = (f"[flash] {label:10s} B={B} S={S} H={H} K={K} D={D} "
                f"causal={causal} {dtype}: max_abs_err={err:.3g}")
        if timed:
            iters = 200 if S <= 256 else 20

            def kern():
                return fk.flash_attention_cuda(q, k, v, causal=causal)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
            ms = time_ms(kern, iters)
            plain = time_ms(lambda: flash_attention_ref(
                q, k, v, causal=causal), iters)
            lib = time_ms(sdpa, iters)
            dev, lib_dev = device_ms(kern, iters), device_ms(sdpa, iters)
            el = q.element_size()
            nbytes = 2 * q.numel() * el + 2 * k.numel() * el
            pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
            b_ms, b_by = bound(nbytes, 4 * pairs * D, dtype)
            line += (f" ms={ms:.4f} device_ms={dev:.5f} plain_ms={plain:.4f}"
                     f" sdpa_ms={lib:.4f} sdpa_device_ms={lib_dev:.5f}"
                     f" bound_ms={b_ms:.6f} ({b_by})")
            if label == "main":
                main = dict(max_abs_err=err, ms=ms, device_ms=dev,
                            plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib, library_device_ms=lib_dev,
                            shape=f"B={B} S={S} H={H} K={K} D={D} causal "
                                  f"{dtype}")
        print(line)
    return main


MMA_HEAD_DIMS = (16, 32, 64, 80, 128, 256)


def decode_variant(dtype: str, D: int, int8: bool) -> str:
    """The decode kernel the entry point must choose (aligned tensors)."""
    mma = dtype == "bfloat16" and D in MMA_HEAD_DIMS
    return ("mma" if mma else "fma") + ("_int8" if int8 else "")


def check_decode(gen) -> dict:
    """Kernel vs plain at qwen2.5-3b's decode shape (timed; returns its
    record), zamba2-1.2b's, chatglm3-6b's (16 query heads per kv head) and
    gemma-7b's (head_dim 256, one query head per kv head; with its int8
    cache and scales too), all timed and printed, a long cache with few
    sequences (timed and printed: B * K blocks leave most SMs idle there,
    the case a split of the prefix would serve) and small shapes: head
    dims 16 to 256 (36, 40 and 48 take the FMA kernel in bfloat16 too), 1
    to 16 query heads per kv head, a short cache, int8 caches.  Every
    shape has an empty, a full and a one-row prefix, and every call must
    launch the variant the shape and dtype call for."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.layers import quantize_kv
    # (label, B, Smax, H, K, D, timed, int8 cache)
    cases = [("main", 32, 192, 16, 2, 128, True, False),
             ("zamba2", 32, 192, 32, 32, 64, True, False),
             ("chatglm3", 32, 192, 32, 2, 128, True, False),
             ("gemma", 32, 192, 16, 16, 256, True, False),
             ("gemma", 32, 192, 16, 16, 256, True, True),
             # qwen3-moe-30b-a3b (G = 8), dbrx-132b (G = 6) and
             # llava-next-34b (G = 7), the last two over int8 caches
             ("qwen3moe", 32, 192, 32, 4, 128, True, False),
             ("dbrx", 32, 192, 48, 8, 128, True, True),
             ("llava", 32, 192, 56, 8, 128, True, True),
             ("long", 6, 4096, 16, 2, 128, True, False),
             ("d256", 8, 130, 8, 4, 256, False, False),
             ("g16", 8, 130, 32, 2, 128, False, True),
             ("d64", 8, 70, 8, 2, 64, False, True),
             ("d48", 4, 70, 4, 2, 48, False, True),
             ("d80", 8, 130, 8, 2, 80, False, False),
             ("d40", 8, 130, 8, 2, 40, False, False),
             ("d36", 8, 130, 8, 2, 36, False, False),
             ("d32", 8, 70, 4, 1, 32, False, False),
             ("d16", 8, 70, 32, 2, 16, False, False),
             ("short", 8, 48, 16, 2, 128, False, False)]
    main = None
    for label, B, Smax, H, K, D, timed, int8 in cases:
        lens = torch.randint(1, Smax + 1, (B,), generator=gen, device="cuda")
        lens[0], lens[1], lens[2] = 0, Smax, 1
        kv_len = lens.to(torch.int32)
        if int8:
            kc, ks = quantize_kv(torch.randn(B, Smax, K, D, generator=gen,
                                             device="cuda"))
            vc, vs = quantize_kv(2 * torch.randn(B, Smax, K, D,
                                                 generator=gen,
                                                 device="cuda"))
            scales = dict(k_scale=ks, v_scale=vs)
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q = torch.randn(B, H, D, generator=gen, device="cuda").to(dt)
            if not int8:
                kc = torch.randn(B, Smax, K, D, generator=gen,
                                 device="cuda").to(dt)
                vc = torch.randn(B, Smax, K, D, generator=gen,
                                 device="cuda").to(dt)
                scales = {}
            kn = torch.randn(B, K, D, generator=gen, device="cuda").to(dt)
            vn = torch.randn(B, K, D, generator=gen, device="cuda").to(dt)
            variant = decode_variant(dtype, D, int8)
            for extra in (True, False):
                args = (q, kc, vc, kv_len) + ((kn, vn) if extra else ())
                before = dict(dk.variant_launches)
                out = dk.decode_attention_cuda(*args, **scales)
                torch.cuda.synchronize()
                cache = "int8" if int8 else dtype
                what = f"decode {label} extra={extra} {dtype} {cache} cache"
                ran = [v for v, n in dk.variant_launches.items()
                       if n != before[v]]
                if ran != [variant]:
                    fail(f"{what}: launched {ran}, expected {variant}")
                err = compare(what, out,
                              decode_attention_ref(*args, **scales), dtype)
                if not extra and not out[0].eq(0).all():
                    fail(f"{what}: kv_len = 0 without the in-flight entry "
                         "must give zeros")
                line = (f"[decode] {label:8s} B={B} Smax={Smax} H={H} K={K} "
                        f"D={D} extra={extra} {dtype} q, {cache} cache "
                        f"({variant}): max_abs_err={err:.3g}")
                if timed and dtype == "bfloat16" and extra:
                    def kern():
                        return dk.decode_attention_cuda(*args, **scales)
                    mask = (torch.arange(Smax, device="cuda")[None, :]
                            < kv_len[:, None])[:, None, None, :]
                    qt = q[:, :, None, :]

                    def sdpa():
                        if int8:     # context: dequantize, then SDPA
                            kt = (kc * ks[..., None]).to(dt).transpose(1, 2)
                            vt = (vc * vs[..., None]).to(dt).transpose(1, 2)
                        else:
                            kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
                        return F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=mask, enable_gqa=True)
                    ms = time_ms(kern, 500)
                    plain = time_ms(lambda: decode_attention_ref(
                        *args, **scales), 200)
                    lib = time_ms(sdpa, 200)
                    dev, lib_dev = device_ms(kern, 200), device_ms(sdpa, 200)
                    el = q.element_size()
                    n = kv_len.clamp(0, Smax).sum().item()
                    nbytes = (2 * q.numel() * el + kv_len.numel() * 4
                              + 2 * n * K * D * kc.element_size()
                              + (2 * n * K * 4 if int8 else 0)
                              + 2 * kn.numel() * el)
                    b_ms, b_by = bound(nbytes, 4 * H * D * (n + B), dtype)
                    lib_name = "dequant_sdpa" if int8 else "sdpa"
                    line += (f" ms={ms:.4f} device_ms={dev:.5f} "
                             f"plain_ms={plain:.4f} {lib_name}_ms={lib:.4f} "
                             f"{lib_name}_device_ms={lib_dev:.5f} "
                             f"bound_ms={b_ms:.6f} ({b_by})")
                    if label == "main":
                        main = dict(max_abs_err=err, ms=ms, device_ms=dev,
                                    plain_ms=plain, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=lib,
                                    library_device_ms=lib_dev,
                                    shape=f"B={B} Smax={Smax} H={H} K={K} "
                                          f"D={D} ragged kv_len + in-flight "
                                          f"entry {dtype}")
                print(line)
    return main


def ssd_inputs(gen, b, nc, Q, H, P, N, decay=1.0, dt_zero_from=None):
    """xc, dtc, cum, tot, Bc, Cc on the card, float32, as ssd_chunked
    hands them to the kernel: softplus step sizes, log decays of -decay *
    softplus(N(0, 1)) a step, B and C ~ N(0, 1/4); dt = 0 from step
    ``dt_zero_from`` of every chunk on (the padded tail)."""
    import torch
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    xc = randn(b, nc, Q, H, P)
    dtc = F.softplus(randn(b, nc, Q, H))
    la = -decay * F.softplus(randn(b, nc, Q, H))
    if dt_zero_from is not None:
        dtc[:, :, dt_zero_from:] = 0.0
        la[:, :, dt_zero_from:] = 0.0
    cum = torch.cumsum(la, dim=2)
    tot = cum[:, :, -1].contiguous()
    return xc, dtc, cum, tot, 0.5 * randn(b, nc, Q, 1, N), \
        0.5 * randn(b, nc, Q, 1, N)


def ssd_work(b, nc, Q, H, P, N, x_bytes: int):
    """(bytes moved, contraction operations, elementwise operations) of
    the intra-chunk step: each input read once, each output written once;
    the contractions are C.B once per chunk (one group shared by all
    heads), then per head w.x and the state's outer-product sum; the
    elementwise part is per head the masked decay weights of each pair
    and the decay to the chunk's end of each step."""
    pairs = Q * (Q + 1) // 2
    nbytes = (b * nc * (Q * H * P * x_bytes + 2 * Q * H * 4 + H * 4
                        + 2 * Q * N * 4)
              + b * nc * (Q * H * P + H * P * N) * 4)
    mma = b * nc * (2 * pairs * N + H * (2 * pairs * P + 2 * Q * P * N))
    ew = b * nc * H * (3 * pairs + 3 * Q)
    return nbytes, mma, ew


def ssd_bounds(b, nc, Q, H, P, N, x_bytes: int = 4):
    """(bound ms, by) of the kernel as it runs, and the f32-FMA bound of
    its first version (everything at the float32 rate), for continuity.
    The contractions run as three TF32 products each (the hi/lo split) at
    the TF32 tensor-core peak, the rest at the float32 peak; the two
    times add."""
    nbytes, mma, ew = ssd_work(b, nc, Q, H, P, N, x_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * mma / PEAK_TF32 + ew / PEAK_FLOPS["float32"]) * 1e3
    now = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return now, bound(nbytes, mma + ew, "float32")


def check_ssd(gen) -> dict:
    """The ssd_scan kernel vs its plain version at every case; returns the
    main path's record (mamba2-1.3b's prefill of an 8-token prompt)."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    # (label, b, nc, Q, H, P, N, dict of ssd_inputs options, timed)
    cases = [("main", 1, 1, 8, 64, 64, 128, {}, True),
             ("chunk", 2, 8, 256, 64, 64, 128, {}, True),
             ("zamba2", 1, 1, 8, 64, 64, 64, {}, True),
             ("zamba2", 2, 2, 256, 64, 64, 64, {}, False),
             ("oddH", 1, 2, 100, 13, 64, 128, {}, False),
             ("small", 1, 3, 64, 8, 32, 16, {}, False),
             ("decay", 1, 2, 256, 16, 64, 128, {"decay": 100.0}, False),
             ("dt0tail", 1, 1, 256, 16, 64, 128, {"dt_zero_from": 200},
              False),
             # three 128-step segments of S; P = 128; ragged Q <= 16
             # with P and N not multiples of 4 (4-byte copies and stores)
             ("long", 1, 1, 300, 8, 64, 128, {}, False),
             ("p128", 1, 2, 40, 4, 128, 32, {}, False),
             ("ragged", 2, 1, 12, 5, 30, 7, {}, False)]
    main, err_max = None, 0.0
    for label, b, nc, Q, H, P, N, opts, timed in cases:
        xc, dtc, cum, tot, Bc, Cc = ssd_inputs(gen, b, nc, Q, H, P, N,
                                               **opts)
        for dtype in ("float32", "bfloat16"):
            x = xc.to(getattr(torch, dtype))
            y, st = sk.ssd_intra_chunk_cuda(x, dtc, cum, tot, Bc, Cc)
            torch.cuda.synchronize()
            y_p, st_p = ssd_intra_chunk_ref(x, dtc, cum, tot, Bc, Cc)
            shape = f"b={b} nc={nc} Q={Q} H={H} P={P} N={N}"
            err = max(compare(f"ssd {label} {shape} {dtype} y", y, y_p,
                              dtype, SSD_TOL[dtype]),
                      compare(f"ssd {label} {shape} {dtype} states", st,
                              st_p, dtype, SSD_TOL[dtype]))
            err_max = max(err_max, err) if dtype == "float32" else err_max
            line = (f"[ssd] {label:7s} {shape} {dtype} x: "
                    f"max_abs_err={err:.3g}")
            if "dt_zero_from" in opts:
                # the dt = 0 steps must add exactly nothing, whatever x
                xz = x.clone()
                xz[:, :, opts["dt_zero_from"]:] = 0
                y0, st0 = sk.ssd_intra_chunk_cuda(xz, dtc, cum, tot, Bc, Cc)
                if not (torch.equal(y0, y) and torch.equal(st0, st)):
                    fail(f"ssd {label} {dtype}: the dt = 0 steps changed "
                         "the outputs")
                line += " (dt = 0 steps add exactly 0)"
            if timed and dtype == "float32":
                iters = 500 if Q <= 64 else 50
                def kern():
                    return sk.ssd_intra_chunk_cuda(x, dtc, cum, tot, Bc, Cc)
                ms, dev = time_ms(kern, iters), device_ms(kern, iters)
                plain = time_ms(lambda: ssd_intra_chunk_ref(
                    x, dtc, cum, tot, Bc, Cc), max(iters // 5, 10))
                # context only: the two contractions of the plain version
                # with their weights precomputed
                pairs_w = torch.randn(b, nc, Q, Q, H, device="cuda")
                wB = Bc.expand(b, nc, Q, H, N).contiguous()
                two = time_ms(lambda: (
                    torch.einsum("bclmh,bcmhp->bclhp", pairs_w, x),
                    torch.einsum("bcqhn,bcqhp->bchpn", wB, x)),
                    max(iters // 5, 10))
                (b_ms, b_by), (o_ms, o_by) = ssd_bounds(b, nc, Q, H, P, N)
                line += (f" ms={ms:.4f} device_ms={dev:.5f} "
                         f"plain_ms={plain:.4f} "
                         f"two_einsum_ms={two:.4f} bound_ms={b_ms:.6f} "
                         f"({b_by}; f32-FMA bound {o_ms:.6f}, {o_by})")
                if label == "main":
                    main = dict(max_abs_err=err, ms=ms, device_ms=dev,
                                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                f32_fma_bound_ms=o_ms, library_ms=None,
                                shape=f"{shape} float32 (mamba2-1.3b "
                                      "prefill of 8 tokens)")
            print(line)
    print(f"[ssd] {2 * len(cases)} cases agree; largest float32 "
          f"|kernel - plain| {err_max:.3g}")
    main["max_abs_err"] = err_max
    return main


def attn_layers(cfg) -> int:
    """Attention layers a prefill or decode step runs (flash or decode
    launches per call)."""
    from repro_torch.models.transformer import n_shared_apps
    return {"ssm": 0, "hybrid": n_shared_apps(cfg)}.get(cfg.family,
                                                        cfg.n_layers)


def free_card() -> None:
    """Drop what the last phase left, before a model of tens of GB."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


class MoEInputs:
    """Every MoE layer's input, call by call (forward pre-hooks), to
    recompute its routes with ``repro_torch.models.moe.route``."""

    def __init__(self, model):
        self.calls = []
        self.hooks = [blk.moe.register_forward_pre_hook(
            lambda mod, args, i=i: self.calls.append((i, args[0].clone())))
            for i, blk in enumerate(model.layers)]

    def routes(self, model) -> list:
        from repro_torch.models.moe import route
        return [route(model.layers[i].moe.w_router, x, model.cfg.moe)
                for i, x in self.calls]

    def remove(self):
        for h in self.hooks:
            h.remove()


def route_flips(arch: str, kern: list, plain: list, tie: float = 1e-5
                ) -> set:
    """Hold the kernel path's routes (each token's top-k set and keep
    mask) to the plain path's, call by call.  A difference at a router
    margin (k-th minus (k+1)-th probability) below ``tie`` is a near tie
    that the two paths' float32 rounding may break either way: it is
    reported with its position and its sequence is returned, to be left
    out of the comparison of logits.  Any other difference fails."""
    import torch
    rows = set()
    for call, (a, b) in enumerate(zip(kern, plain)):
        ia, oa = a.gate_idx.sort(-1)
        ib, ob = b.gate_idx.sort(-1)
        ka, kb = a.keep.gather(-1, oa), b.keep.gather(-1, ob)
        diff = ((ia != ib) | (ka != kb)).any(-1)
        margin = torch.minimum(a.margin, b.margin)
        for bi, si in diff.nonzero().tolist():
            m = margin[bi, si].item()
            where = f"{arch} MoE call {call} token (b={bi}, s={si})"
            if m >= tie:
                fail(f"{where}: routes differ at router margin {m:.3g}: "
                     f"kernel {ia[bi, si].tolist()} keep "
                     f"{ka[bi, si].tolist()}, plain {ib[bi, si].tolist()} "
                     f"keep {kb[bi, si].tolist()}")
            print(f"[model] {where}: near-tie route flip at margin "
                  f"{m:.3g}; sequence {bi} left out of the logits check")
            rows.add(bi)
    return rows


def check_full_model(arch: str, prompt_len: int, max_len: int,
                     depth: int = 0) -> None:
    """Kernel path vs plain path, full width (depth cut to ``depth``
    layers if given), float32: a prefill of 4 prompts and 3 decode steps
    with the last slot inactive; the kernel path launches flash once per
    attention layer (or shared-block application) of the prefill and
    decode once per such layer of each step (an int8 cache: the FMA
    kernel's int8 variant, float32 q).  vlm: the prompts' first n_prefix
    positions are ``synth_vision_embeds``.  audio (no cache): the forward
    over 2 x ``prompt_len`` frames, flash once per layer.  moe: the
    routes of both paths are held equal (``route_flips``), and the
    prefill's and steps' drop shares printed."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models import frontends
    from repro_torch.models.transformer import Transformer
    free_card()
    cfg = configs.get(arch).replace(dtype="float32", attn_impl="kernel")
    if depth:
        cfg = cfg.replace(n_layers=depth)
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator("cuda").manual_seed(1)
    audio = cfg.family == "audio"
    moe = cfg.family == "moe"
    if audio:
        prompts = frontends.synth_audio_frames(cfg, gen, 2, prompt_len)
        steps = ()
    else:
        prompts = torch.randint(0, cfg.vocab, (4, prompt_len), generator=gen,
                                device="cuda")
        steps = torch.randint(0, cfg.vocab, (3, 4), generator=gen,
                              device="cuda")
    vision = (frontends.synth_vision_embeds(cfg, gen, 4)
              if cfg.family == "vlm" else None)
    active = torch.tensor([True, True, True, False], device="cuda")
    n_mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    n_attn = attn_layers(cfg)
    variant = decode_variant("float32", cfg.head_dim, cfg.int8_cache)
    runs, routes = {}, {}
    cache = {}
    for impl in ("kernel", "dense"):
        model.set_attn_impl(impl)
        sk.launches = fk.launches = 0
        dk.variant_launches.update(dict.fromkeys(dk.VARIANTS, 0))
        inputs = MoEInputs(model) if moe else None
        if audio:
            out = [model(prompts)]
        else:
            cache, logits = model.prefill(prompts, max_len,
                                          vision_embeds=vision)
            if sk.launches != (n_mamba if impl == "kernel" else 0):
                fail(f"{arch} {impl} prefill: {sk.launches} ssd_scan "
                     f"launches for {n_mamba} Mamba layers")
            out = [logits[:, 0]]
            for tok in steps:
                cache, logits = model.decode_step(cache, tok, active=active)
                out.append(logits[:, 0])
        if moe:
            routes[impl] = inputs.routes(model)
            inputs.remove()
        # [calls, sequences, ...]
        runs[impl] = torch.stack(out).float()
        on = impl == "kernel"
        want = {v: (len(steps) * n_attn if on and v == variant else 0)
                for v in dk.VARIANTS}
        if fk.launches != (n_attn if on else 0) or \
                dk.variant_launches != want:
            fail(f"{arch} {impl}: flash launched {fk.launches} times, "
                 f"decode {dk.variant_launches}; expected "
                 f"{n_attn if on else 0} and {want}")
    if cfg.int8_cache and cache["k"].dtype != torch.int8:
        fail(f"{arch}: the cache is {cache['k'].dtype}, not int8")
    torch.cuda.synchronize()
    a, b = runs["kernel"], runs["dense"]
    shape = ((1, 2, prompt_len) if audio else (4, 4)) + (cfg.vocab_padded,)
    if not torch.isfinite(a).all() or tuple(a.shape) != shape:
        fail(f"{arch}: full-width logits non-finite or of shape "
             f"{tuple(a.shape)}")
    flipped = set()
    if moe:
        flipped = route_flips(arch, routes["kernel"], routes["dense"])
        n_layers = cfg.n_layers
        r_pre = routes["kernel"][:n_layers]
        r_dec = routes["kernel"][n_layers:]
        drop_pre = [1 - r.keep.float().mean().item() for r in r_pre]
        drop_dec = [1 - r.keep.float().mean().item() for r in r_dec]
        experts = [len(set(r.gate_idx[bi][r.keep[bi]].tolist()))
                   for r in r_pre for bi in range(4)]
        print(f"[model] {arch} MoE: capacity {r_pre[0].capacity} at the "
              f"{prompt_len}-token prefill, moe_drop_frac per layer "
              f"{min(drop_pre):.4f}-{max(drop_pre):.4f} (mean "
              f"{sum(drop_pre) / len(drop_pre):.4f}), experts used per "
              f"sequence and layer {min(experts)}-{max(experts)} (mean "
              f"{sum(experts) / len(experts):.2f}) of "
              f"{cfg.moe.n_experts}; decode capacity "
              f"{r_dec[0].capacity}, moe_drop_frac {max(drop_dec):.4f}")
        if max(drop_dec) != 0:
            fail(f"{arch}: a decode step dropped an assignment")
    keep = [i for i in range(a.shape[1]) if i not in flipped]
    a, b = a[:, keep], b[:, keep]
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    kv = cache["k"].dtype if "k" in cache else "no"
    print(f"[model] {arch} full width float32, {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B params, {kv} KV cache "
          f"(flash x{n_attn}, decode {variant} x{len(steps) * n_attn}), "
          f"{prompt_len}-token {'frames' if audio else 'prompts'}"
          f"{' with vision prefix' if vision is not None else ''}: "
          f"kernel vs plain max|dlogits|={err:.3g} (limit "
          f"{1e-3 * scale:.3g} = 1e-3*max|logits|) over {len(keep)} "
          f"sequences, top-1 agreement {top1:.3f} over "
          f"{a[..., 0].numel()} positions, "
          f"{time.perf_counter() - t0:.1f} s")
    if err > 1e-3 * scale:
        fail(f"{arch}: full-width kernel path disagrees with the plain path")
    del model, runs, routes, a, b, cache
    free_card()


SCHEDULE_KEYS = ("mean_turnaround", "median_turnaround", "p99_turnaround",
                 "mean_rte", "total_ctx")


def count_plain_calls(counts: dict):
    """Wrap the attention kernels' plain versions and the model's plain
    attention layers so that each call adds one to ``counts``; returns a
    function that puts the originals back."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import layers
    targets = [(dops, "decode_attention_ref"), (fops, "flash_attention_ref"),
               (layers, "decode_attention"), (layers, "dense_attention")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper
    for mod, name, fn in saved:
        setattr(mod, name, counted(name, fn))

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return restore


def run_main_path(arch: str, policies, replicas: int = 1,
                  card: str = "") -> dict:
    """serve.main on ``arch`` under each policy, over ``replicas`` engines
    (behind the router when more than one); returns launches per kernel,
    summed over the policies and the engines.  Decode launches are also
    counted by variant (``mma``, ``mma_int8``, ...; the dense family must
    run only the one its cache calls for), and no call may reach a plain
    attention version."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer
    free_card()
    cfg = configs.get(arch)
    variant = decode_variant(cfg.dtype, cfg.head_dim, cfg.int8_cache)
    # kernel launches per prefill (ssd_scan, flash) and per decode step
    n_mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    n_attn = attn_layers(cfg)
    per = {"flash_attention": n_attn, "decode_attention": n_attn,
           "ssd_scan": n_mamba}
    finite = []
    plain_logits = Transformer._logits

    def checked_logits(self, x):
        logits = plain_logits(self, x)
        finite.append(torch.isfinite(logits).all())
        return logits

    totals = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    plain = {}
    Transformer._logits = checked_logits
    restore = count_plain_calls(plain)
    try:
        for policy in policies:
            args = SERVE_ARGS + ["--arch", arch, "--policy", policy]
            if replicas > 1:
                args += ["--replicas", str(replicas)]
            finite.clear()
            plain.clear()
            fk.launches = dk.launches = sk.launches = 0
            dk.variant_launches.update(dict.fromkeys(dk.VARIANTS, 0))
            s = serve.main(args)
            n = {"flash_attention": fk.launches,
                 "decode_attention": dk.launches, "ssd_scan": sk.launches}
            variants = {v: c for v, c in dk.variant_launches.items() if c}
            ok = bool(torch.stack(finite).all()) if finite else False
            synth = serve.main(args + ["--synthetic"])
            keys = SCHEDULE_KEYS + (("dispatch_counts",) if replicas > 1
                                    else ())
            same = all(s[k] == synth[k] for k in keys)
            label = "serve" if replicas == 1 else "replicas"
            print(f"[{label}] {arch} {policy} x{replicas}: "
                  f"decode_tok_per_s={s['decode_tok_per_s']:.1f} "
                  f"wall_s={s['wall_s']:.3f} ticks={s['ticks']} "
                  f"ms_per_tick={1e3 * s['wall_s'] / s['ticks']:.2f} "
                  f"prefills={s['prefills']} "
                  f"decode_steps={s['decode_steps']} launches {n} "
                  f"decode variants {variants}"
                  + (f" dispatch_counts={s['dispatch_counts']}"
                     if replicas > 1 else "")
                  + f"; schedule == --synthetic run: {same}"
                  + (f" ({card})" if card else ""))
            if s["incomplete"] or s["n"] != 48:
                fail(f"{arch} {policy}: {s['incomplete']} requests "
                     "incomplete")
            if not ok:
                fail(f"{arch} {policy}: NaN or infinite logits")
            calls = {"flash_attention": s["prefills"],
                     "decode_attention": s["decode_steps"],
                     "ssd_scan": s["prefills"]}
            want = {k: calls[k] * per[k] for k in per}
            if n != want:
                fail(f"{arch} {policy}: launches {n}, expected {want} "
                     f"({s['prefills']} prefills, {s['decode_steps']} "
                     f"decode steps, {n_mamba} Mamba layers, {n_attn} "
                     "attention layers)")
            if any(per[k] and n[k] == 0 for k in per):
                fail(f"{arch} {policy}: a kernel of the path never ran")
            if plain:
                fail(f"{arch} {policy}: plain attention ran: {plain}")
            if arch in DENSE_ARCHS + FAMILY_ARCHS and variants != {
                    variant: n["decode_attention"]}:
                fail(f"{arch} {policy}: decode variants {variants}, "
                     f"expected only {variant}")
            if not same:
                fail(f"{arch} {policy}: schedule differs from the "
                     "--synthetic run: " + ", ".join(
                         f"{k} {s[k]} vs {synth[k]}" for k in keys))
            if replicas > 1 and (len(s["dispatch_counts"]) != replicas
                                 or min(s["dispatch_counts"]) == 0):
                fail(f"{arch} {policy}: a replica received no requests: "
                     f"{s['dispatch_counts']}")
            for key in totals:
                totals[key] += n[key]
    finally:
        Transformer._logits = plain_logits
        restore()
    return totals


def traced_kernels(prof) -> list:
    """(name, µs) of every device operation a profile traced, read from
    the raw trace: building torch.profiler's Python event tree takes
    minutes at half a million operations."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def profile_main_path(arch: str, n_requests: int) -> None:
    """Where the time goes: one profiled serving run (sfs, after the main
    path has warmed the card), with the device's busy share, device
    operations per tick, the port's kernels' shares and the kernels by
    device time.  Only the device's activity is traced: tracing the host's
    operators as well records the same device operations but takes
    several times as long to collect the events.  Profiling still slows
    the host, so the busy share is a lower bound.  Reports; fails only
    for a model with Mamba layers whose profile shows no ssd_scan device
    time, or not one traced ssd_scan kernel per launch (and in
    ``profile_decode_steps``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import Engine, EngineConfig
    free_card()
    cfg = configs.get(arch)
    has_ssd = cfg.family in ("ssm", "hybrid")
    model = Transformer(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    engine = Engine(EngineConfig(lanes=4, n_slots=32, max_len=192,
                                 policy="sfs"), model, device="cuda")
    wl = serve.synth_workload(n_requests, 4, 1.0, seed=1)
    rng = np.random.default_rng(1)
    prompts = {r.rid: rng.integers(0, cfg.vocab, 8) for r in wl}
    torch.cuda.synchronize()
    sk.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(wl, prompts=prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ssd_launches = sk.launches
    kernels = traced_kernels(prof)
    busy = sum(us for _, us in kernels) / 1e6
    ticks = engine.t
    print(f"[profile] {arch} sfs {n_requests} requests: {ticks} ticks, "
          f"{engine.n_prefills} prefills, {engine.n_decode_steps} decode "
          f"steps, wall {wall:.3f} s ({1e3 * wall / ticks:.2f} ms/tick), "
          f"{len(kernels)} device ops ({len(kernels) / ticks:.0f}/tick)")
    if busy <= 0:
        print("[profile] no device activity traced: busy share not measured")
        if has_ssd:
            fail(f"{arch} profile: no ssd_scan device time traced")
        return
    print(f"[profile] device busy {busy:.3f} s = {100 * busy / wall:.1f}% "
          f"of wall (idle {100 * (1 - busy / wall):.1f}%), "
          f"{1e3 * busy / ticks:.3f} ms of device time per tick")
    for kernel, names in (("decode_attention", ("decode_mma_kernel",
                                                "decode_fma_kernel")),
                          ("flash_attention", ("flash_mma_kernel",
                                               "flash_fwd_kernel")),
                          ("ssd_scan", ("ssd_scan_kernel",))):
        hits = [us for name, us in kernels if any(n in name for n in names)]
        t = sum(hits) / 1e3
        print(f"[profile]   {kernel}: {t:.3f} ms = "
              f"{100 * t / 1e3 / busy:.2f}% of busy, {t / ticks:.4f} ms "
              f"per tick, {len(hits)} kernels traced")
        if kernel == "ssd_scan" and has_ssd:
            if t <= 0:
                fail(f"{arch} profile: no ssd_scan device time traced")
            if len(hits) != ssd_launches:
                fail(f"{arch} profile: {len(hits)} ssd_scan kernels traced "
                     f"for {ssd_launches} launches")
    by_name = {}
    for name, us in kernels:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us / 1e3)
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"[profile]   {ms:9.2f} ms {100 * ms / 1e3 / busy:5.1f}% "
              f"x{n:6d}  {name[:90]}")
    if arch in FAMILY_ARCHS:
        profile_decode_steps(arch, model, engine.cache, 1e3 * busy / ticks)
    del model, engine
    free_card()


def profile_decode_steps(arch: str, model, cache: dict, busy_per_tick: float,
                         n_steps: int = 4) -> None:
    """One decode step of all 32 slots at full width, against its bytes
    bound: every weight read once (the embedding table: the B rows a
    step gathers) and each slot's cached keys and values (and int8
    scales) once.  ``n_steps`` steps under torch.profiler with the host's
    operators and their input shapes: device ms per step, the MoE
    experts' share (the ``aten::bmm`` calls on the stacked expert
    weights), and a check that no operator copies a weight tensor of 64
    MB or more (a permuted expert contraction would copy 1.2 GB a layer
    and step).  Fails on such a copy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    B = cache["pos"].shape[0]
    emb = model.embed.weight if model.embed is not None else None
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters()
                  if p is not emb)
    if emb is not None:
        w_bytes += B * emb.shape[1] * emb.element_size()
    kv_len = cache["pos"].clamp(max=cache["k"].shape[2]).sum().item()
    per_entry = sum(cache[k][0, 0, 0].numel() * cache[k].element_size()
                    for k in ("k", "v", "k_scale", "v_scale") if k in cache)
    kv_bytes = cfg.n_layers * kv_len * per_entry
    bound = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    big = {tuple(p.shape) for p in model.parameters()
           if p.numel() * p.element_size() >= 64 << 20}
    experts = set()
    if cfg.family == "moe":
        m = model.layers[0].moe
        experts = {tuple(m.w_gate.shape), tuple(m.w_down.shape)}
    gen = torch.Generator("cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (n_steps, B), generator=gen,
                         device="cuda")
    model.decode_step(cache, toks[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for tok in toks:
            model.decode_step(cache, tok)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev = sum(e.device_time_total for e in kernels) / 1e3 / n_steps
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    exp_ms = sum(e.device_time_total for e in ops if e.name == "aten::bmm"
                 and len(e.input_shapes) > 1
                 and tuple(e.input_shapes[1]) in experts) / 1e3 / n_steps
    copies = [e for e in ops if e.name in (
        "aten::copy_", "aten::clone", "aten::contiguous", "aten::_to_copy")
        and any(tuple(sh) in big for sh in e.input_shapes)]
    largest = max((e.device_time_total for e in kernels
                   if "copy" in e.name.lower()), default=0) / 1e3
    print(f"[profile] {arch} decode step, B={B}, {n_steps} steps: "
          f"{dev:.3f} ms of device time a step against a bytes bound of "
          f"{bound:.3f} ms ({(w_bytes + kv_bytes) / 1e9:.2f} GB: weights "
          f"{w_bytes / 1e9:.2f}, KV cache {kv_bytes / 1e9:.3f}; "
          f"{100 * bound / dev:.1f}% of it); the serving run's "
          f"{busy_per_tick:.3f} ms of device time a tick is "
          f"{busy_per_tick / bound:.2f}x the bound; {len(kernels) / n_steps:.0f} "
          f"device ops a step; largest copy kernel {largest:.4f} ms")
    if cfg.family == "moe":
        print(f"[profile] {arch} MoE experts (aten::bmm on the stacked "
              f"weights): {exp_ms:.3f} ms a step = {100 * exp_ms / dev:.1f}% "
              f"of device time")
        if exp_ms <= 0:
            print(f"[profile] {arch}: no device time attributed to the "
                  "expert bmm operators: the experts' share is not "
                  "measured")
    if copies:
        fail(f"{arch} profile: {len(copies)} operators copy a weight tensor "
             f"(e.g. {copies[0].name} {copies[0].input_shapes})")


# ---------------------------------------------------------------------------
# training (repro_torch.train, repro_torch.launch.train)
# ---------------------------------------------------------------------------

# qwen2.5-3b at full width and depth in bfloat16: 8 x 512 tokens a step,
# one microbatch, AdamW; 6 steps, a checkpoint at step 3
TRAIN_ARGS = ["--full", "--device", "cuda", "--batch", "8", "--seq", "512",
              "--log-every", "1", "--seed", "0"]
TRAIN_STEPS, TRAIN_CKPT = 6, 3
# steps 4-6 after the restore against the continuous run: CUDA's
# embedding backward adds with atomics, so two runs from one state
# differ in the last bits of a bfloat16 gradient
RESUME_RTOL = 1e-2
# float32 train-step parity, card against the card's host CPU
PARITY_LOSS_RTOL = 1e-5
PARITY_GRAD = 1e-4          # max |g_card - g_cpu| <= this * max |g_cpu|
PARITY_LR, PARITY_WARMUP = 1e-3, 5


def kernel_launches() -> dict:
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.group_pick import kernel as gk
    from repro_torch.kernels.ssd_scan import kernel as sk
    return {"flash_attention": fk.launches, "decode_attention": dk.launches,
            "ssd_scan": sk.launches, "group_pick": gk.launches}


def state_bits(state) -> list:
    """A position-weighted sum of the raw bits of every tensor of a train
    state (params, optimizer state) plus its counters: equal lists mean
    a bit-exact state, up to a collision of the weighted sums."""
    import torch
    tensors = [p for _, p in state["model"].named_parameters()]
    opt = state["opt"]
    for key in ("m", "v"):
        tensors += list(opt.get(key, {}).values())
    sums = []
    for t in tensors:
        flat = t.detach().reshape(-1)
        flat = flat.view(torch.int16 if flat.element_size() == 2
                         else torch.int32)
        acc = torch.zeros((), dtype=torch.int64, device=flat.device)
        for c in flat.split(1 << 26):
            w = torch.arange(1, c.numel() + 1, device=c.device) % 65521
            acc += (w * c.long()).sum()
        sums.append(acc)
    return torch.stack(sums).tolist() + [opt["count"], state["step"]]


def print_train_log(label: str, log: list, tokens: int) -> None:
    for r in log:
        print(f"[train] {label} step {r['step']}: loss {r['loss']:.6f} "
              f"|g| {r['grad_norm']:.6f} {r['ms']:.1f} ms "
              f"{tokens / r['ms'] * 1e3:,.0f} tok/s")


def continue_training(state, start: int, stop: int) -> list:
    """Steps start+1..stop of the launcher's loop on ``state`` (its
    optimizer, data and train step, as ``--full --batch 8 --seq 512
    --seed 0`` build them), logged as ``launch.train.main`` logs."""
    import torch
    from repro_torch.train.data import DataConfig, DataIterator
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.step import make_train_step
    cfg = state["model"].cfg
    step = make_train_step(cfg, get_optimizer(cfg.optimizer))
    it = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=512,
                                 global_batch=8, seed=0), start_step=start)
    log = []
    for i in range(start, stop):
        t = time.perf_counter()
        state, m = step(state, next(it))
        log.append({"step": i + 1, "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "ms": 1e3 * (time.perf_counter() - t)})
    torch.cuda.synchronize()
    return log


def train_full_qwen() -> dict:
    """qwen2.5-3b at full width and depth through the launcher: 3 steps
    with a checkpoint at step 3, then on to step 6 in the same process
    (the straight run); the launcher's resume restores the checkpoint
    into a fresh state, which must equal the step-3 state bit for bit,
    and its steps 4-6 must equal the straight run's within RESUME_RTOL."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch import train as launch
    tokens = 8 * 512
    base = TRAIN_ARGS + ["--arch", ARCH, "--steps", str(TRAIN_CKPT),
                         "--ckpt-dir"]
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t = time.perf_counter()
        state, cont = launch.main(base + [d, "--ckpt-every",
                                          str(TRAIN_CKPT)])
        save_s = time.perf_counter() - t - sum(r["ms"] for r in cont) / 1e3
        want = state_bits(state)
        cont += continue_training(state, TRAIN_CKPT, TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in state["model"].parameters())
        prof = profile_train_step(state)
        del state
        free_card()
        print_train_log("straight", cont, tokens)
        nbytes = sum(os.path.getsize(os.path.join(r, f))
                     for r, _, fs in os.walk(d) for f in fs)
        # --steps 3 with --resume: the restored state, no step taken
        t = time.perf_counter()
        state, none = launch.main(base + [d, "--resume"])
        restore_s = time.perf_counter() - t
        if none or state_bits(state) != want:
            fail("the restored checkpoint is not the saved state bit for "
                 "bit")
        print(f"[train] checkpoint step {TRAIN_CKPT}: {nbytes / 1e9:.2f} GB; "
              f"the launcher's init, 3 steps' host snapshot and write took "
              f"{save_s:.1f} s beside the steps, its init and restore "
              f"{restore_s:.1f} s; restored bit for bit")
        res = continue_training(state, TRAIN_CKPT, TRAIN_STEPS)
        del state
        free_card()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print_train_log("resumed", res, tokens)
    worst = 0.0
    for a, b in zip(res, cont[TRAIN_CKPT:]):
        for key in ("loss", "grad_norm"):
            rel = abs(a[key] - b[key]) / abs(b[key])
            worst = max(worst, rel)
            if not np.isfinite(a[key]) or rel > RESUME_RTOL:
                fail(f"resumed step {a['step']} {key} {a[key]} against "
                     f"{b[key]} straight (rel {rel:.3g} > {RESUME_RTOL})")
    ms = float(np.median([r["ms"] for r in cont[1:]]))
    print(f"[train] {ARCH} full: {n_params / 1e9:.3f} B params, bf16, "
          f"AdamW, batch 8 x 512; median step {ms:.1f} ms "
          f"({tokens / ms * 1e3:,.0f} tok/s) over steps 2-{TRAIN_STEPS}; "
          f"peak {peak / 2**30:.2f} GiB allocated; resumed steps within "
          f"rel {worst:.3g} of the straight run")
    return {"ms": ms, "peak_gib": peak / 2**30, **prof}


def train_step_flops(cfg, B: int, S: int) -> tuple:
    """(bf16 GEMM FLOP, float32 attention FLOP) of one dense train step
    under per-layer remat: 6 x matmul params x tokens, the layers'
    forward once more, and the plain attention's two float32 einsums
    (every (q, k) pair, 4 passes: forward, recompute, two backward)."""
    T = B * S
    d, hd, kvd = cfg.d_model, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim
    layer = d * hd + 2 * d * kvd + hd * d + 3 * d * cfg.d_ff
    head = d * cfg.vocab_padded
    gemm = 6 * (cfg.n_layers * layer + head) * T + 2 * cfg.n_layers * layer * T
    attn = 4 * cfg.n_layers * 4 * B * cfg.n_heads * S * S * cfg.head_dim
    return gemm, attn


def profile_train_step(state) -> dict:
    """One more full-width step, split by CUDA events into forward +
    backward and the optimizer, then a whole step under torch.profiler
    (device activity only): busy share and the operations bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.transformer import loss_fn
    from repro_torch.train.data import DataConfig, make_batch
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.step import make_train_step
    model = state["model"]
    cfg = model.cfg
    opt = get_optimizer(cfg.optimizer)
    B, S = 8, 512
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B, seed=1), 100)
    dev = {k: v.to(model.device) for k, v in batch.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    names, params = zip(*model.named_parameters())
    torch.cuda.synchronize()
    ev[0].record()
    loss, _ = loss_fn(model, dev)
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    ev[1].record()
    opt.update(grads, state["opt"], model)
    ev[2].record()
    torch.cuda.synchronize()
    fb_ms, opt_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    del grads, loss
    step = make_train_step(cfg, opt)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kern) / 1e3
    gemm_ms = sum(e.device_time_total for e in kern
                  if re.search(r"gemm|sm90|cutlass|nvjet", e.name)) / 1e3
    gemm, attn = train_step_flops(cfg, B, S)
    bound_ms = (gemm / PEAK_FLOPS["bfloat16"]
                + attn / PEAK_FLOPS["float32"]) * 1e3
    print(f"[train] {cfg.name} step split: forward+backward {fb_ms:.1f} ms, "
          f"optimizer {opt_ms:.1f} ms (CUDA events); profiled step "
          f"{wall:.1f} ms wall, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%), {len(kern)} device ops, GEMM "
          f"kernels {gemm_ms:.1f} ms; operations bound {bound_ms:.1f} ms "
          f"({gemm:.3g} bf16 GEMM FLOP, {attn:.3g} f32 attention FLOP)")
    return {"fb_ms": fb_ms, "opt_ms": opt_ms, "busy": busy / wall,
            "bound_ms": bound_ms}


def train_full_mamba() -> None:
    """mamba2-1.3b at full width and depth: bf16, microbatch 2 (its
    config's), scan accumulation in float32, 3 steps."""
    import torch
    from repro_torch.launch import train as launch
    arch = "mamba2-1.3b"
    state, log = launch.main(TRAIN_ARGS + ["--arch", arch, "--steps", "3"])
    cfg = state["model"].cfg
    if cfg.microbatch != 2 or cfg.grad_accum != "scan":
        fail(f"{arch} trained with microbatch {cfg.microbatch}, "
             f"{cfg.grad_accum}")
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in state["model"].parameters())
    del state
    free_card()
    print_train_log(arch, log, 8 * 512)
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in log):
        fail(f"{arch}: a non-finite loss or gradient norm")
    print(f"[train] {arch} full: {n_params / 1e9:.3f} B params, median "
          f"step {np.median([r['ms'] for r in log[1:]]):.1f} ms, peak "
          f"{peak / 2**30:.2f} GiB allocated")


def parity_case(label, cfg, batch_cfg) -> None:
    """One float32 train step on the card against the same step on the
    host CPU, from the same weights and batch: the loss, every gradient,
    then the params and the optimizer state after the update."""
    import copy
    import torch
    from repro_torch.models.transformer import loss_fn
    from repro_torch.train.data import make_batch
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.step import init_train_state, make_train_step
    o = get_optimizer(cfg.optimizer, lr=PARITY_LR,
                      warmup_steps=PARITY_WARMUP)
    card = init_train_state(cfg, o, device="cuda")
    # the same weights on the host (a copy: drawing them there is slow)
    model = copy.deepcopy(card["model"]).cpu()
    cpu = {"model": model, "opt": o.init(model), "step": 0}
    batch = make_batch(batch_cfg, 0)

    def loss_and_grads(state):
        model = state["model"]
        b = {k: v.to(model.device) for k, v in batch.items()}
        l, _ = loss_fn(model, b)
        names, params = zip(*model.named_parameters())
        return l.item(), dict(zip(names, torch.autograd.grad(l, params)))

    l_cpu, g_cpu = loss_and_grads(cpu)
    l_card, g_card = loss_and_grads(card)
    if abs(l_card - l_cpu) > PARITY_LOSS_RTOL * abs(l_cpu):
        fail(f"{label}: loss {l_card} on the card, {l_cpu} on the CPU")
    worst = 0.0
    for name, g in g_cpu.items():
        gmax = g.abs().max().item()
        err = (g_card[name].cpu() - g).abs().max().item()
        worst = max(worst, err / max(gmax, 1e-30))
        if err > PARITY_GRAD * gmax:
            fail(f"{label}: grad {name} max|card - cpu| {err:.3g} > "
                 f"{PARITY_GRAD} * {gmax:.3g}")
    del g_card
    step = make_train_step(cfg, o)
    cpu, m_cpu = step(cpu, batch)
    card, m_card = step(card, batch)
    for key in ("loss", "grad_norm"):
        a, b = float(m_card[key]), float(m_cpu[key])
        if abs(a - b) > max(PARITY_LOSS_RTOL, PARITY_GRAD) * abs(b):
            fail(f"{label}: {key} {a} on the card, {b} on the CPU")
    # AdamW's first update is near sign(g): where |g| is within 100x the
    # gradient tolerance the two may differ by up to 2 lr_t
    lr_t = PARITY_LR * min(1.0, 2 / PARITY_WARMUP)
    p_card = dict(card["model"].named_parameters())
    for name, p in cpu["model"].named_parameters():
        g = g_cpu[name]
        d = (p_card[name].detach().cpu() - p.detach()).abs()
        if cfg.optimizer == "adamw":
            sure = g.abs() > 100 * PARITY_GRAD * g.abs().max()
            tight = d[sure].max().item() if bool(sure.any()) else 0.0
            if tight > 1e-6 + 1e-5 * p.detach().abs().max().item() \
                    or d.max().item() > 2 * lr_t + 1e-6:
                fail(f"{label}: param {name} after the update: "
                     f"{tight:.3g} where |g| decides, {d.max().item():.3g} "
                     "overall")
        elif d.max().item() > 1e-6 + 1e-5 * p.detach().abs().max().item():
            fail(f"{label}: param {name} after the update differs by "
                 f"{d.max().item():.3g}")
    print(f"[parity] {label}: loss {l_card:.7f} (cpu {l_cpu:.7f}), worst "
          f"grad max|card - cpu| / max|g| {worst:.3g}, |g| "
          f"{float(m_card['grad_norm']):.6f} (cpu "
          f"{float(m_cpu['grad_norm']):.6f})")


def train_parity() -> None:
    """qwen2.5-3b at full width cut to 2 layers (AdamW, one microbatch),
    and reduced llama3-405b (Adafactor, fused, 2 microbatches)."""
    from repro_torch import configs
    from repro_torch.train.data import DataConfig
    cfg = configs.get(ARCH).replace(n_layers=2, dtype="float32")
    parity_case(f"{ARCH} full width, 2 layers", cfg,
                DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=2,
                           seed=5))
    free_card()
    cfg = configs.get_reduced("llama3-405b").replace(dtype="float32")
    parity_case("llama3-405b reduced", cfg,
                DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                           seed=5))


def train_reduced_qwen() -> None:
    """As tests/test_train.py's test_loss_decreases, on the card."""
    import torch
    from repro_torch import configs
    from repro_torch.train.data import DataConfig, DataIterator
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = configs.get_reduced(ARCH)
    o = adamw(lr=1e-3, warmup_steps=5)
    state = init_train_state(cfg, o, device="cuda")
    step = make_train_step(cfg, o)
    it = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=32,
                                 global_batch=4, seed=3))
    losses = []
    for _ in range(25):
        state, m = step(state, next(it))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    print(f"[train] {ARCH} reduced: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} in 25 steps")
    if not losses[-1] < losses[0] - 0.3:
        fail(f"reduced {ARCH}: loss fell {losses[0] - losses[-1]:.4f}, "
             "not more than 0.3")


def run_training() -> dict:
    """Every training phase; no hand-written kernel may launch in them
    (training runs the plain paths)."""
    before = kernel_launches()
    out = {}
    t = time.perf_counter()
    out["qwen"] = train_full_qwen()
    print(f"[time]   {ARCH} train: {time.perf_counter() - t:.1f} s")
    for label, fn in (("mamba2-1.3b train", train_full_mamba),
                      ("train parity", train_parity),
                      (f"reduced {ARCH}", train_reduced_qwen)):
        t = time.perf_counter()
        fn()
        print(f"[time]   {label}: {time.perf_counter() - t:.1f} s")
    if kernel_launches() != before:
        fail(f"training launched a kernel: {before} -> {kernel_launches()}")
    return out


# ---------------------------------------------------------------------------
# sharding (repro_torch.sharding, repro_torch.launch.dryrun)
# ---------------------------------------------------------------------------

SHARDED_STEPS = 2
# the first step's loss, sharded on the one-rank mesh against unsharded,
# from the same weights and batch (the forward is the same arithmetic);
# its gradient norm and the second step take RESUME_RTOL: the bfloat16
# gradients differ in last bits (the vocab-parallel loss's float32
# arithmetic), and AdamW's near-sign first update carries that into the
# second step's weights
SHARDED_RTOL = 1e-5
# the dry run's cells on the card's host: (arch, shape, multi-pod)
DRYRUN_CELLS = (("qwen2.5-3b", "train_4k", False),
                ("qwen2.5-3b", "decode_32k", False),
                ("qwen3-moe-30b-a3b", "prefill_32k", True))


def train_steps(plan, cfg, batches, count_comms: bool) -> dict:
    """SHARDED_STEPS steps of ``cfg`` from seed 0 (under ``plan``, or
    unsharded): losses, gradient norms, ms a step, peak allocated memory
    and, with ``count_comms``, the collectives of one more step, as the
    dry run's recorder counts the functional collectives DTensor runs
    (CommDebugMode's module tracker of torch 2.11 fails inside the
    per-layer checkpoint: an IndexError in its forward hook)."""
    import torch
    from repro_torch.launch.dryrun import CellRecorder
    from repro_torch.sharding.plan import use_plan
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.step import init_train_state, make_train_step
    opt = get_optimizer(cfg.optimizer)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(cfg, opt, device="cuda", generator=gen,
                             plan=plan)
    step = make_train_step(cfg, opt)
    out = {"loss": [], "grad_norm": [], "ms": []}
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        with use_plan(plan):
            state, m = step(state, b)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        out["ms"].append(1e3 * (time.perf_counter() - t))
        out["loss"].append(loss)
        out["grad_norm"].append(gn)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if count_comms:
        rec = CellRecorder([])
        with use_plan(plan), rec:
            step(state, batches[-1])
        torch.cuda.synchronize()
        out["comms"] = {}
        for c in rec.collectives:
            n, b = out["comms"].get(c["op"], (0, 0))
            out["comms"][c["op"]] = (n + 1, b + c["payload_bytes"])
    del state
    free_card()
    return out


def run_sharded_training() -> None:
    """qwen2.5-3b at full width and depth (bfloat16, AdamW, batch
    8 x 512): SHARDED_STEPS steps sharded by ``Plan(mesh,
    fsdp=cfg.fsdp)`` on the one-rank ``(1, 1)`` mesh of
    ``make_host_mesh`` (a one-rank NCCL group), then as many unsharded
    from the same seed and batches; no kernel launches."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.plan import Plan
    from repro_torch.train.data import DataConfig, DataIterator
    before = kernel_launches()
    cfg = configs.get(ARCH)
    it = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=512,
                                 global_batch=8, seed=0))
    batches = [next(it) for _ in range(SHARDED_STEPS)]
    mesh = make_host_mesh(device_type="cuda")
    if tuple(mesh.mesh.shape) != (1, 1):
        fail(f"the host mesh of one card is {tuple(mesh.mesh.shape)}")
    try:
        sh = train_steps(Plan(mesh=mesh, fsdp=cfg.fsdp), cfg, batches, True)
    finally:
        dist.destroy_process_group()
    un = train_steps(None, cfg, batches, False)
    for label, r in (("sharded", sh), ("unsharded", un)):
        print(f"[sharded] {ARCH} {label}: loss "
              f"{' '.join(f'{x:.7f}' for x in r['loss'])} |g| "
              f"{' '.join(f'{x:.6f}' for x in r['grad_norm'])}; ms a step "
              f"{' '.join(f'{x:.1f}' for x in r['ms'])}; peak "
              f"{r['peak_gib']:.2f} GiB allocated")
    print(f"[sharded] collectives of one more sharded step on the (1, 1) "
          f"mesh (count, payload B): {sh['comms']}")
    for key in ("loss", "grad_norm"):
        for i, (a, b) in enumerate(zip(sh[key], un[key])):
            rel = abs(a - b) / abs(b)
            bits = "bit-equal" if a == b else f"rel {rel:.3g}"
            print(f"[sharded] step {i + 1} {key}: {bits}")
            if not np.isfinite(a):
                fail(f"sharded step {i + 1}: {key} {a}")
            tol = SHARDED_RTOL if (i, key) == (0, "loss") else RESUME_RTOL
            if rel > tol:
                fail(f"sharded step {i + 1} {key} {a} against {b} "
                     f"unsharded (rel {rel:.3g} > {tol})")
    if kernel_launches() != before:
        fail("sharded training launched a kernel")


def run_dry_run() -> None:
    """The port's dry run of DRYRUN_CELLS on a fake process group of 256
    or 512 ranks, on the card's host (fake CUDA tensors: nothing is
    allocated), one process a cell; each record's per-device bytes,
    FLOPs and collectives printed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch, shape, multi_pod in DRYRUN_CELLS:
        mesh = "pod2x16x16" if multi_pod else "pod16x16"
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--force", "--device", "cuda"]
            + (["--multi-pod"] if multi_pod else []),
            capture_output=True, text=True, env=env, cwd=str(ROOT),
            timeout=600)
        if r.returncode != 0:
            fail(f"dry run {arch} {shape} {mesh}: "
                 f"{(r.stdout + r.stderr)[-3000:]}")
        path = ROOT / "artifacts" / "dryrun_torch" / \
            f"{arch}__{shape}__{mesh}.json"
        rec = json.loads(path.read_text())
        m = rec["memory"]
        ops = {op: (c["count"], c["payload_bytes"])
               for op, c in rec["collectives"]["by_op"].items()}
        print(f"[dryrun] {arch} {shape} {mesh}: params "
              f"{m['param_bytes']} B, optimizer {m['opt_state_bytes']} B, "
              f"cache {m['cache_bytes']} B, peak {m['peak_device_bytes']} B "
              f"a device; {rec['cost']['flops_per_device']:.6g} FLOP a "
              f"device; collectives (count, payload B) {ops}; "
              f"{rec['seconds']:.1f} s traced, "
              f"{time.perf_counter() - t:.1f} s with the process")
        if rec["cost"]["flops_per_device"] <= 0 or not ops:
            fail(f"dry run {arch} {shape}: an empty record")


# ---------------------------------------------------------------------------
# the fleet-stepping path (repro_torch.serving.torch_cluster)
# ---------------------------------------------------------------------------


def pick_inputs(rng, G: int, cap: int, kmax: int):
    """Keys like the tick body's: heavy vruntime ties, unique rids, ~30%
    INT32_MAX sentinel slots, row 0 empty and row 1 (when there is one)
    holding fewer valid keys than kmax."""
    import torch
    from repro_torch.kernels.group_pick.ref import IMAX
    vr = rng.integers(0, 6, (G, cap)).astype(np.int32)
    rid = rng.permutation(G * cap).reshape(G, cap).astype(np.int32)
    hole = rng.random((G, cap)) < 0.3
    hole[0] = True
    if G > 1:
        hole[1] = True
        hole[1, rng.choice(cap, size=max(1, kmax // 2), replace=False)] = \
            False
    vr[hole] = IMAX
    rid[hole] = IMAX
    return (torch.from_numpy(vr).cuda(), torch.from_numpy(rid).cuda())


def check_group_pick() -> dict:
    """Kernel vs plain, exact, at every case (CAP 32 to 256 take the
    register variant with 1, 2, 4 and 8 keys a lane, 1024 and 4096 the
    shared-memory one; kmax 40 stores two 32-round chunks and runs past
    CAP 32); timed at the fleet shape (G=1024, CAP=32, kmax=8) beside the
    device time of a one-element PyTorch kernel, the empty-launch
    floor."""
    import torch
    from repro_torch.kernels.group_pick import kernel as gk
    from repro_torch.kernels.group_pick.ref import pick_order_ref
    rng = np.random.default_rng(5)
    n_cases, err = 0, 0
    for G in (1, 7, 1024):
        for cap in (32, 33, 64, 100, 256, 1024, 4096):
            for kmax in (1, 4, 8, 40):
                vr, rid = pick_inputs(rng, G, cap, kmax)
                got = gk.pick_order_cuda(vr, rid, kmax)
                torch.cuda.synchronize()
                want = pick_order_ref(vr, rid, kmax)
                if got.shape != want.shape or not torch.equal(got, want):
                    bad = (got != want).nonzero()[:5].tolist()
                    fail(f"group_pick G={G} CAP={cap} kmax={kmax}: kernel "
                         f"differs from plain at {bad}")
                err = max(err, int((got.long() - want.long()).abs().max()))
                n_cases += 1
    G, cap, kmax = FLEET["engines"], 32, FLEET["lanes"]
    vr, rid = pick_inputs(rng, G, cap, kmax)
    ms = time_ms(lambda: gk.pick_order_cuda(vr, rid, kmax), 2000)
    dev = device_ms(lambda: gk.pick_order_cuda(vr, rid, kmax), 500)
    plain = time_ms(lambda: pick_order_ref(vr, rid, kmax), 200)

    def sort_pair():          # two stable sorts, as pick_order_ref of the
        o1 = torch.sort(rid, dim=1, stable=True).indices   # JAX package
        vr1 = torch.gather(vr, 1, o1)
        o2 = torch.sort(vr1, dim=1, stable=True).indices
        return torch.gather(o1, 1, o2)[:, :kmax]
    sorts = time_ms(sort_pair, 200)
    nbytes = 2 * G * cap * 4 + G * kmax * 4
    b_ms, b_by = bound(nbytes, 0, "float32")
    floor = empty_launch_ms()
    print(f"[pick] {n_cases} cases equal (G in 1,7,1024; CAP in 32,33,64,"
          f"100,256,1024,4096; kmax in 1,4,8,40); G={G} CAP={cap} "
          f"kmax={kmax}: ms={ms:.5f} device_ms={dev:.5f} "
          f"plain_ms={plain:.5f} bound_ms={b_ms:.7f} ({b_by}) "
          f"empty_launch_device_ms={floor:.5f} "
          f"sort_pair_ms={sorts:.5f} (context only: two stable sorts, "
          "which differ from the kernel on the tail columns)")
    return dict(max_abs_err=float(err), ms=ms, device_ms=dev, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                empty_launch_device_ms=floor,
                shape=f"G={G} CAP={cap} kmax={kmax} int32")


def empty_launch_ms() -> float:
    """Device time of a one-element PyTorch kernel: what any launch
    costs the card, the floor of a launch-bound kernel."""
    import torch
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    return device_ms(lambda: one.add_(1), 500)


def build_old(old_dir: Path):
    """The C entries of an earlier ssd_scan.cu and group_pick.cu (e.g.
    ``git show <commit>:src/repro_torch/csrc/ssd_scan.cu``), built with
    the port's nvcc flags into build/repro_torch/old_*.so."""
    import ctypes
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("ssd_scan", "group_pick"):
        out = _build.BUILD_DIR / f"old_{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
               str(old_dir / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"old {name}.cu: nvcc exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    ssd = libs["ssd_scan"].ssd_intra_chunk_fwd
    ssd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    ssd.restype = ctypes.c_int
    pick = libs["group_pick"].group_pick_fwd
    pick.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    pick.restype = ctypes.c_int
    return ssd, pick


def compare_old(old_dir: str, gen) -> None:
    """Time an earlier ssd_scan and group_pick against the present ones in
    turns (old, new, new, old) at the main path's shapes, zamba2's N = 64
    and a full chunk, on the same inputs, with the empty-launch floor
    timed in the same turns; both versions are held to the plain one."""
    import torch
    from repro_torch.kernels.group_pick import kernel as gk
    from repro_torch.kernels.group_pick.ref import pick_order_ref
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    ssd_old, pick_old = build_old(Path(old_dir))
    stream = torch.cuda.current_stream().cuda_stream

    def turns(fns: dict, iters: int) -> dict:
        got = {k: [] for k in fns}
        for who in ("old", "new", "new", "old"):
            got[who].append((time_ms(fns[who], iters),
                             device_ms(fns[who], iters)))
        return got

    def fmt(rows):
        return ("ms " + " ".join(f"{m:.5f}" for m, _ in rows)
                + " device_ms " + " ".join(f"{d:.5f}" for _, d in rows))

    for label, shape in (("main", (1, 1, 8, 64, 64, 128)),
                         ("zamba2", (1, 1, 8, 64, 64, 64)),
                         ("chunk", (2, 8, 256, 64, 64, 128))):
        b, nc, Q, H, P, N = shape
        args = ssd_inputs(gen, *shape)

        def old(args=args, b=b, nc=nc, Q=Q, H=H, P=P, N=N):
            y = torch.empty(b, nc, Q, H, P, device="cuda")
            st = torch.empty(b, nc, H, P, N, device="cuda")
            err = ssd_old(*(t.data_ptr() for t in args), y.data_ptr(),
                          st.data_ptr(), b, nc, Q, H, P, N, 0, stream)
            if err:
                fail(f"old ssd_scan: CUDA error {err}")
            return y, st

        def new(args=args):
            return sk.ssd_intra_chunk_cuda(*args)
        want = ssd_intra_chunk_ref(*args)
        for who, fn in (("old", old), ("new", new)):
            got = fn()
            torch.cuda.synchronize()
            for o, w, what in zip(got, want, ("y", "states")):
                compare(f"{who} ssd {label} {what}", o, w, "float32",
                        SSD_TOL["float32"])
        rows = turns({"old": old, "new": new}, 500 if Q <= 64 else 50)
        (b_ms, b_by), (o_ms, _) = ssd_bounds(*shape)
        print(f"[turns] ssd {label} b={b} nc={nc} Q={Q} H={H} P={P} N={N} "
              f"float32 (old, new, new, old): old {fmt(rows['old'])}; new "
              f"{fmt(rows['new'])}; bound_ms={b_ms:.6f} ({b_by}), f32-FMA "
              f"bound {o_ms:.6f}")

    rng = np.random.default_rng(6)
    G, cap, kmax = FLEET["engines"], 32, FLEET["lanes"]
    vr, rid = pick_inputs(rng, G, cap, kmax)

    def pold():
        out = torch.empty(G, kmax, dtype=torch.int32, device="cuda")
        err = pick_old(vr.data_ptr(), rid.data_ptr(), out.data_ptr(), G,
                       cap, kmax, stream)
        if err:
            fail(f"old group_pick: CUDA error {err}")
        return out

    def pnew():
        return gk.pick_order_cuda(vr, rid, kmax)
    want = pick_order_ref(vr, rid, kmax)
    if not (torch.equal(pold(), want) and torch.equal(pnew(), want)):
        fail("group_pick old or new differs from plain at the fleet shape")
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    rows = turns({"old": pold, "new": pnew}, 2000)
    floor = [device_ms(lambda: one.add_(1), 500) for _ in range(2)]
    print(f"[turns] group_pick G={G} CAP={cap} kmax={kmax} (old, new, new, "
          f"old): old {fmt(rows['old'])}; new {fmt(rows['new'])}; "
          f"empty_launch_device_ms {floor[0]:.5f} {floor[1]:.5f}")


def request_fields(reqs) -> list:
    """Every per-request field the engines mutate."""
    return [(r.rid, r.finish, r.served_ticks, r.n_ctx, r.demoted,
             r.first_start, r.queue_delay, r.queue_enter, r.vruntime,
             r.slice_left, r.tokens_done, r.prefill_done, r.slot)
            for r in reqs]


def check_fleet_cpu_vs_cuda() -> None:
    """64 engines x 4 lanes: the CUDA run equals the CPU run, and the
    host backends (engine="tick" and "vector") equal the CUDA run."""
    import dataclasses
    from repro_torch.core.spec import (ExperimentSpec, ServerSpec,
                                       TickWorkloadSpec, run_experiment)
    spec = ExperimentSpec(
        servers=tuple(ServerSpec(cores=4) for _ in range(64)),
        dispatch="sfs-aware", predictor="history",
        workload=TickWorkloadSpec(n=250, load=1.0, seed=23))
    runs = {dev: run_experiment(spec, max_ticks=2_000_000, device=dev)
            for dev in ("cpu", "cuda")}
    for engine in ("tick", "vector"):
        runs[engine] = run_experiment(
            dataclasses.replace(spec, engine=engine), max_ticks=2_000_000,
            device="cuda")
    b = runs["cuda"]
    for other in ("cpu", "tick", "vector"):
        a = runs[other]
        same = {"requests": request_fields(a.raw) == request_fields(b.raw),
                "dispatch_counts": a.dispatch_counts == b.dispatch_counts,
                "eta_log": a.eta_log == b.eta_log,
                "overload_bypasses": (a.overload_bypasses
                                      == b.overload_bypasses)}
        print(f"[fleet64] 64x4 n=250 sfs-aware history: cuda == {other} "
              f"{same}, n={a.n} fingerprint {a.fingerprint()[:16]}")
        if not all(same.values()) or a.n != 250:
            fail(f"fleet 64x4: the CUDA run differs from the {other} run")


def recorded(scenario: str, policy: str, load: float) -> dict:
    rows = [r for r in json.loads(BASELINES.read_text())["rows"]
            if r["scenario"] == scenario and r["policy"] == policy
            and r["load"] == load]
    if len(rows) != 1:
        fail(f"{BASELINES.name}: {len(rows)} rows for {scenario} "
             f"{policy} load {load}")
    return rows[0]


def check_chaos() -> None:
    from repro_torch.launch import fleet
    c = CHAOS
    for policy in ("sfs-aware", "hash"):
        want = recorded("chaos", policy, c["load"])
        r = fleet.run(policy, c["engines"], c["lanes"], c["load"], c["n"],
                      c["seed"], device="cuda", workload=c["workload"],
                      lifecycle=c["lifecycle"], faults=c["faults"],
                      retry=c["retry"])
        fp = r["fingerprint"][:16]
        print(f"[chaos] {policy}: fingerprint {fp} shed {r['shed']} "
              f"(recorded {want['provenance']['result_fp']} / "
              f"{want['shed']}), short p99 {r['short_p99']}, wall "
              f"{r['wall_s']:.2f} s, stepped ticks {r['stepped_ticks']}")
        if fp != want["provenance"]["result_fp"] or r["shed"] != want["shed"]:
            fail(f"chaos {policy}: differs from the recorded row")


def recorded_spec(scenario: str, policy: str, load: float) -> dict:
    """ExperimentSpec fields of a ``run_elastic`` or ``run_chaos`` row of
    ``benchmarks/cluster_sweep.py`` (16 x 4 engines, 20,000 requests),
    built as those functions build them."""
    from repro_torch.core.spec import ServerSpec
    wl = f"bimodal:n=20000,seed=7,load={load}|zipf:funcs=16,s=1.1"
    spec = dict(servers=tuple(ServerSpec(cores=4) for _ in range(16)),
                dispatch=policy)
    if scenario == "elastic":
        return dict(spec, workload=wl + "|flash:at=1000,x=2,dur=1000",
                    lifecycle="lifecycle:cold=2,ttl=400,cap=8,"
                              "fail=2600,fail_server=3",
                    scaling="scale:min=12,T=25,up=0.6,down=0.15,step=2")
    return dict(spec, workload=wl, lifecycle=CHAOS["lifecycle"],
                faults=CHAOS["faults"], retry=CHAOS["retry"])


def run_recorded(job) -> tuple:
    """One recorded row on one host backend: (fingerprint[:16], shed,
    submitted, wall s).  Runs in a worker process."""
    scenario, policy, load, engine = job
    from repro_torch.core.spec import ExperimentSpec, run_experiment
    res = run_experiment(
        ExperimentSpec(engine=engine,
                       **recorded_spec(scenario, policy, load)),
        max_ticks=50_000_000, device="cuda")
    return res.fingerprint()[:16], res.shed, res.n + res.shed, res.wall_s


def check_recorded_rows(pool) -> None:
    """The port's host backends on all eight elastic and chaos rows of
    BENCH_cluster.json (recorded on the JAX package's vector backend):
    engine="vector" reproduces every row's fingerprint and shed count,
    engine="tick" the elastic rows' and, on the chaos rows, the JAX
    package's tick backend's (``TICK_CHAOS``).  The 16 runs are host code
    only and share nothing, so they run in worker processes, several at
    a time."""
    jobs = [(sc, pol, load, engine) for sc in ("elastic", "chaos")
            for load in (0.6, 0.8) for pol in ("sfs-aware", "hash")
            for engine in ("vector", "tick")]
    results = pool.map(run_recorded, jobs, chunksize=1)
    bad = []
    for (sc, pol, load, engine), (fp, shed, n, wall) in zip(jobs, results):
        row = recorded(sc, pol, load)
        want, what = (row["provenance"]["result_fp"], row["shed"]), "recorded"
        if engine == "tick" and sc == "chaos":
            want, what = TICK_CHAOS[(pol, load)], "JAX package's tick"
        ok = (fp, shed) == want and n == row["n"]
        print(f"[recorded] {sc} {pol} load={load} {engine}: fingerprint "
              f"{fp} shed {shed} n {n} ({what} {want[0]} / {want[1]} / "
              f"{row['n']}) wall {wall:.2f} s: "
              f"{'equal' if ok else 'DIFFERS'}")
        if not ok:
            bad.append(f"{sc} {pol} {load} {engine}")
    if bad:
        fail("recorded rows differ: " + "; ".join(bad))


def des_rows() -> list:
    """(label, row) of every recorded DES row: the ``layer: "des"`` rows
    of BENCH_cluster.json, then the rows of BENCH_predict.json."""
    out = []
    for r in json.loads(BASELINES.read_text())["rows"]:
        if r.get("layer") == "des":
            out.append((f"cluster {r['scenario']} {r['policy']} "
                        f"load={r['load']}", r))
    for r in json.loads(PREDICT_BASELINES.read_text())["rows"]:
        out.append((f"predict {r['predictor']} {r['dispatch']} "
                    f"load={r['load']} {r['iat']}", r))
    return out


def workload_digest(reqs) -> str:
    """First 16 hex of the SHA-256 of a FaaSBench request stream."""
    import hashlib
    return hashlib.sha256(repr([
        (r.rid, r.arrival, r.service, r.io_events, r.func_id)
        for r in reqs]).encode()).hexdigest()[:16]


def run_des_job(job) -> tuple:
    """One seed of a recorded DES row through
    ``repro_torch.run_experiment(engine="des")``, or one GOLDEN_HINTED
    run through ``simulate_cluster``: (fingerprint, service, turnaround,
    rte, wall s, workload digest).  Runs in a worker process."""
    import dataclasses
    import hashlib
    from repro_torch.core import (ClusterSimConfig, FaaSBenchConfig,
                                  SimConfig, generate, simulate_cluster)
    from repro_torch.core.spec import ExperimentSpec, run_experiment
    kind, prov, seed = job
    t = time.perf_counter()
    if kind == "golden":
        g = GOLDEN_CFG
        reqs = generate(FaaSBenchConfig(n_requests=g["n"],
                                        cores=g["servers"] * g["cores"],
                                        load=g["load"], seed=g["seed"]))
        res = simulate_cluster(reqs, ClusterSimConfig(
            n_servers=g["servers"], dispatch=prov, predictor="oracle",
            server=SimConfig(cores=g["cores"], policy="sfs")))
        blob = repr([(s.rid, s.finish, s.n_ctx, s.demoted)
                     for s in res.merged.stats]).encode()
        return (hashlib.sha256(blob).hexdigest(), None, None, None,
                time.perf_counter() - t, workload_digest(reqs))
    if kind == "cluster":
        spec = ExperimentSpec.from_json(prov["spec"])
        spec = dataclasses.replace(spec, workload=dataclasses.replace(
            spec.workload, seed=seed))
        res = run_experiment(spec, device="cuda")
        wall = time.perf_counter() - t
        digest = workload_digest(generate(spec.workload))
    else:
        # the recorded spec has no workload: its generator config rides
        # beside it, and the requests are generated per seed
        spec = ExperimentSpec.from_json(prov["spec"])
        wl = ExperimentSpec.from_json(dict(
            prov["spec"], workload=prov["workload"])).workload
        reqs = generate(dataclasses.replace(wl, seed=seed))
        res = run_experiment(spec, requests=reqs, device="cuda")
        wall = time.perf_counter() - t
        digest = workload_digest(reqs)
    return (res.fingerprint()[:16], res.service, res.turnaround, res.rte,
            wall, digest)


def check_des_rows(pool) -> None:
    """The port's DES on every recorded DES row (25 rows, two seeds
    each) and the three GOLDEN_HINTED digests, in worker processes.
    Each seed's fingerprint must equal the recorded one, or for the two
    seeds of ``DES_REDRAWN``, the JAX package's own on the workload this
    host draws, which must be the one it was taken on."""
    from repro_torch.core.metrics import bucket_stats
    rows = des_rows()
    jobs, owner = [], []
    for i, (label, row) in enumerate(rows):
        kind = "cluster" if label.startswith("cluster") else "predict"
        for seed in row["provenance"]["seed"]:
            jobs.append((kind, row["provenance"], seed))
            owner.append(i)
    jobs += [("golden", d, None) for d in GOLDEN_HINTED]
    t = time.perf_counter()
    results = pool.map(run_des_job, jobs, chunksize=1)
    wall = time.perf_counter() - t
    bad = []
    for i, (label, row) in enumerate(rows):
        got = [res for res, o in zip(results, owner) if o == i]
        fps = [g[0] for g in got]
        want = list(row["provenance"]["result_fp"])
        for k, (seed, g) in enumerate(zip(row["provenance"]["seed"], got)):
            if (label, seed) in DES_REDRAWN:
                digest, want[k] = DES_REDRAWN[(label, seed)]
                print(f"[des] {label} seed {seed}: workload {g[5]} "
                      f"(the JAX package's fingerprint {want[k]} is of "
                      f"workload {digest}; recorded "
                      f"{row['provenance']['result_fp'][k]})")
                if g[5] != digest:
                    bad.append(f"{label} seed {seed} workload")
        b = bucket_stats(np.concatenate([g[1] for g in got]),
                         np.concatenate([g[2] for g in got]),
                         np.concatenate([g[3] for g in got]))
        keys = list(b)
        n = sum(len(g[1]) for g in got)
        p99 = (b[keys[0]]["p99"], b[keys[-1]]["p99"])
        ok = (fps == want and n == row["n"]
              and p99 == (row["short_p99"], row["long_p99"]))
        print(f"[des] {label}: fingerprints {fps} (expected {want}), n "
              f"{n}, short/long p99 "
              f"{p99[0]!r}/{p99[1]!r} (recorded {row['short_p99']!r}/"
              f"{row['long_p99']!r}), wall {sum(g[4] for g in got):.3f} s: "
              f"{'equal' if ok else 'DIFFERS'}")
        if not ok:
            bad.append(label)
    for (_, dispatch, _), res in zip(jobs[-len(GOLDEN_HINTED):],
                                     results[-len(GOLDEN_HINTED):]):
        ok = res[0] == GOLDEN_HINTED[dispatch]
        print(f"[des] golden hinted {dispatch}: sha256 {res[0]} wall "
              f"{res[4]:.3f} s: {'equal' if ok else 'DIFFERS'}")
        if not ok:
            bad.append(f"golden {dispatch}")
    print(f"[des] {len(jobs)} runs ({len(rows)} rows, "
          f"{len(GOLDEN_HINTED)} goldens): {sum(r[4] for r in results):.3f}"
          f" s of worker wall in {wall:.3f} s")
    if bad:
        fail("DES rows differ: " + "; ".join(bad))


def run_fleet_main_path() -> int:
    """launch.fleet at 1024 x 8 under sfs-aware and hash; returns the
    group_pick launches of the two runs."""
    from repro_torch.kernels.group_pick import kernel as gk
    from repro_torch.launch import fleet
    from repro_torch.serving.torch_cluster import _SCAN_CHUNK
    total = 0
    for policy in ("sfs-aware", "hash"):
        want = recorded("fleet1024", policy, FLEET["load"])
        argv = ["--policy", policy, "--device", "cuda"] + [
            a for k, v in FLEET.items() for a in (f"--{k}", str(v))]
        gk.launches = 0
        r = fleet.main(argv)
        n = gk.launches
        scans = r["phases"].get("torch_scan", {}).get("calls", 0)
        expect = r["stepped_ticks"] + _SCAN_CHUNK * scans
        fp = r["fingerprint"][:16]
        print(f"[fleet1024] {policy}: fingerprint {fp} (recorded "
              f"{want['provenance']['result_fp']}), short p99 "
              f"{r['short_p99']} long p99 {r['long_p99']} (recorded "
              f"{want['short_p99']}/{want['long_p99']}), group_pick "
              f"launches {n} = {r['stepped_ticks']} stepped ticks + "
              f"{_SCAN_CHUNK} x {scans} chunks")
        if fp != want["provenance"]["result_fp"] or r["n"] != FLEET["n"]:
            fail(f"fleet1024 {policy}: differs from the recorded row")
        if n == 0 or n != expect:
            fail(f"fleet1024 {policy}: {n} group_pick launches, expected "
                 f"{expect}")
        total += n
    return total


def profile_fleet() -> None:
    """Where the fleet's time goes: one short 1024 x 8 run (sfs-aware,
    20,000 requests) under torch.profiler.  Reports, never fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import fleet
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = fleet.run("sfs-aware", FLEET["engines"], FLEET["lanes"],
                      FLEET["load"], 20_000, FLEET["seed"], device="cuda")
        torch.cuda.synchronize()
    wall = r["wall_s"]
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e6
    pick = sum(e.device_time_total for e in kernels
               if "group_pick" in e.name) / 1e6
    from repro_torch.serving.torch_cluster import _SCAN_CHUNK
    steps = r["stepped_ticks"]
    # tick bodies the device ran: stepped ticks and every chunk's 64,
    # rolled-back chunks included
    bodies = max(steps + _SCAN_CHUNK * r["phases"].get(
        "torch_scan", {}).get("calls", 0), 1)
    print(f"[fprofile] 1024x8 sfs-aware n=20000: finish tick "
          f"{r['ticks']}, {steps} stepped ticks, {r['scan_chunks']} "
          f"chunks, {bodies} tick bodies, wall {wall:.3f} s, "
          f"{len(kernels)} device ops ({len(kernels) / bodies:.0f} per "
          f"tick body)")
    if busy <= 0:
        print("[fprofile] no device activity traced: busy share not "
              "measured")
        return
    print(f"[fprofile] device busy {busy:.4f} s = {100 * busy / wall:.2f}% "
          f"of wall (idle {100 * (1 - busy / wall):.2f}%), "
          f"{1e3 * busy / bodies:.3f} ms per tick body; group_pick "
          f"{pick * 1e3:.3f} ms = {100 * pick / busy:.2f}% of busy")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total / 1e3)
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[fprofile]   {ms:9.3f} ms {100 * ms / 1e3 / busy:5.1f}% "
              f"x{n:6d}  {name[:90]}")
    print(f"[fprofile] phases {json.dumps(r['phases'])}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", metavar="DIR",
                    help="also time ssd_scan.cu and group_pick.cu from DIR "
                         "(an earlier version) against the present ones")
    opts = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()

    def phase(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[time] {label}: {time.perf_counter() - t:.1f} s")
        return out
    card = device_line()
    phase("build", build_kernels)
    gen = torch.Generator("cuda").manual_seed(0)
    flash = phase("flash", check_flash, gen)
    decode = phase("decode", check_decode, gen)
    ssd = phase("ssd_scan", check_ssd, gen)
    # before the serving profiles: after them, device_ms of a long kernel
    # read as little as half its time by CUDA events
    if opts.old_csrc:
        phase("old vs new", compare_old, opts.old_csrc, gen)
    phase(f"{ARCH} full width", check_full_model, ARCH, 8, 192)
    for arch in SSM_ARCHS:
        phase(f"{arch} full width", check_full_model, arch, 300, 320)
    for arch in DENSE_ARCHS:
        phase(f"{arch} full width", check_full_model, arch, 8, 192)
    for arch, prompt_len, max_len, depth in FAMILY_CHECKS:
        phase(f"{arch} full width", check_full_model, arch, prompt_len,
              max_len, depth)
    launches = phase(f"{ARCH} serving", run_main_path, ARCH, ("sfs", "cfs"))
    for arch in SSM_ARCHS + DENSE_ARCHS + FAMILY_ARCHS:
        for name, n in phase(f"{arch} serving", run_main_path, arch,
                             ("sfs",), 1, card).items():
            launches[name] += n
    for arch in REPLICA_ARCHS:
        for name, n in phase(f"{arch} replicas", run_main_path, arch,
                             ("sfs",), 2, card).items():
            launches[name] += n
    phase(f"{ARCH} profile", profile_main_path, ARCH, 16)
    for arch in SSM_ARCHS + ("gemma-7b",) + FAMILY_ARCHS:
        phase(f"{arch} profile", profile_main_path, arch, 8)
    phase("training", run_training)
    phase("sharded training", run_sharded_training)
    phase("dry run", run_dry_run)
    pick = phase("group_pick", check_group_pick)
    phase("fleet 64x4", check_fleet_cpu_vs_cuda)
    phase("chaos", check_chaos)
    # the recorded host-backend rows and the DES rows are host code that
    # shares nothing: one pool of worker processes runs both
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
        phase("recorded rows", check_recorded_rows, pool)
        phase("des rows", check_des_rows, pool)
    launches["group_pick"] = phase("fleet1024", run_fleet_main_path)
    phase("fleet profile", profile_fleet)
    kernels = []
    for name, rec, line in (("flash_attention", flash, 71),
                            ("decode_attention", decode, 69),
                            ("group_pick", pick, 55),
                            ("ssd_scan", ssd, 53)):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{name}.cu",
                        "replaces": f"src/repro/kernels/{name}/kernel.py:"
                                    f"{line}",
                        "launches": launches[name], **rec})
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
