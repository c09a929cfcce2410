#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi) and the matmul precision
   settings, set explicitly;
2. build both CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
   sm_90a (ptxas report printed);
3. each kernel against its plain PyTorch version on the card, in float32
   (atol = rtol = 2e-5) and bfloat16 (2e-2), with kernel, plain and
   library-call times and the kernel's bound;
4. qwen2.5-3b at full width, random weights from a seed, in float32: an
   8-token prefill of 4 prompts and 3 decode steps through the kernels
   and through the plain attention; the logits must agree within
   1e-3 * max|logits|;
5. the main path: ``repro_torch.launch.serve.main`` on qwen2.5-3b at full
   width in bfloat16 under ``sfs`` and then ``cfs`` (48 requests, 4
   lanes, 32 slots, max-len 192): every request completes, no logit is
   NaN or infinite, and every prefill and every decode step launched each
   kernel once per layer;
6. where the time goes: one more serving run under torch.profiler, with
   the card's busy share and the kernels by device time (reported only);
7. the group_pick kernel against its plain version on the card, exact
   integer equality over G in {1, 7, 1024}, CAP in {32, 33, 64, 1024,
   4096} and kmax in {1, 4, 8}, with heavy vruntime ties, ~30% empty
   slots, an empty row and rows with fewer keys than kmax; kernel, plain
   and sort-pair times and the bound at the fleet shape;
8. the fleet backend at 64 engines x 4 lanes (250 requests, sfs-aware,
   history predictor): the CUDA run equals the port's own CPU run in
   every per-request field, the dispatch counts, the ETA log and the
   overload bypasses;
9. the chaos scenario of ``benchmarks/cluster_sweep.py`` (16 x 4 engines,
   load 0.8, faults + retries + shedding) on the card under sfs-aware and
   hash: fingerprint and shed count equal the recorded rows of
   ``benchmarks/baselines/BENCH_cluster.json``;
10. the fleet main path: ``repro_torch.launch.fleet`` at 1024 engines x
   8 lanes, load 0.9, 500,000 requests, seed 11, under sfs-aware and
   hash: fingerprints equal the recorded rows, and group_pick launched
   once per stepped tick and 64 times per chunk;
11. where the fleet's time goes: one short fleet run under
   torch.profiler (device operations per tick, busy share, group_pick's
   share; reported only).

It then prints one JSON line describing the three kernels and, last, the
result line ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
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
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ARCH = "qwen2.5-3b"
SERVE_ARGS = ["--arch", ARCH, "--full", "--device", "cuda", "--requests",
              "48", "--lanes", "4", "--slots", "32", "--max-len", "192",
              "--seed", "0"]
BASELINES = ROOT / "benchmarks" / "baselines" / "BENCH_cluster.json"
FLEET = dict(engines=1024, lanes=8, load=0.9, n=500_000, seed=11)
# the chaos scenario of benchmarks/cluster_sweep.py (run_chaos) at load 0.8
CHAOS = dict(
    engines=16, lanes=4, load=0.8, n=20_000, seed=7,
    workload="bimodal:n=20000,seed=7,load=0.8|zipf:funcs=16,s=1.1",
    lifecycle="lifecycle:cold=2,ttl=400,cap=8",
    faults="faults:mttf=1200,mttr=250,blast=4,episodes=3,seed=13,first=800",
    retry="retry:timeout=400,retries=2,backoff=16,shed=10")


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
                          r"decode_kernel)I(\w+?)EE", ln)
            if m:       # mangled template arguments: f / bf16, Li<D>
                args = re.sub(r"^f(?=L|$)", "f32", m.group(2).replace(
                    "13__nv_bfloat16", "bf16")).replace("Li", ",")
                entry = f"{m.group(1)}<{args}>"
            elif "entry function" in ln and "group_pick_kernel" in ln:
                entry = "group_pick_kernel"
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


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, dtype: str) -> float:
    import torch
    tol = TOL[dtype]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    err = (g - w).abs().max().item()
    if not torch.allclose(g, w, atol=tol, rtol=tol):
        fail(f"{name}: max |kernel - plain| = {err:.3g} beyond "
             f"atol = rtol = {tol}")
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
             ("long", 1, 2048, 16, 2, 128, True, "bfloat16", True),
             ("gqa", 2, 256, 16, 4, 64, True, "float32", False),
             ("gqa", 2, 256, 16, 4, 64, True, "bfloat16", False),
             ("noncausal", 2, 200, 8, 8, 80, False, "float32", False),
             ("noncausal", 2, 200, 8, 8, 80, False, "bfloat16", False),
             ("d32", 2, 96, 4, 1, 32, True, "float32", False),
             ("d16", 1, 130, 4, 2, 16, False, "bfloat16", False)]
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
        line = (f"[flash] {label:9s} B={B} S={S} H={H} K={K} D={D} "
                f"causal={causal} {dtype}: max_abs_err={err:.3g}")
        if timed:
            iters = 200 if S <= 256 else 20
            ms = time_ms(lambda: fk.flash_attention_cuda(
                q, k, v, causal=causal), iters)
            plain = time_ms(lambda: flash_attention_ref(
                q, k, v, causal=causal), iters)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), iters)
            el = q.element_size()
            nbytes = 2 * q.numel() * el + 2 * k.numel() * el
            pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
            b_ms, b_by = bound(nbytes, 4 * pairs * D, dtype)
            line += (f" ms={ms:.4f} plain_ms={plain:.4f} sdpa_ms={lib:.4f}"
                     f" bound_ms={b_ms:.6f} ({b_by})")
            if label == "main":
                main = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                            shape=f"B={B} S={S} H={H} K={K} D={D} causal "
                                  f"{dtype}")
        print(line)
    return main


def check_decode(gen) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    B, Smax, H, K, D = 32, 192, 16, 2, 128
    lens = torch.randint(1, Smax + 1, (B,), generator=gen, device="cuda")
    lens[0], lens[1], lens[2] = 0, Smax, 1
    kv_len = lens.to(torch.int32)
    main = None
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q = torch.randn(B, H, D, generator=gen, device="cuda").to(dt)
        kc = torch.randn(B, Smax, K, D, generator=gen, device="cuda").to(dt)
        vc = torch.randn(B, Smax, K, D, generator=gen, device="cuda").to(dt)
        kn = torch.randn(B, K, D, generator=gen, device="cuda").to(dt)
        vn = torch.randn(B, K, D, generator=gen, device="cuda").to(dt)
        for extra in (True, False):
            args = (q, kc, vc, kv_len) + ((kn, vn) if extra else ())
            out = dk.decode_attention_cuda(*args)
            torch.cuda.synchronize()
            err = compare(f"decode extra={extra} {dtype}", out,
                          decode_attention_ref(*args), dtype)
            line = (f"[decode] B={B} Smax={Smax} H={H} K={K} D={D} "
                    f"extra={extra} {dtype}: max_abs_err={err:.3g}")
            if dtype == "bfloat16" and extra:
                ms = time_ms(lambda: dk.decode_attention_cuda(*args), 500)
                plain = time_ms(lambda: decode_attention_ref(*args), 200)
                mask = (torch.arange(Smax, device="cuda")[None, :]
                        < kv_len[:, None])[:, None, None, :]
                qt = q[:, :, None, :]
                kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True), 200)
                el = q.element_size()
                n = kv_len.clamp(0, Smax).sum().item()
                nbytes = (2 * q.numel() * el + kv_len.numel() * 4
                          + 2 * n * K * D * el + 2 * kn.numel() * el)
                b_ms, b_by = bound(nbytes, 4 * H * D * (n + B), dtype)
                line += (f" ms={ms:.4f} plain_ms={plain:.4f} "
                         f"sdpa_ms={lib:.4f} bound_ms={b_ms:.6f} ({b_by})")
                main = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                            shape=f"B={B} Smax={Smax} H={H} K={K} D={D} "
                                  f"ragged kv_len + in-flight entry "
                                  f"{dtype}")
            print(line)
    return main


def check_full_model() -> None:
    """Kernel path vs plain path, full width, float32."""
    import torch
    from repro_torch import configs
    from repro_torch.models.transformer import Transformer
    cfg = configs.get(ARCH).replace(dtype="float32", attn_impl="kernel")
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator("cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (4, 8), generator=gen,
                            device="cuda")
    steps = torch.randint(0, cfg.vocab, (3, 4), generator=gen,
                          device="cuda")
    active = torch.tensor([True, True, True, False], device="cuda")
    runs = {}
    for impl in ("kernel", "dense"):
        model.set_attn_impl(impl)
        cache, logits = model.prefill(prompts, 192)
        out = [logits[:, 0]]
        for tok in steps:
            cache, logits = model.decode_step(cache, tok, active=active)
            out.append(logits[:, 0])
        runs[impl] = torch.stack(out).float()
    torch.cuda.synchronize()
    a, b = runs["kernel"], runs["dense"]
    if not torch.isfinite(a).all() or a.shape != (4, 4, cfg.vocab_padded):
        fail(f"full-width logits non-finite or of shape {tuple(a.shape)}")
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"[model] {ARCH} full width float32, {n_params / 1e9:.3f} B "
          f"params: kernel vs plain max|dlogits|={err:.3g} "
          f"(limit {1e-3 * scale:.3g} = 1e-3*max|logits|), top-1 agreement "
          f"{top1:.3f} over {a.shape[0] * a.shape[1]} positions, "
          f"{time.perf_counter() - t0:.1f} s")
    if err > 1e-3 * scale:
        fail("full-width kernel path disagrees with the plain path")
    del model, runs, a, b
    torch.cuda.empty_cache()


def run_main_path() -> dict:
    """serve.main under sfs and cfs; returns launches per kernel."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer
    n_layers = configs.get(ARCH).n_layers
    finite = []
    plain_logits = Transformer._logits

    def checked_logits(self, x):
        logits = plain_logits(self, x)
        finite.append(torch.isfinite(logits).all())
        return logits

    totals = {"flash_attention": 0, "decode_attention": 0}
    Transformer._logits = checked_logits
    try:
        for policy in ("sfs", "cfs"):
            finite.clear()
            fk.launches = 0
            dk.launches = 0
            s = serve.main(SERVE_ARGS + ["--policy", policy])
            n_flash, n_decode = fk.launches, dk.launches
            ok = bool(torch.stack(finite).all()) if finite else False
            print(f"[serve] {policy}: decode_tok_per_s="
                  f"{s['decode_tok_per_s']:.1f} flash launches={n_flash} "
                  f"decode launches={n_decode}")
            if s["incomplete"] or s["n"] != 48:
                fail(f"{policy}: {s['incomplete']} requests incomplete")
            if not ok:
                fail(f"{policy}: NaN or infinite logits")
            if n_flash != s["prefills"] * n_layers or n_flash == 0:
                fail(f"{policy}: {n_flash} flash launches for "
                     f"{s['prefills']} prefills x {n_layers} layers")
            if n_decode != s["decode_steps"] * n_layers or n_decode == 0:
                fail(f"{policy}: {n_decode} decode launches for "
                     f"{s['decode_steps']} decode steps x {n_layers} layers")
            totals["flash_attention"] += n_flash
            totals["decode_attention"] += n_decode
    finally:
        Transformer._logits = plain_logits
    return totals


def profile_main_path() -> None:
    """Where the time goes: one profiled serving run (sfs, 16 requests,
    after the main path has warmed the card), with the device's busy
    share and the kernels by device time.  Profiling slows the host, so
    the busy share is a lower bound.  Reports, never fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import Engine, EngineConfig
    cfg = configs.get(ARCH)
    model = Transformer(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    engine = Engine(EngineConfig(lanes=4, n_slots=32, max_len=192,
                                 policy="sfs"), model, device="cuda")
    wl = serve.synth_workload(16, 4, 1.0, seed=1)
    rng = np.random.default_rng(1)
    prompts = {r.rid: rng.integers(0, cfg.vocab, 8) for r in wl}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(wl, prompts=prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e6
    ticks = engine.t
    print(f"[profile] sfs 16 requests: {ticks} ticks, "
          f"{engine.n_prefills} prefills, {engine.n_decode_steps} decode "
          f"steps, wall {wall:.3f} s ({1e3 * wall / ticks:.2f} ms/tick), "
          f"{len(kernels)} device ops ({len(kernels) / ticks:.0f}/tick)")
    if busy <= 0:
        print("[profile] no device activity traced: busy share not measured")
        return
    print(f"[profile] device busy {busy:.3f} s = {100 * busy / wall:.1f}% "
          f"of wall (idle {100 * (1 - busy / wall):.1f}%)")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total / 1e3)
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"[profile]   {ms:9.2f} ms {100 * ms / 1e3 / busy:5.1f}% "
              f"x{n:6d}  {name[:90]}")
    del model, engine
    torch.cuda.empty_cache()


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
    """Kernel vs plain, exact, at every case; timed at the fleet shape
    (G=1024, CAP=32, kmax=8)."""
    import torch
    from repro_torch.kernels.group_pick import kernel as gk
    from repro_torch.kernels.group_pick.ref import pick_order_ref
    rng = np.random.default_rng(5)
    n_cases, err = 0, 0
    for G in (1, 7, 1024):
        for cap in (32, 33, 64, 1024, 4096):
            for kmax in (1, 4, 8):
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
    plain = time_ms(lambda: pick_order_ref(vr, rid, kmax), 200)

    def sort_pair():          # two stable sorts, as pick_order_ref of the
        o1 = torch.sort(rid, dim=1, stable=True).indices   # JAX package
        vr1 = torch.gather(vr, 1, o1)
        o2 = torch.sort(vr1, dim=1, stable=True).indices
        return torch.gather(o1, 1, o2)[:, :kmax]
    sorts = time_ms(sort_pair, 200)
    nbytes = 2 * G * cap * 4 + G * kmax * 4
    b_ms, b_by = bound(nbytes, 0, "float32")
    print(f"[pick] {n_cases} cases equal (G in 1,7,1024; CAP in 32,33,64,"
          f"1024,4096; kmax in 1,4,8); G={G} CAP={cap} kmax={kmax}: "
          f"ms={ms:.5f} plain_ms={plain:.5f} bound_ms={b_ms:.7f} ({b_by}) "
          f"sort_pair_ms={sorts:.5f} (context only: two stable sorts, "
          "which differ from the kernel on the tail columns)")
    return dict(max_abs_err=float(err), ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"G={G} CAP={cap} kmax={kmax} int32")


def request_fields(reqs) -> list:
    """Every per-request field the engines mutate."""
    return [(r.rid, r.finish, r.served_ticks, r.n_ctx, r.demoted,
             r.first_start, r.queue_delay, r.queue_enter, r.vruntime,
             r.slice_left, r.tokens_done, r.prefill_done, r.slot)
            for r in reqs]


def check_fleet_cpu_vs_cuda() -> None:
    """64 engines x 4 lanes: the CUDA run equals the CPU run."""
    from repro_torch.core.spec import (ExperimentSpec, ServerSpec,
                                       TickWorkloadSpec, run_experiment)
    spec = ExperimentSpec(
        servers=tuple(ServerSpec(cores=4) for _ in range(64)),
        dispatch="sfs-aware", predictor="history",
        workload=TickWorkloadSpec(n=250, load=1.0, seed=23))
    runs = {dev: run_experiment(spec, max_ticks=2_000_000, device=dev)
            for dev in ("cpu", "cuda")}
    a, b = runs["cpu"], runs["cuda"]
    same = {"requests": request_fields(a.raw) == request_fields(b.raw),
            "dispatch_counts": a.dispatch_counts == b.dispatch_counts,
            "eta_log": a.eta_log == b.eta_log,
            "overload_bypasses": a.overload_bypasses == b.overload_bypasses}
    print(f"[fleet64] 64x4 n=250 sfs-aware history: cuda == cpu {same}, "
          f"n={b.n} fingerprint {b.fingerprint()[:16]}")
    if not all(same.values()) or b.n != 250:
        fail("fleet 64x4: the CUDA run differs from the CPU run")


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


def main() -> int:
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
    device_line()
    build_kernels()
    gen = torch.Generator("cuda").manual_seed(0)
    flash = check_flash(gen)
    decode = check_decode(gen)
    check_full_model()
    launches = run_main_path()
    profile_main_path()
    pick = check_group_pick()
    check_fleet_cpu_vs_cuda()
    check_chaos()
    launches["group_pick"] = run_fleet_main_path()
    profile_fleet()
    kernels = []
    for name, rec, line in (("flash_attention", flash, 71),
                            ("decode_attention", decode, 69),
                            ("group_pick", pick, 55)):
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
