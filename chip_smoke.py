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
   the card's busy share and the kernels by device time (reported only).

It then prints one JSON line describing both kernels and, last, the
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
    kernels = []
    for name, rec, line in (("flash_attention", flash, 71),
                            ("decode_attention", decode, 69)):
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
