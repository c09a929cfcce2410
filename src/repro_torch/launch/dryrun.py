"""Dry run: trace every (arch x shape x mesh) cell on a fake process
group of the production size, with nothing allocated.

The port of ``repro.launch.dryrun``.  For each cell it:

  1. starts a fake process group of 256 (pod16x16) or 512 (pod2x16x16)
     ranks in this one process (``torch.testing``'s ``fake`` backend:
     collectives return at once) and builds the production mesh;
  2. builds the cell's state under ``FakeTensorMode`` (shapes, dtypes,
     devices; no storage) and shards it by the arch's plan;
  3. runs the cell's entry point once, as rank 0: the train step
     (``train_4k``), prefill (``prefill_32k``; the forward for the
     encoder-only audio arch) or the decode step (``decode_32k``,
     ``long_500k``).  Every cell builds the model by
     ``training_config``: the reference's blocked attention
     (``attn_impl="blocked"``) unless ``--set attn_impl=dense``; no
     hand-written kernel runs on fake tensors;
  4. records, per device: the bytes of params, optimizer state and
     cache from the local shard shapes; the peak of the live bytes
     (``CellRecorder``: ``MemTracker``'s method, without the ops of
     DTensor's sharding propagation); FLOPs from ``FlopCounterMode``'s
     formulas applied to the local operations; the collectives by op,
     each with its payload bytes and group size, as DTensor runs them
     (the functional collectives ``CommDebugMode`` counts), with the
     wire bytes of the reference's ring formulas (``collective_census``);
     and the seconds the cell took;
  5. writes a JSON artifact to ``artifacts/dryrun_torch/``.

Where the reference compiles one HLO per cell and reads XLA's
``memory_analysis``/``cost_analysis``, the port runs the cell's
operations themselves.  The whole depth is traced (every layer, every
microbatch), so the reference's ``extrapolate_cost`` probes, which
correct XLA's count of a scanned layer body, have no counterpart.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k [--multi-pod] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (CACHE_AXES, Transformer,
                                            init_cache)
from repro_torch.sharding.plan import (Plan, shard_model, to_placements,
                                       use_plan)
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.step import (batch_placements, init_train_state,
                                    make_train_step, training_config)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

# ---------------------------------------------------------------------------
# Collective census
# ---------------------------------------------------------------------------


def collective_census(ops: list) -> dict:
    """Per-device wire-byte census of collective ops, each a dict with
    ``op``, ``payload_bytes`` (the result's bytes, as the reference reads
    them from the HLO) and ``group`` (ranks taking part).

    Ring-algorithm wire factors (bytes crossing links, per device), the
    reference's:
      all-reduce       2(n-1)/n x payload     (reduce-scatter + all-gather)
      all-gather       (n-1)/n x result       (result = gathered size)
      reduce-scatter   (n-1)   x result       (input = n x result)
      all-to-all       (n-1)/n x payload
      collective-permute  1 x payload
    """
    out = []
    for o in ops:
        n, payload = o["group"], o["payload_bytes"]
        if o["op"] == "all-reduce":
            wire = 2 * (n - 1) / max(n, 1) * payload
        elif o["op"] in ("all-gather", "all-to-all"):
            wire = (n - 1) / max(n, 1) * payload
        elif o["op"] == "reduce-scatter":
            wire = (n - 1) * payload
        else:                                   # collective-permute
            wire = payload
        out.append({**o, "wire_bytes": wire})
    by_op: dict = {}
    for o in out:
        c = by_op.setdefault(o["op"], {"count": 0, "payload_bytes": 0,
                                       "wire_bytes": 0.0})
        c["count"] += 1
        c["payload_bytes"] += o["payload_bytes"]
        c["wire_bytes"] += o["wire_bytes"]
    return {"n_collectives": len(out),
            "wire_bytes_per_device": sum(o["wire_bytes"] for o in out),
            "by_op": by_op,
            "largest": sorted(out, key=lambda o: -o["wire_bytes"])[:8]}


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CellRecorder(TorchDispatchMode):
    """Counts what one rank runs: the FLOPs of its local operations, its
    collectives, and its live bytes (each storage from its first
    appearance until it is freed; the state is counted from the start).

    DTensor operations are let through (``NotImplemented``) so that the
    local operations and collectives they run come back here, as
    ``CommDebugMode`` and ``MemTracker`` see them.  Ops that DTensor's
    sharding propagation runs on global-shape fake tensors are skipped:
    under an active ``FakeTensorMode`` DTensor runs them in that mode,
    and ``MemTracker`` counts them as the rank's memory (the dry run's
    peak would be the unsharded program's), so the peak is tracked here.
    The recorder knows them by wrapping DTensor's metadata propagation
    (``ShardingPropagator._propagate_tensor_meta_non_cached``) while it
    is active.
    """

    def __init__(self, state: list):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flops = FlopCounterMode(display=False)
        self.collectives: list = []
        self._live: dict = {}      # storage id -> (bytes, the op it came from)
        self.current = self.peak = 0
        # what the live bytes were, by op, at a point within 5% of the peak
        self.holders: dict = {}
        self._held_at = 0
        self._propagating = 0
        for t in state:
            self._track(t.to_local() if isinstance(t, DTensor) else t)

    @property
    def flops(self) -> int:
        return self._flops.get_total_flops()

    def _track(self, t: torch.Tensor, op: str = "state") -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (n, op)
        weakref.finalize(st, self._free, key)
        self.current += n
        if self.current > self.peak:
            self.peak = self.current
            if self.peak >= 1.05 * self._held_at:
                self._hold()

    def _hold(self) -> None:
        """Snapshot the live bytes by the op that made each storage
        (each new peak 5% above the last snapshot)."""
        self._held_at = self.current
        by_op: dict = {}
        for n, op in self._live.values():
            c, b = by_op.get(op, (0, 0))
            by_op[op] = (c + 1, b + n)
        top = sorted(by_op.items(), key=lambda kv: -kv[1][1])[:12]
        self.holders = {"bytes": self.current, "storages": len(self._live),
                        "by_op": {op: {"storages": c, "bytes": b}
                                  for op, (c, b) in top}}

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        self._orig = orig = SP._propagate_tensor_meta_non_cached

        def wrapped(prop, op_schema):
            self._propagating += 1
            try:
                return orig(prop, op_schema)
            finally:
                self._propagating -= 1
        SP._propagate_tensor_meta_non_cached = wrapped
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        SP._propagate_tensor_meta_non_cached = self._orig
        return super().__exit__(*exc)

    def _free(self, key) -> None:
        self.current -= self._live.pop(key, (0, None))[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        fd = torch.ops._c10d_functional
        packet = func._overloadpacket
        if packet == fd.all_gather_into_tensor:
            self._record("all-gather", _nbytes(out), args[1])
        elif packet == fd.reduce_scatter_tensor:
            self._record("reduce-scatter", _nbytes(out), args[2])
        elif packet in (fd.all_reduce, fd.all_reduce_):
            self._record("all-reduce", _nbytes(out), _group_size(args[2]))
        elif packet == fd.all_to_all_single:
            self._record("all-to-all", _nbytes(out), _group_size(args[3]))
        elif packet in (fd.broadcast, fd.broadcast_):
            self._record("collective-permute", _nbytes(out),
                         _group_size(args[2]))
        elif packet != fd.wait_tensor:
            self._flops._count_flops(packet, out, args, kwargs)
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor) and not isinstance(o, DTensor):
                self._track(o, str(packet))
        return out

    def _record(self, op: str, payload: int, group: int) -> None:
        self.collectives.append({"op": op, "payload_bytes": payload,
                                 "group": int(group)})


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------


FSDP_ONLY_RULES = {
    "heads": None, "kv_heads": None, "ff": None, "vocab": None,
    "experts": "model",                 # MoE keeps expert parallelism
    "seq": None, "kv_seq": ("data", "model"),
    "batch": ("pod", "data", "model"),
    "fsdp": ("data", "model"),
}

# MoE variant: batch does not span "model" (tokens on "data", experts on
# "model")
FSDP_EP_RULES = {
    "heads": None, "kv_heads": None, "ff": None, "vocab": None,
    "experts": "model",
    "seq": "model",
    "kv_seq": "model",
    "batch": ("pod", "data"),
    "fsdp": "data",
}


def build_plan(cfg: ModelConfig, shape_name: str, mesh) -> Plan:
    rules = dict(configs.plan_rule_overrides(cfg, shape_name))
    if cfg.sharding_profile in ("fsdp_only", "fsdp_ep"):
        base = dict(FSDP_ONLY_RULES if cfg.sharding_profile == "fsdp_only"
                    else FSDP_EP_RULES)
        if configs.SHAPES[shape_name].global_batch == 1:
            base["batch"] = None
        rules = {**base, **{k: v for k, v in rules.items()
                            if k not in ("seq", "batch")}}
        if configs.SHAPES[shape_name].global_batch == 1:
            rules["batch"] = None
        cfg_fsdp = True
    else:
        cfg_fsdp = cfg.fsdp
    return Plan(mesh=mesh, fsdp=cfg_fsdp, rules=rules)


def batch_shardings(plan: Plan, batch_specs: dict) -> dict:
    """The reference's ``_batch_shardings`` as placements."""
    return {k: batch_placements(plan, v) for k, v in batch_specs.items()}


def cache_shardings(plan: Plan, cache_specs: dict) -> dict:
    """The reference's ``_cache_shardings`` as placements (the cache the
    port builds under a plan takes these: ``transformer.CACHE_AXES``)."""
    return {k: plan.placements_of(*CACHE_AXES[k]) for k in cache_specs}


def _local_bytes(tensors) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tensors)


def _state_tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _state_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _materialize(specs: dict, device, mesh=None, placements=None) -> dict:
    """Meta tensors as (fake) tensors on ``device``, in the caller's
    ``FakeTensorMode``; with ``placements``, distributed by them on
    ``mesh`` (each rank's chunk of the global batch, as the reference's
    ``in_shardings``)."""
    out = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
           for k, v in specs.items()}
    if placements is None:
        return out
    return {k: to_placements(v, mesh, placements[k]) for k, v in out.items()}


def build_cell(cfg: ModelConfig, shape_name: str, mesh, device,
               specs: Optional[dict] = None,
               grad_compression: Optional[str] = None):
    """(plan, run, state tensors, cache tensors): ``run()`` runs the
    cell's entry point once.  Call inside ``FakeTensorMode``."""
    plan = build_plan(cfg, shape_name, mesh)
    sh = configs.SHAPES[shape_name]
    specs = specs if specs is not None else configs.input_specs(cfg,
                                                                shape_name)
    with use_plan(plan):
        if sh.kind == "train":
            opt = get_optimizer(cfg.optimizer)
            state = init_train_state(cfg, opt, device=device, plan=plan)
            step = make_train_step(cfg, opt,
                                   grad_compression=grad_compression)
            batch = _materialize(specs, device)

            def run():
                step(state, batch)
            return (plan, run, list(state["model"].parameters()),
                    _state_tensors(state["opt"]), [])

        model = Transformer(training_config(cfg), device=device)
        shard_model(model, plan)
        params = list(model.parameters())
        if sh.kind == "prefill":
            batch = _materialize(specs, device, mesh,
                                 batch_shardings(plan, specs))
            if not cfg.has_decode:
                def run():
                    model(batch["frames"])
                return plan, run, params, [], []

            def run():
                model.prefill(batch["tokens"], max_len=sh.seq_len,
                              vision_embeds=batch.get("vision_embeds"))
            return plan, run, params, [], []

        max_len = next((v.shape[2] for k, v in specs["cache"].items()
                        if k == "k"), sh.seq_len)
        cache = init_cache(cfg, specs["tokens"].shape[0], max_len,
                           device=device)
        want = cache_shardings(plan, cache)
        if any(tuple(v.placements) != tuple(want[k])
               for k, v in cache.items()):
            raise AssertionError("the cache is not placed as the "
                                 "reference's _cache_shardings")
        tokens = _materialize({"tokens": specs["tokens"]}, device, mesh, {
            "tokens": plan.placements_of("batch")})["tokens"]

        def run():
            model.decode_step(cache, tokens)
        return plan, run, params, [], list(cache.values())


def _measure(cfg: ModelConfig, shape_name: str, mesh, device,
             specs: Optional[dict] = None,
             grad_compression: Optional[str] = None) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        plan, run, params, opt_state, cache = build_cell(
            cfg, shape_name, mesh, device, specs, grad_compression)
        t_build = time.perf_counter() - t0
        rec = CellRecorder(params + opt_state + cache)
        t1 = time.perf_counter()
        with use_plan(plan), rec:
            run()
        t_run = time.perf_counter() - t1
    return {
        "build_s": t_build, "run_s": t_run,
        "rules": dict(plan.rules), "fsdp": plan.fsdp,
        "memory": {
            "param_bytes": _local_bytes(params),
            "opt_state_bytes": _local_bytes(opt_state),
            "cache_bytes": _local_bytes(cache),
            "peak_device_bytes": rec.peak,
            "peak_holders": rec.holders,
        },
        "cost": {"flops_per_device": rec.flops},
        "collectives": collective_census(rec.collectives),
    }


def _start_fake_world(multi_pod: bool) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, _ = PRODUCTION_SHAPES[multi_pod]
    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             device="cuda", cfg: Optional[ModelConfig] = None,
             variant: str = "baseline",
             grad_compression: Optional[str] = None,
             overrides: Optional[dict] = None) -> dict:
    """Trace one cell; ``overrides``: the ``--set`` values that made
    ``cfg`` from the arch's config, recorded with it."""
    if cfg is None:
        cfg = configs.get(arch)
    ok, why = configs.cell_supported(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    dev = resolve_device(device)
    _start_fake_world(multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "variant": variant, "n_devices": int(mesh.size()),
        "device": str(dev),
        "config": {"family": cfg.family, "n_layers": cfg.n_layers,
                   "overrides": dict(overrides or {}),
                   "microbatch": cfg.microbatch,
                   "fsdp": cfg.fsdp, "optimizer": cfg.optimizer,
                   "sharding_profile": cfg.sharding_profile,
                   "grad_compression": grad_compression,
                   "kv_cache_dtype": cfg.kv_cache_dtype,
                   "attn_impl": training_config(cfg).attn_impl},
    }
    result.update(_measure(cfg, shape_name, mesh, dev,
                           grad_compression=grad_compression))
    result["seconds"] = time.perf_counter() - t0
    return result


def artifact_path(arch: str, shape: str, mesh_name: str,
                  variant: str = "baseline") -> str:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    v = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(ARTIFACT_DIR, f"{arch}__{shape}__{mesh_name}{v}.json")


def summary_line(res: dict) -> str:
    m = res["memory"]
    ops = " ".join(f"{op}:{c['count']}/{c['payload_bytes'] / 2**30:.3f}GiB"
                   for op, c in sorted(res["collectives"]["by_op"].items()))
    state = m["param_bytes"] + m["opt_state_bytes"] + m["cache_bytes"]
    return (f"state/dev={state / 2**30:.3f}GiB "
            f"peak/dev={m['peak_device_bytes'] / 2**30:.3f}GiB "
            f"flops/dev={res['cost']['flops_per_device']:.4g} "
            f"coll/dev="
            f"{res['collectives']['wire_bytes_per_device'] / 2**30:.3f}"
            f"GiB [{ops}] {res['seconds']:.1f}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "int8_pod"])
    ap.add_argument("--profile", default=None,
                    choices=[None, "tp_sp", "fsdp_only", "fsdp_ep"])
    ap.add_argument("--kv-dtype", default=None,
                    choices=[None, "bfloat16", "int8"])
    ap.add_argument("--set", action="append", default=[],
                    help="cfg overrides, e.g. --set microbatch=4")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    def cfg_for(arch):
        cfg = configs.get(arch)
        if args.profile:
            cfg = cfg.replace(sharding_profile=args.profile)
        if args.kv_dtype:
            cfg = cfg.replace(kv_cache_dtype=args.kv_dtype)
        for kv in args.set:
            k, v = kv.split("=", 1)
            cur = getattr(cfg, k)
            if isinstance(cur, bool):
                v = v.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                v = int(v)
            elif isinstance(cur, float):
                v = float(v)
            cfg = cfg.replace(**{k: v})
        return cfg

    if args.all:
        cells = configs.all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures, results = [], []
    t0 = time.perf_counter()
    for mp in meshes:                 # one fake world per mesh size
        for arch, shape in cells:
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            path = artifact_path(arch, shape, mesh_name, args.variant)
            if os.path.exists(path) and not args.force:
                print(f"[cached] {arch} {shape} {mesh_name}")
                continue
            print(f"[trace] {arch} {shape} {mesh_name} ...", flush=True)
            try:
                res = run_cell(arch, shape, mp, device=args.device,
                               cfg=cfg_for(arch), variant=args.variant,
                               grad_compression=args.grad_compression,
                               overrides=dict(kv.split("=", 1)
                                              for kv in args.set))
            except Exception as e:     # a failed cell is reported, not fatal
                traceback.print_exc()
                failures.append((arch, shape, mesh_name, repr(e)))
                continue
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            results.append(res)
            if "skipped" in res:
                print(f"  skipped: {res['skipped']}")
            else:
                print("  " + summary_line(res), flush=True)
    print(f"\n{len(results)} cells in {time.perf_counter() - t0:.1f} s")
    if failures:
        print(f"{len(failures)} FAILURES:")
        for f4 in failures:
            print("  ", *f4)
        raise SystemExit(1)
    print("all requested cells traced OK")
    return results


if __name__ == "__main__":
    main()
