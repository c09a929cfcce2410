"""The port's dry run against the JAX package's, on the CPU.

* ``collective_census``: the reference's ring formulas on hand-made
  records, and the same per-op wire bytes as the reference's HLO parser
  on the equivalent HLO lines.
* ``cell_supported`` and ``input_specs`` on all 40 (arch x shape) cells:
  the same skips, and meta tensors with the reference's shapes and
  dtypes (a decode cell's cache too).
* The three cells of ``tests/test_dryrun_mini.py`` (qwen2.5-3b
  ``train_4k``, mamba2-1.3b ``decode_32k``, qwen3-moe-30b-a3b
  ``prefill_32k``; reduced configs, ``microbatch=2``, batch 8 x 64) traced
  on a fake 2x2x2 ``(pod, data, model)`` process group in this process:
  the per-device bytes of params, optimizer state and cache equal what
  the reference's specs give at those axis sizes (GSPMD pads a dim split
  k ways to ``ceil(dim / k)``, the size of DTensor's first shard).
* Reduced llama3-405b's ``train_4k`` (Adafactor, fused accumulation)
  on the same world: no storage made during the optimizer's update is
  larger than one rank's shard of the largest leaf in float32, and each
  gradient is reduced onto its parameter's placements during the
  backward.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.launch import dryrun as ref_dryrun  # noqa: E402
from repro.sharding import plan as ref_plan  # noqa: E402
from repro.train.optimizer import get_optimizer as ref_get_optimizer  # noqa
from repro.train.step import abstract_train_state  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

RECORDS = [
    {"op": "all-reduce", "payload_bytes": 8 * 64 * 4, "group": 4},
    {"op": "all-gather", "payload_bytes": 16 * 128 * 2, "group": 2},
    {"op": "reduce-scatter", "payload_bytes": 4 * 64 * 4, "group": 4},
    {"op": "all-to-all", "payload_bytes": 8 * 8 * 2, "group": 8},
    {"op": "collective-permute", "payload_bytes": 2 * 2 * 4, "group": 2},
]

HLO = """
  %all-reduce.1 = f32[8,64]{1,0} all-reduce(%dot), channel_id=1, replica_groups=[2,4]<=[8], use_global_device_ids=true
  %all-gather = bf16[16,128]{1,0} all-gather(%p), replica_groups={{0,1},{2,3}}, dimensions={0}
  %reduce-scatter = f32[4,64]{1,0} reduce-scatter(%x), replica_groups=[2,4]<=[8]
  %all-to-all = bf16[8,8]{1,0} all-to-all(%y), replica_groups=[1,8]<=[8]
  %collective-permute-start = f32[2,2]{1,0} collective-permute-start(%z), source_target_pairs={{0,1}}
"""


def test_census_formulas_on_records():
    c = dryrun.collective_census(RECORDS)
    assert c["n_collectives"] == 5
    ops = c["by_op"]
    assert abs(ops["all-reduce"]["wire_bytes"] - 1.5 * 2048) < 1e-6
    assert abs(ops["all-gather"]["wire_bytes"] - 0.5 * 16 * 128 * 2) < 1e-6
    assert abs(ops["reduce-scatter"]["wire_bytes"] - 3 * 1024) < 1e-6
    assert ops["collective-permute"]["count"] == 1
    assert dryrun.collective_census([])["n_collectives"] == 0


def test_census_agrees_with_reference_parser():
    got = dryrun.collective_census(RECORDS)
    want = ref_dryrun.collective_census(HLO)
    assert got["n_collectives"] == want["n_collectives"]
    assert got["wire_bytes_per_device"] == pytest.approx(
        want["wire_bytes_per_device"])
    for op, c in want["by_op"].items():
        assert got["by_op"][op]["count"] == c["count"], op
        assert got["by_op"][op]["wire_bytes"] == pytest.approx(
            c["wire_bytes"]), op


def _same_spec(meta, sds, where):
    assert tuple(meta.shape) == tuple(sds.shape), where
    assert str(meta.dtype).removeprefix("torch.") == str(sds.dtype), where
    assert meta.device.type == "meta", where


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cells_and_input_specs_match_reference(arch):
    cfg, cfg_r = configs.get(arch), ref_configs.get(arch)
    for shape in configs.SHAPES:
        assert configs.cell_supported(cfg, shape) == \
            ref_shapes.cell_supported(cfg_r, shape)
        assert configs.plan_rule_overrides(cfg, shape) == \
            ref_shapes.plan_rule_overrides(cfg_r, shape)
        if not configs.cell_supported(cfg, shape)[0]:
            continue
        got = configs.input_specs(cfg, shape)
        want = ref_shapes.input_specs(cfg_r, shape)
        assert set(got) == set(want), (arch, shape)
        for k in want:
            if k == "cache":
                assert set(got[k]) == set(want[k]), (arch, shape)
                for kk in want[k]:
                    _same_spec(got[k][kk], want[k][kk], (arch, shape, kk))
            else:
                _same_spec(got[k], want[k], (arch, shape, k))
    assert sorted(configs.all_cells()) == sorted(ref_configs.all_cells())
    assert sorted(configs.skipped_cells()) == \
        sorted(ref_configs.skipped_cells())


# ---------------------------------------------------------------------------
# the mini dry run on a fake 2x2x2 world
# ---------------------------------------------------------------------------

AXIS_SIZE = {"pod": 2, "data": 2, "model": 2}
NAMES = ("pod", "data", "model")
MINI_CELLS = [("qwen2.5-3b", "train_4k"), ("mamba2-1.3b", "decode_32k"),
              ("qwen3-moe-30b-a3b", "prefill_32k")]


class RefMesh:
    axis_names = NAMES


@pytest.fixture(scope="module")
def fake_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        pytest.fail("a process group is already running in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=NAMES)
    finally:
        dist.destroy_process_group()


def spec_bytes(sds, spec) -> int:
    """Per-device bytes of ``sds`` split by ``spec`` (padded dims)."""
    n = 1
    for dim, ax in zip(sds.shape, tuple(spec) + (None,) * sds.ndim):
        k = 1
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            k *= AXIS_SIZE[a]
        n *= math.ceil(dim / k)
    return n * np.dtype(sds.dtype).itemsize


def tree_bytes(tree, specs) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(spec_bytes(l, s) for l, s in zip(leaves, spec_leaves))


@pytest.mark.parametrize("arch,shape", MINI_CELLS)
def test_mini_dryrun_state_bytes_match_reference_specs(arch, shape,
                                                       fake_mesh):
    measure_mini_cell(arch, shape, fake_mesh)


def measure_mini_cell(arch: str, shape: str, fake_mesh) -> dict:
    """Trace the reduced cell on the fake world and hold its record's
    state bytes to the reference's specs; returns the record."""
    cfg = configs.get_reduced(arch).replace(microbatch=2)
    cfg_r = ref_configs.get_reduced(arch).replace(microbatch=2)
    specs = configs.input_specs(cfg, shape, batch_override=8,
                                seq_override=64)
    res = dryrun._measure(cfg, shape, fake_mesh, torch.device("cpu"), specs)
    mem = res["memory"]

    plan = ref_dryrun.build_plan(cfg_r, shape, RefMesh())
    assert res["rules"] == plan.rules and res["fsdp"] == plan.fsdp
    kind = ref_shapes.SHAPES[shape].kind
    if kind == "train":
        st = abstract_train_state(cfg_r, ref_get_optimizer(cfg_r.optimizer))
        params = st["params"]
        opt = dict(st["opt"])
        count = opt.pop("count")            # a Python int in the port
        assert count.ndim == 0
        want_opt = tree_bytes(opt, ref_plan.param_specs(plan, opt))
    else:
        from repro.models import transformer as T
        params = T.abstract_params(cfg_r)
        want_opt = 0
    assert mem["param_bytes"] == tree_bytes(
        params, ref_plan.param_specs(plan, params))
    assert mem["opt_state_bytes"] == want_opt
    if kind == "decode":
        cache = ref_shapes.input_specs(cfg_r, shape, batch_override=8,
                                       seq_override=64)["cache"]
        plan.sharding = plan.spec          # specs, not NamedShardings
        want = sum(spec_bytes(cache[k], s) for k, s in
                   ref_dryrun._cache_shardings(plan, cache).items())
        assert mem["cache_bytes"] == want
    else:
        assert mem["cache_bytes"] == 0
    state = mem["param_bytes"] + mem["opt_state_bytes"] + mem["cache_bytes"]
    assert mem["peak_device_bytes"] >= state
    # the live bytes by op, at a point within 5% of the peak
    held = mem["peak_holders"]
    assert mem["peak_device_bytes"] / 1.05 <= held["bytes"] <= \
        mem["peak_device_bytes"]
    assert sum(v["bytes"] for v in held["by_op"].values()) <= held["bytes"]
    assert "state" in held["by_op"] or len(held["by_op"]) == 12
    assert res["cost"]["flops_per_device"] > 0
    assert res["collectives"]["n_collectives"] > 0
    return res


def test_adafactor_update_stays_on_the_shard(fake_mesh, monkeypatch):
    """Reduced llama3-405b's ``train_4k`` cell (Adafactor, fsdp) on the
    fake 2x2x2 world, as the mini cells run: no storage made during the
    optimizer's update is larger than the largest local shard of a
    reference leaf in float32 (the first, ``ceil``-sized shard of an
    uneven dim), as GSPMD shards the reference's update; the state's
    bytes still equal the reference's specs."""
    from repro_torch.train.optimizer import Optimizer, get_optimizer
    arch, shape = "llama3-405b", "train_4k"
    made, updating = [], []

    def probed(name: str) -> Optimizer:
        opt = get_optimizer(name)

        def update(*args):
            updating.append(True)
            try:
                opt.update(*args)
            finally:
                updating.pop()
        return Optimizer(opt.init, update)
    track = dryrun.CellRecorder._track

    def tracked(rec, t, op="state"):
        st = t.untyped_storage()
        if updating and id(st) not in rec._live:
            made.append((st.nbytes(), op))
        track(rec, t, op)
    monkeypatch.setattr(dryrun, "get_optimizer", probed)
    monkeypatch.setattr(dryrun.CellRecorder, "_track", tracked)
    measure_mini_cell(arch, shape, fake_mesh)

    cfg_r = ref_configs.get_reduced(arch).replace(microbatch=2)
    assert cfg_r.optimizer == "adafactor"
    params = abstract_train_state(
        cfg_r, ref_get_optimizer(cfg_r.optimizer))["params"]
    plan = ref_dryrun.build_plan(cfg_r, shape, RefMesh())
    specs = jax.tree.leaves(ref_plan.param_specs(plan, params),
                            is_leaf=lambda x: isinstance(x, P))
    shard = max(spec_bytes(l, s) // np.dtype(l.dtype).itemsize * 4
                for l, s in zip(jax.tree.leaves(params), specs))
    assert made, "the update made no storage"
    biggest = max(made)
    assert biggest[0] <= shard, (
        f"{biggest[1]} made {biggest[0]} B during the update; the largest "
        f"local shard of a leaf is {shard} B in float32")


def test_kernel_wrappers_refuse_dtensors(fake_mesh):
    """Each CUDA wrapper raises on a DTensor before it reads a pointer
    (here on the CPU: the refusal comes before the device checks)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.group_pick import kernel as gk
    from repro_torch.kernels.ssd_scan import kernel as sk

    def dt(*shape, dtype=torch.float32):
        return distribute_tensor(torch.zeros(shape, dtype=dtype), fake_mesh,
                                 [Replicate()] * 3)
    q = dt(1, 4, 2, 16)
    with pytest.raises(TypeError, match="DTensor"):
        fk.flash_attention_cuda(q, q, q)
    with pytest.raises(TypeError, match="DTensor"):
        dk.decode_attention_cuda(dt(1, 2, 16), dt(1, 8, 2, 16),
                                 dt(1, 8, 2, 16),
                                 dt(1, dtype=torch.int32))
    x = dt(1, 1, 4, 2, 8)
    with pytest.raises(TypeError, match="DTensor"):
        sk.ssd_intra_chunk_cuda(x, dt(1, 1, 4, 2), dt(1, 1, 4, 2),
                                dt(1, 1, 2), dt(1, 1, 4, 1, 4),
                                dt(1, 1, 4, 1, 4))
    with pytest.raises(TypeError, match="DTensor"):
        gk.pick_order_cuda(dt(2, 4, dtype=torch.int32),
                           dt(2, 4, dtype=torch.int32), 1)


def test_checkpointed_backward_on_another_thread(fake_mesh):
    """On a CUDA device the autograd engine runs the backward, and so the
    recompute of each checkpointed layer, on its own thread, where the
    caller's plan (a context variable) is unset: the recompute must
    place its activations as the forward did (a sequence-sharded input
    to a linear layer fails in DTensor's view rule)."""
    import threading
    from repro_torch.models.transformer import Transformer, loss_fn
    from repro_torch.sharding.plan import (Plan, plan_scope, shard_model,
                                           to_placements, use_plan)
    from repro_torch.train.step import batch_placements
    cfg = configs.get_reduced("qwen2.5-3b").replace(dtype="float32",
                                                    attn_impl="dense")
    plan = Plan(mesh=fake_mesh, fsdp=True, rules={"seq": "model"})
    model = shard_model(Transformer(cfg, device="cpu"), plan)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (8, 16), generator=g)
             for k in ("tokens", "labels")}
    out = {}
    with use_plan(plan), plan_scope():
        placed = {k: to_placements(v, fake_mesh, batch_placements(plan, v))
                  for k, v in batch.items()}
        loss, _ = loss_fn(model, placed)
        params = list(model.parameters())

        def backward():
            # the engine's threads carry the caller's implicit-replication
            # flag (torch 2.11 keeps it global), not its context variables
            from torch.distributed.tensor.experimental import \
                implicit_replication
            try:
                with implicit_replication():
                    out["grads"] = torch.autograd.grad(loss, params)
            except Exception as e:          # re-raised below
                out["error"] = e
        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=120)
    assert not t.is_alive()
    if "error" in out:
        raise out["error"]
    assert len(out["grads"]) == len(params)


def test_fused_gradients_are_reduced_in_the_backward(fake_mesh,
                                                     monkeypatch):
    """Reduced llama3-405b's ``train_4k`` cell (fused accumulation, 2
    microbatches) on the fake 2x2x2 world: when the second microbatch
    starts, every sharded parameter's accumulated gradient already lies
    on the parameter's shard on each mesh dim the parameter is sharded
    on, reduced as the backward made it, so no rank holds a whole
    backward's unreduced gradients (each weight's gradient gathered over
    "data": 50.5 GB a device in the full llama3-405b's dry run on
    16x16).  A partial sum onto a dim the parameter is replicated on
    (an all-reduce, which frees nothing) waits for the last microbatch,
    and the optimizer gets every gradient on its parameter's
    placements."""
    from repro_torch.train import step
    loss_fn, seen = step.loss_fn, []

    def probed(model, batch):
        seen.append([(tuple(p.grad.placements), tuple(p.placements))
                     for p in model.parameters() if p.grad is not None])
        return loss_fn(model, batch)
    monkeypatch.setattr(step, "loss_fn", probed)
    get_optimizer, given = dryrun.get_optimizer, []

    def probed_opt(name: str):
        opt = get_optimizer(name)

        def update(grads, state, model):
            params = dict(model.named_parameters())
            given.extend((tuple(g.placements), tuple(params[n].placements))
                         for n, g in grads.items())
            return opt.update(grads, state, model)
        return opt._replace(update=update)
    monkeypatch.setattr(dryrun, "get_optimizer", probed_opt)
    measure_mini_cell("llama3-405b", "train_4k", fake_mesh)
    assert len(seen) == 2 and not seen[0] and seen[1]
    off = [(g, p) for g, p in seen[1]
           if any(w.is_shard() and h != w for h, w in zip(g, p))]
    assert not off, f"{len(off)} gradients off their shards: {off[:3]}"
    assert any(h.is_partial() and w.is_replicate()
               for g, p in seen[1] for h, w in zip(g, p)), (
        "no all-reduce was left to the last microbatch")
    assert given and all(g == p for g, p in given), [
        (g, p) for g, p in given if g != p][:3]
