"""The port's sharding plan against the JAX package's, and the sharded
train step against the reference's unsharded one.

* Rule resolution: ``Plan.spec`` of ``repro_torch.sharding.plan`` equals
  the reference's on the cases of ``tests/test_sharding.py`` (a mesh is
  only its axis names here).
* ``param_specs``: for every arch x ``fsdp`` x production mesh, each port
  parameter's spec is the reference leaf's spec with the stacked layer
  dim dropped and the dims reversed where the port holds the transpose.
* Without a plan, ``shard(x, ...)`` is ``x`` itself.
* The sharded step: 8 gloo ranks (one process each, one intra-op
  thread, started by ``torch.distributed.run`` with a time limit) take
  one step from the reference's params and optimizer state
  (``train_state_from_jax(..., plan=)``) on the reference's batch;
  the loss, the gradient norm and ``lm_head`` after the step are held
  to the reference's unsharded jitted step at ``tests/test_sharding.py``'s
  tolerances (loss 1e-4 absolute, ``lm_head`` atol 1e-4): reduced
  qwen2.5-3b on a 2x4 ``(data, model)`` mesh with ``fsdp=True``, reduced
  qwen3-moe-30b-a3b and mamba2-1.3b (4 microbatches of 2 rows) on a
  2x2x2 ``(pod, data, model)`` mesh (their configs' ``fsdp=True``), and
  qwen2.5-3b with 6 heads on
  the 2x4 mesh under sequence parallelism (heads that do not divide
  their ranks, where GSPMD pads), float32.
"""
import pickle
import textwrap
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.sharding import plan as ref_plan  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro.train.data import DataConfig, make_batch  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.sharding.plan import (Plan, param_specs,  # noqa: E402
                                       shard)
from repro_torch.train import leaves as LV  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402


class RefMesh:
    def __init__(self, names):
        self.axis_names = names


class PortMesh:
    def __init__(self, names):
        self.mesh_dim_names = names


RULE_CASES = [
    (("data", "model"), {}, ("batch",)),
    (("data", "model"), {}, ("heads",)),
    (("data", "model"), {}, (None,)),
    (("data", "model"), {"seq": "model"}, ("batch", "seq", "vocab")),
    (("data", "model"), {"seq": "model"}, ("batch", "seq", "embed")),
    (("data", "model"), {"batch": None}, ("batch", "seq")),
    (("pod", "data", "model"), {}, ("batch", "seq", "heads", "head_dim")),
    (("pod", "data", "model"), {"fsdp": ("data", "model")},
     ("fsdp", "heads")),
    (("pod", "data", "model"), {"batch": ("pod", "data", "model")},
     ("batch", "seq", "vocab")),
]


@pytest.mark.parametrize("names,rules,logical", RULE_CASES)
def test_rule_resolution_matches_reference(names, rules, logical):
    want = ref_plan.Plan(mesh=RefMesh(names), rules=rules).spec(*logical)
    got = Plan(mesh=PortMesh(names), rules=rules).spec(*logical)
    assert got == tuple(want), (got, want)


def test_rule_resolution_cases_of_the_reference_test():
    plan = Plan(mesh=PortMesh(("data", "model")))
    assert plan.spec("batch") == P("data")
    assert plan.spec("heads") == P("model")
    assert plan.spec(None) == P(None)
    plan = Plan(mesh=PortMesh(("data", "model")), rules={"seq": "model"})
    assert plan.spec("batch", "seq", "vocab") == P("data", None, "model")
    assert plan.spec("batch", "seq", "embed") == P("data", "model", None)


def test_shard_is_x_itself_without_a_plan():
    x = torch.ones(4, 4)
    assert shard(x, "batch", "embed") is x


_PORT_MODELS: dict = {}


def port_model(arch: str):
    """The full-width model on fake tensors (shapes only)."""
    if arch not in _PORT_MODELS:
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            _PORT_MODELS[arch] = Transformer(
                configs.get(arch).replace(dtype="float32"), device="cpu")
    return _PORT_MODELS[arch]


_REF_PARAMS: dict = {}


def ref_params(arch: str):
    if arch not in _REF_PARAMS:
        _REF_PARAMS[arch] = T.abstract_params(ref_configs.get(arch))
    return _REF_PARAMS[arch]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model")])
def test_param_specs_match_reference(arch, fsdp, names):
    r_plan = ref_plan.Plan(mesh=RefMesh(names), fsdp=fsdp)
    specs_r = ref_plan.param_specs(r_plan, ref_params(arch))
    model = port_model(arch)
    specs_p = param_specs(Plan(mesh=PortMesh(names), fsdp=fsdp), model)
    params = dict(model.named_parameters())
    assert set(specs_p) == set(params)
    for leaf in LV.param_leaves(model.cfg):
        ref_leaf = LV.get_path(ref_params(arch), leaf.path)
        want = tuple(LV.get_path(specs_r, leaf.path))
        want += (None,) * (len(ref_leaf.shape) - len(want))
        for n in leaf.names:
            got = specs_p[n]
            nd = params[n].dim()
            assert len(got) == nd, (n, got)
            assert LV.ref_shape(leaf, params[n].shape) == ref_leaf.shape
            if leaf.stacked:
                assert want[0] is None, (leaf.key, want)
            for j in range(nd):
                rd = nd - 1 - j if leaf.transposed else j
                rd += 1 if leaf.stacked else 0
                assert got[j] == want[rd], (n, got, want)


# ---------------------------------------------------------------------------
# the sharded step, 8 gloo ranks
# ---------------------------------------------------------------------------

STEP_WORKER = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import train_state_from_jax
    from repro_torch.sharding.plan import Plan, full_value, use_plan
    from repro_torch.train import leaves as LV
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.step import init_train_state, make_train_step

    d = sys.argv[1]
    with open(d + "/in.pkl", "rb") as f:
        job = pickle.load(f)
    dist.init_process_group("gloo")
    names = ("data", "model") if len(job["mesh"]) == 2 else \\
        ("pod", "data", "model")
    mesh = make_mesh(job["mesh"], names, device_type="cpu")
    cfg = configs.get_reduced(job["arch"]).replace(dtype="float32",
                                                   **job["over"])
    opt = get_optimizer(cfg.optimizer, **job["opt_kw"])
    plan = Plan(mesh=mesh, fsdp=True, rules=job["rules"])
    state = init_train_state(cfg, opt, device="cpu")
    train_state_from_jax(state, job["state"], plan=plan)
    batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
    with use_plan(plan):
        state, m = make_train_step(cfg, opt)(state, batch)
    params = dict(state["model"].named_parameters())
    head = full_value(params["lm_head.weight"]).detach()
    # every parameter leaf after the update, and Adafactor's statistics,
    # whole and in the reference's layout
    leaves = {}
    for leaf in LV.param_leaves(cfg):
        leaves["params:" + leaf.key] = full_value(LV.to_ref(
            leaf, [params[n].detach() for n in leaf.names]))
        for k, t in state["opt"].get("f", {}).get(leaf.key, {}).items():
            leaves[k + ":" + leaf.key] = full_value(t)
    if dist.get_rank() == 0:
        np.savez(d + "/out.npz", loss=float(m["loss"]),
                 grad_norm=float(m["grad_norm"]),
                 lm_head=head.t().contiguous().numpy(),
                 **{k: v.numpy() for k, v in leaves.items()})
    dist.destroy_process_group()
""")


# (arch, mesh, config overrides, plan rules); the optimizer is the
# config's (AdamW unless an override or the arch names Adafactor);
# mamba2's microbatches of 2 rows do not split over pod x data (4 ranks:
# rows_plan keeps "data", as llama3-405b's 16 rows on 2x16x16), the
# fourth case splits 6 heads over 4 ranks (uneven, as llava-next-34b's
# 56 over 16) under sequence parallelism, and the Adafactor cases shard
# both matrix dims of the MLP leaves (fsdp on "data", ff on "model"):
# llama3-405b's d_ff of 90 on 4 ranks (shards of 23, 23, 23 and 21,
# sliced from both statistics) and of 9 (3, 3, 3 and an empty shard),
# dbrx-132b's stacked experts on 2x2x2
STEP_CASES = [("qwen2.5-3b", (2, 4), {}, {}),
              ("qwen3-moe-30b-a3b", (2, 2, 2), {}, {}),
              ("mamba2-1.3b", (2, 2, 2), dict(microbatch=4), {}),
              ("qwen2.5-3b", (2, 4), dict(n_heads=6, d_model=96),
               {"seq": "model"}),
              ("llama3-405b", (2, 4), dict(optimizer="adafactor",
                                           grad_accum="fused", d_ff=90), {}),
              ("llama3-405b", (2, 4), dict(optimizer="adafactor",
                                           grad_accum="fused", d_ff=9), {}),
              ("dbrx-132b", (2, 2, 2), dict(optimizer="adafactor"), {})]

# Adafactor's first step at its default warmup of 100 moves a parameter
# by lr / 100 x its leaf's RMS x u, ~5e-6 an element, which atol 1e-4
# would not see: its cases warm up in one step
OPT_KW = {"adamw": dict(lr=1e-3), "adafactor": dict(lr=1e-3,
                                                    warmup_steps=1)}


@pytest.mark.parametrize("arch,mesh,over,rules", STEP_CASES)
def test_sharded_step_equals_reference_unsharded(arch, mesh, over, rules,
                                                 tmp_path):
    cfg = ref_configs.get_reduced(arch).replace(dtype="float32", **over)
    assert cfg.fsdp or arch == "qwen2.5-3b"
    opt = ref_opt.get_optimizer(cfg.optimizer, **OPT_KW[cfg.optimizer])
    state = jax.jit(partial(ref_step.init_train_state, cfg, opt))(
        jax.random.PRNGKey(0))
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
    batch = make_batch(dc, jnp.int32(0))
    s_ref, m_ref = jax.jit(ref_step.make_train_step(cfg, opt))(state, batch)
    job = {"arch": arch, "mesh": mesh, "over": over, "rules": rules,
           "opt_kw": OPT_KW[cfg.optimizer],
           "state": jax.tree.map(np.asarray, state),
           "batch": {k: np.asarray(v).astype(np.int64)
                     for k, v in batch.items()}}
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump(job, f)
    run_ranks(STEP_WORKER, tmp_path)
    out = np.load(tmp_path / "out.npz")
    assert abs(float(out["loss"]) - float(m_ref["loss"])) < 1e-4, (
        float(out["loss"]), float(m_ref["loss"]))
    assert abs(float(out["grad_norm"]) - float(m_ref["grad_norm"])) \
        < 1e-4 * float(m_ref["grad_norm"])
    np.testing.assert_allclose(out["lm_head"],
                               np.asarray(s_ref["params"]["lm_head"]),
                               atol=1e-4)
    for leaf in LV.param_leaves(configs.get_reduced(arch).replace(**over)):
        before = np.asarray(LV.get_path(state["params"], leaf.path))
        want = np.asarray(LV.get_path(s_ref["params"], leaf.path))
        np.testing.assert_allclose(out["params:" + leaf.key], want,
                                   atol=1e-4, err_msg=leaf.key)
        if cfg.optimizer != "adafactor":
            continue
        # Adafactor's update itself, to a thousandth of its largest
        # element (AdamW's first step is g / (|g| + eps), whose sign
        # flips where a gradient is float noise about zero)
        dp = want - before
        np.testing.assert_allclose(out["params:" + leaf.key] - before, dp,
                                   atol=1e-3 * np.abs(dp).max(),
                                   err_msg="update of " + leaf.key)
        stats = LV.get_path(s_ref["opt"]["f"], leaf.path)
        assert stats, leaf.key
        for k, v in stats.items():
            # an element 1e7 times below the statistic's largest is the
            # square of a gradient sum that cancelled, where float32's
            # order of summation alone moves it by more than 1e-4
            v = np.asarray(v)
            np.testing.assert_allclose(out[k + ":" + leaf.key], v,
                                       rtol=1e-4, atol=1e-7 * v.max(),
                                       err_msg=f"{k} {leaf.key}")
