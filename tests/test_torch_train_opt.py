"""One optimizer update and the train step of the port against the JAX
package on the CPU, and the map between the two parameter layouts.

Reduced configs in float32, the reference's own parameters and batches
given to both packages as numpy.

* One ``adamw`` and one ``adafactor`` update from the same params,
  gradients and state (seeded moments, count 3): the new params and the
  new state leaf for leaf, atol 1e-6, rtol 1e-5.  Adafactor on reduced
  llama3-405b (stacked ``[L, d]`` norms, transposed weights), qwen2.5-3b
  (stacked biases), zamba2-1.2b (the shared block's unstacked leaves)
  and qwen3-moe-30b-a3b (4-axis expert leaves).
* ``make_train_step``, one step from the same state and batch: with
  ``microbatch=2`` in ``scan``, ``unroll`` (float32 and bfloat16
  accumulators) and ``fused``, with ``grad_compression="int8_pod"``, and
  Adafactor with ``fused`` on llama3-405b.  Loss and ``grad_norm`` to
  rtol 2e-4 (1e-3 with int8 compression), the optimizer state to
  atol 2e-5 / rtol 2e-4 (times the moment's weight), and the params by
  the rule for AdamW's near-sign first step: where ``|g|`` is above
  1e-3 they agree to atol 1e-6 / rtol 1e-5 (2e-5 with compression);
  elsewhere they differ by at most ``2 lr_t``.
* ``param_leaves``: every parameter in exactly one leaf, the leaves the
  reference's in order and shape.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro.train.data import DataConfig as RefDataConfig  # noqa: E402
from repro.train.data import make_batch as ref_make_batch  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.convert import (state_dict_from_jax,  # noqa: E402
                                        train_state_from_jax,
                                        train_state_to_jax)
from repro_torch.train import leaves as LV  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.step import (init_train_state,  # noqa: E402
                                    make_train_step)

UPDATE_TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def few_intra_op_threads():
    """Reduced models are many small tensor ops; beside the reference's
    thread pool and other test workers, more threads only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ref_cfg(arch: str, **kw):
    return ref_configs.get_reduced(arch).replace(dtype="float32", **kw)


def port_cfg(arch: str, **kw):
    return configs.get_reduced(arch).replace(dtype="float32",
                                             attn_impl="dense", **kw)


def torch_batch(batch: dict) -> dict:
    out = {}
    for k, v in batch.items():
        a = np.array(v)
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                                  else a)
    return out


def assert_trees_close(got: dict, want: dict, path=(), **tol):
    """Nested dicts of arrays, leaf for leaf (same keys)."""
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_close(got[k], want[k], path + (k,), **tol)
        else:
            w = np.asarray(want[k])
            assert np.shape(got[k]) == w.shape, (path + (k,))
            np.testing.assert_allclose(
                np.asarray(got[k], np.float64), w.astype(np.float64),
                err_msg=".".join(path + (k,)), **tol)


# ---------------------------------------------------------------------------
# one optimizer update
# ---------------------------------------------------------------------------


def seeded_like(tree, seed: int, positive=False):
    rng = np.random.default_rng(seed)

    def draw(x):
        a = rng.standard_normal(x.shape).astype(np.float32)
        return np.abs(a) if positive else a
    return jax.tree.map(draw, tree)


UPDATE_CASES = [("adamw", "qwen2.5-3b"), ("adafactor", "llama3-405b"),
                ("adafactor", "qwen2.5-3b"), ("adafactor", "zamba2-1.2b"),
                ("adafactor", "qwen3-moe-30b-a3b")]


@pytest.mark.parametrize("name,arch", UPDATE_CASES)
def test_one_update_matches_reference(name, arch):
    cfg_r, cfg_p = ref_cfg(arch), port_cfg(arch)
    kw = dict(lr=1e-3, warmup_steps=5)
    o_r, o_p = ref_opt.get_optimizer(name, **kw), opt.get_optimizer(name, **kw)
    params = jax.tree.map(np.asarray, jax.jit(partial(T.init_params, cfg_r))(
        jax.random.PRNGKey(2)))
    st = o_r.init(params)
    if name == "adamw":
        st = {"m": seeded_like(st["m"], 1), "v": seeded_like(st["v"], 2,
                                                            True)}
    else:
        st = {"f": seeded_like(st["f"], 1, True)}
    st["count"] = np.int32(3)
    grads = seeded_like(params, 4)
    upd, new_st = jax.jit(o_r.update)(grads, st, params)
    want = {"params": jax.tree.map(lambda p, u: np.asarray(p + u), params,
                                   upd),
            "opt": jax.tree.map(np.asarray, new_st)}

    state = init_train_state(cfg_p, o_p, device="cpu")
    train_state_from_jax(state, {"params": params, "opt": st,
                                 "step": np.int32(0)})
    o_p.update(state_dict_from_jax(cfg_p, grads), state["opt"],
               state["model"])
    got = train_state_to_jax(state)
    assert int(got["opt"]["count"]) == 4
    got["opt"]["count"] = np.asarray(got["opt"]["count"])
    del got["step"]
    assert_trees_close(got, want, **UPDATE_TOL)


def test_adafactor_factors_stacked_norms():
    """A stacked norm scale [L, d] is factored: vr [L], vc [d]."""
    cfg = port_cfg("qwen2.5-3b")
    state = init_train_state(cfg, opt.adafactor(), device="cpu")
    f = state["opt"]["f"]
    assert tuple(f["layers.attn.bk"]["vr"].shape) == (cfg.n_layers,)
    assert tuple(f["layers.ln1.scale"]["vc"].shape) == (cfg.d_model,)
    assert set(f["final_norm.scale"]) == {"v"}
    # a transposed weight keeps the reference's [L, in, out] statistics
    wq = f["layers.attn.wq"]
    assert tuple(wq["vr"].shape) == (cfg.n_layers, cfg.d_model)
    assert tuple(wq["vc"].shape) == (cfg.n_layers,
                                     cfg.n_heads * cfg.head_dim)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_leaves_cover_every_parameter(arch):
    """Each parameter is in exactly one leaf, and the leaves are the
    reference's, in its order and shapes."""
    cfg_r, cfg_p = ref_cfg(arch), port_cfg(arch)
    want = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(partial(T.init_params, cfg_r),
                       jax.ShapeDtypeStruct((2,), jnp.uint32)))[0]
    model = PT.Transformer(cfg_p, device="cpu")
    shapes = {n: p.shape for n, p in model.named_parameters()}
    leaves = LV.param_leaves(cfg_p)
    assert [leaf.key for leaf in leaves] == [
        ".".join(str(k.key) for k in path) for path, _ in want]
    for leaf, (_, w) in zip(leaves, want):
        assert LV.ref_shape(leaf, shapes[leaf.names[0]]) == w.shape
    names = [n for leaf in leaves for n in leaf.names]
    assert sorted(names) == sorted(shapes)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

# (arch, config overrides, grad_compression)
STEP_CASES = [
    ("qwen2.5-3b", dict(microbatch=1), None),
    ("qwen2.5-3b", dict(microbatch=2, grad_accum="scan"), None),
    ("qwen2.5-3b", dict(microbatch=2, grad_accum="unroll"), None),
    ("qwen2.5-3b", dict(microbatch=2, grad_accum="fused"), None),
    ("qwen2.5-3b", dict(microbatch=1), "int8_pod"),
    ("llama3-405b", {}, None),          # adafactor, fused, microbatch 2
]
LR, WARMUP = 1e-3, 5
# a gradient above this decides the sign of AdamW's first update
SIGN_G = 1e-3


def ref_grads(cfg_r, params, batch) -> dict:
    g = jax.jit(jax.grad(lambda p: T.loss_fn(cfg_r, p, batch)[0]))(params)
    return jax.tree.map(np.asarray, g)


def flat(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[".".join(prefix + (k,))] = np.asarray(v, np.float64)
    return out


@pytest.mark.parametrize("arch,over,gc", STEP_CASES,
                         ids=["mb1", "scan", "unroll", "fused", "int8_pod",
                              "adafactor-fused"])
def test_train_step_matches_reference(arch, over, gc):
    cfg_r, cfg_p = ref_cfg(arch, **over), port_cfg(arch, **over)
    name = cfg_r.optimizer
    o_r = ref_opt.get_optimizer(name, lr=LR, warmup_steps=WARMUP)
    o_p = opt.get_optimizer(name, lr=LR, warmup_steps=WARMUP)
    st_r = jax.jit(partial(ref_step.init_train_state, cfg_r, o_r))(
        jax.random.PRNGKey(0))
    dc = RefDataConfig(vocab=cfg_r.vocab, seq_len=32, global_batch=4,
                       seed=3)
    batch = ref_make_batch(dc, jnp.int32(0))
    new_r, m_r = jax.jit(ref_step.make_train_step(cfg_r, o_r, gc))(
        st_r, batch)

    state = init_train_state(cfg_p, o_p, device="cpu")
    train_state_from_jax(state, jax.tree.map(np.asarray, st_r))
    state, m_p = make_train_step(cfg_p, o_p, gc)(state, torch_batch(batch))

    rtol = 1e-3 if gc else 2e-4
    np.testing.assert_allclose(float(m_p["loss"]), float(m_r["loss"]),
                               rtol=2e-4)
    np.testing.assert_allclose(float(m_p["grad_norm"]),
                               float(m_r["grad_norm"]), rtol=rtol)
    got = flat(train_state_to_jax(state))
    want = flat(jax.tree.map(np.asarray, new_r))
    assert set(got) == set(want)
    assert got["step"] == want["step"] == 1
    assert got["opt.count"] == want["opt.count"] == 1

    # the gradient each leaf saw, and its tolerance
    g = flat(ref_grads(cfg_r, st_r["params"], batch))
    old = flat(jax.tree.map(np.asarray, st_r["params"]))
    lr_t = LR * min(1.0, 2 / WARMUP)
    for key, p_old in old.items():
        g_leaf = g[key]
        if gc:
            # the compressed gradient; a rounding tie may move one
            # element by one quantization step
            ef = want["ef." + key]
            np.testing.assert_allclose(
                got["ef." + key], ef,
                atol=2e-5 + np.abs(g_leaf).max() / 127 * 1.01)
            g_leaf = g_leaf - ef
        gtol = 2e-5 + 2e-4 * np.abs(g_leaf).max()
        if gc:
            gtol += np.abs(g[key]).max() / 127
        gmax = np.abs(g_leaf).max()
        if name == "adamw":
            np.testing.assert_allclose(got["opt.m." + key],
                                       want["opt.m." + key],
                                       atol=0.1 * gtol, rtol=2e-4,
                                       err_msg=key)
            np.testing.assert_allclose(got["opt.v." + key],
                                       want["opt.v." + key],
                                       atol=0.05 * (2 * gmax + gtol) * gtol,
                                       rtol=2e-4, err_msg=key)
            # AdamW's first step is near sign(g): compare where |g|
            # decides it, bound the rest by 2 lr_t
            p_new, p_want = got["params." + key], want["params." + key]
            big = np.abs(g_leaf) > SIGN_G
            np.testing.assert_allclose(p_new[big], p_want[big],
                                       err_msg=key, **UPDATE_TOL)
            assert np.all(np.abs(p_new - p_want) <= 2 * lr_t + 1e-6), key
        else:
            for sub in ("vr", "vc", "v"):
                k = f"opt.f.{key}.{sub}"
                if k in want:
                    np.testing.assert_allclose(
                        got[k], want[k], rtol=2e-4,
                        atol=(2 * gmax + gtol) * gtol, err_msg=k)
            np.testing.assert_allclose(got["params." + key],
                                       want["params." + key],
                                       err_msg=key, **UPDATE_TOL)
