"""The port's blocked attention (``attn_impl="blocked"``) against the JAX
package on the CPU.

* ``layers.blocked_attention`` against ``repro.models.layers.
  blocked_attention`` over shapes with ragged tails, GQA, causal with
  and without ``block_skip`` and non-causal with padded kv: f32 atol
  2e-5; a sequence shard (``q_offset``) equals its rows of the whole.
* Its gradient against the port's ``dense_attention`` gradient.
* The model: reduced chatglm3-6b at S = 40 with ``"blocked"`` against
  the reference's default forward (blocked), atol/rtol 1e-4, the
  reference's own bound (``tests/test_models.py``).
* Training: reduced qwen2.5-3b, whose ``"kernel"`` config trains with
  ``"blocked"``, against ``repro.train``'s step on the reference's
  default config: the loss and every gradient, and one step's loss and
  gradient norm, at atol 2e-5 / rtol 2e-4.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro.train.data import DataConfig as RefDataConfig  # noqa: E402
from repro.train.data import make_batch as ref_make_batch  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.convert import (params_from_jax,  # noqa: E402
                                        state_dict_from_jax,
                                        train_state_from_jax)
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.step import (init_train_state,  # noqa: E402
                                    make_train_step, training_config)

ATOL = 2e-5
TOL = dict(atol=2e-5, rtol=2e-4)

# (B, Sq, Sk, H, K, D, q_chunk, kv_chunk, causal, block_skip)
CASES = [
    (2, 40, 40, 4, 2, 16, 16, 16, True, True),     # ragged tails, GQA
    (2, 40, 40, 4, 2, 16, 16, 16, True, False),    # every kv block
    (1, 33, 33, 6, 1, 8, 8, 16, True, True),       # MQA, kv_chunk > q_chunk
    (1, 48, 48, 8, 8, 32, 16, 8, True, True),      # q_chunk > kv_chunk
    (1, 37, 53, 6, 3, 8, 16, 8, False, True),      # padded kv, not causal
    (2, 24, 70, 4, 2, 16, 512, 512, False, False),  # chunks past S
    (1, 64, 64, 4, 4, 16, 64, 64, True, True),     # one block each
]


def qkv(B, Sq, Sk, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, K, D)).astype(np.float32),
            rng.standard_normal((B, Sk, K, D)).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=[
    "ragged-gqa", "no-skip", "mqa", "q-gt-kv", "padded-kv", "past-S",
    "one-block"])
def test_blocked_attention_matches_reference(case):
    B, Sq, Sk, H, K, D, qc, kc, causal, skip = case
    q, k, v = qkv(B, Sq, Sk, H, K, D)
    want = jax.jit(partial(RL.blocked_attention, causal=causal, q_chunk=qc,
                           kv_chunk=kc, block_skip=skip))(q, k, v)
    got = L.blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              q_chunk=qc, kv_chunk=kc, block_skip=skip)
    assert got.shape == (B, Sq, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("skip", [True, False])
def test_sequence_shard_equals_its_rows(skip):
    """A shard of q's rows from ``q_offset`` (a rank's sequence shard
    under a plan) attends as those rows of the whole sequence do."""
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 48, 48, 4, 2, 16, 1))
    kw = dict(causal=True, q_chunk=16, kv_chunk=16, block_skip=skip)
    whole = L.blocked_attention(q, k, v, **kw)
    part = L.blocked_attention(q[:, 24:], k, v, q_offset=24, **kw)
    np.testing.assert_allclose(part.numpy(), whole[:, 24:].numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_blocked_gradient_matches_dense(causal):
    qkv_np = qkv(2, 40, 40, 4, 2, 16, 2)
    grads = {}
    for name, fn in (("dense", L.dense_attention),
                     ("blocked", partial(L.blocked_attention, q_chunk=16,
                                         kv_chunk=16))):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv_np)
        out = fn(q, k, v, causal=causal)
        w = torch.from_numpy(np.random.default_rng(3).standard_normal(
            out.shape).astype(np.float32))
        (out * w).sum().backward()
        grads[name] = (out.detach(), q.grad, k.grad, v.grad)
    for got, want in zip(grads["blocked"], grads["dense"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=ATOL)


def test_config_takes_blocked_and_its_chunks():
    cfg = configs.get("llama3-405b")
    assert (cfg.q_chunk, cfg.kv_chunk) == (1024, 1024)
    red = configs.get_reduced("qwen2.5-3b")
    assert (red.q_chunk, red.kv_chunk) == (16, 16)
    assert red.attn_impl == "kernel"
    assert training_config(red).attn_impl == "blocked"
    assert training_config(red.replace(attn_impl="dense")).attn_impl == \
        "dense"
    with pytest.raises(ValueError, match="blocked"):
        red.replace(attn_impl="flash")


def test_model_forward_matches_reference_default():
    """Reduced chatglm3-6b (GQA, partial rotary) at S = 40 over its
    16-wide chunks: the port's "blocked" forward against the
    reference's default forward."""
    cfg_r = ref_configs.get_reduced("chatglm3-6b").replace(dtype="float32")
    assert cfg_r.attn_impl == "blocked"
    params = jax.jit(partial(T.init_params, cfg_r))(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg_r.vocab, (2, 40)).astype(
        np.int32)
    want, _, _ = jax.jit(partial(T.forward, cfg_r))(params,
                                                    {"tokens": toks})
    cfg_p = configs.get_reduced("chatglm3-6b").replace(dtype="float32",
                                                       attn_impl="blocked")
    model = params_from_jax(cfg_p, jax.tree.map(np.asarray, params),
                            device="cpu")
    got = model(torch.from_numpy(toks.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in batch.items()}


def test_train_step_matches_reference_default():
    """Reduced qwen2.5-3b at S = 40 (ragged over 16-wide chunks): the
    port's train state (its "kernel" config trains "blocked") against
    the reference's default config."""
    cfg_r = ref_configs.get_reduced("qwen2.5-3b").replace(dtype="float32")
    cfg_p = configs.get_reduced("qwen2.5-3b").replace(dtype="float32")
    o_r = ref_opt.get_optimizer("adamw", lr=1e-3)
    o_p = opt.get_optimizer("adamw", lr=1e-3)
    st_r = jax.jit(partial(ref_step.init_train_state, cfg_r, o_r))(
        jax.random.PRNGKey(0))
    batch = ref_make_batch(RefDataConfig(vocab=cfg_r.vocab, seq_len=40,
                                         global_batch=2, seed=3),
                           jnp.int32(0))
    (l_r, _), g_r = jax.jit(jax.value_and_grad(
        partial(T.loss_fn, cfg_r), has_aux=True))(st_r["params"], batch)
    _, m_r = jax.jit(ref_step.make_train_step(cfg_r, o_r))(st_r, batch)

    state = init_train_state(cfg_p, o_p, device="cpu")
    assert state["model"].cfg.attn_impl == "blocked"
    train_state_from_jax(state, jax.tree.map(np.asarray, st_r))
    model = state["model"]
    l_p, _ = PT.loss_fn(model, torch_batch(batch))
    l_p.backward()
    np.testing.assert_allclose(float(l_p.detach()), float(l_r), **TOL)
    want = state_dict_from_jax(cfg_p, jax.tree.map(np.asarray, g_r))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
        p.grad = None
    _, m_p = make_train_step(cfg_p, o_p)(state, torch_batch(batch))
    np.testing.assert_allclose(float(m_p["loss"]), float(m_r["loss"]),
                               **TOL)
    np.testing.assert_allclose(float(m_p["grad_norm"]),
                               float(m_r["grad_norm"]), **TOL)
