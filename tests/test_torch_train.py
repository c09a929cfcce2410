"""The port's training path against the JAX package on the CPU: the
loss and its gradients for every family, the training fields of the
configs and the top-level API.

Reduced configs in float32.  The port's model carries the reference's
own parameters (``params_from_jax``) and takes the reference's own
batches (``repro.train.data.make_batch``), as numpy.

* ``loss_fn``: the loss, the aux loss and every parameter's gradient
  for dense, moe, ssm, hybrid, vlm (with ``vision_embeds``) and audio,
  with ``remat`` "block" and "none": atol 2e-5, rtol 2e-4.  With
  "block" every layer (and every application of the hybrid's shared
  block) must run under ``torch.utils.checkpoint``.
* The training fields of every config copy equal the reference's, and
  a value outside the reference's choices raises.
* ``repro_torch.__all__`` covers ``repro.__all__``.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.train.data import DataConfig as RefDataConfig  # noqa: E402
from repro.train.data import make_batch as ref_make_batch  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.convert import (params_from_jax,  # noqa: E402
                                        state_dict_from_jax)

TOL = dict(atol=2e-5, rtol=2e-4)
FAMILY_ARCHS = ("qwen2.5-3b", "qwen3-moe-30b-a3b", "mamba2-1.3b",
                "zamba2-1.2b", "llava-next-34b", "hubert-xlarge")
TRAIN_FIELDS = ("remat", "microbatch", "grad_accum", "grad_accum_dtype",
                "optimizer")


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


def data_cfg(cfg, B=2, S=32, seed=3) -> RefDataConfig:
    kind = {"vlm": "vlm", "audio": "audio"}.get(cfg.family, "lm")
    return RefDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                         seed=seed, kind=kind, d_model=cfg.d_model,
                         n_prefix=cfg.n_prefix)


def as_torch(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype == np.int32:
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a)


def torch_batch(batch: dict) -> dict:
    return {k: as_torch(v) for k, v in batch.items()}


def close(got, want, **tol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# configs and the top-level API
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_training_fields_match_reference(arch):
    for which in ("get", "get_reduced"):
        port = getattr(configs, which)(arch)
        ref = getattr(ref_configs, which)(arch)
        for name in TRAIN_FIELDS:
            assert getattr(port, name) == getattr(ref, name), (which, name)


@pytest.mark.parametrize("field,bad", [("remat", "full"),
                                       ("grad_accum", "pipeline"),
                                       ("grad_accum_dtype", "float16"),
                                       ("optimizer", "sgd"),
                                       ("microbatch", 0)])
def test_training_fields_are_validated(field, bad):
    with pytest.raises(ValueError, match=field):
        configs.get_reduced("qwen2.5-3b").replace(**{field: bad})


def test_exports_cover_the_reference():
    assert set(repro.__all__) <= set(repro_torch.__all__)
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_reference(arch, remat, monkeypatch):
    cfg_r, cfg_p = ref_cfg(arch, remat=remat), port_cfg(arch, remat=remat)
    params = jax.jit(partial(T.init_params, cfg_r))(jax.random.PRNGKey(1))
    batch = ref_make_batch(data_cfg(cfg_r), jnp.int32(0))
    if cfg_r.family == "vlm":
        assert "vision_embeds" in batch
    (l_r, m_r), g_r = jax.jit(jax.value_and_grad(
        partial(T.loss_fn, cfg_r), has_aux=True))(params, batch)

    model = params_from_jax(cfg_p, jax.tree.map(np.asarray, params),
                            device="cpu")
    calls = []
    real = PT.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)
    monkeypatch.setattr(PT, "checkpoint", counting)
    l_p, m_p = PT.loss_fn(model, torch_batch(batch))
    l_p.backward()

    n_apps = PT.n_shared_apps(cfg_p)
    assert len(calls) == (cfg_p.n_layers + n_apps if remat == "block"
                          else 0)
    close(l_p, l_r)
    for key in ("loss", "aux", "tokens"):
        close(m_p[key], m_r[key])
    want = state_dict_from_jax(cfg_p, jax.tree.map(np.asarray, g_r))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def test_forward_keeps_no_grad():
    """The serving entry points still build no graph."""
    model = PT.Transformer(port_cfg("qwen2.5-3b"), device="cpu")
    tokens = torch.zeros(1, 4, dtype=torch.long)
    assert not model(tokens).requires_grad
    cache, logits = model.prefill(tokens, 8)
    assert not logits.requires_grad
    _, logits = model.decode_step(cache, tokens[:, 0])
    assert not logits.requires_grad
