"""The port's dense decoder against repro.models.transformer on the CPU.

Reduced qwen2.5-3b in float32, with the reference's own parameters carried
over by ``params_from_jax``; tolerances are those of tests/test_models.py
(atol 2e-4, rtol 2e-3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import Transformer, _commit_kv  # noqa: E402

ARCH = "qwen2.5-3b"
TOL = dict(atol=2e-4, rtol=2e-3)


def ref_cfg(**kw):
    return ref_configs.get_reduced(ARCH).replace(dtype="float32", **kw)


def port_cfg(**kw):
    return configs.get_reduced(ARCH).replace(dtype="float32", **kw)


@pytest.fixture(scope="module")
def pair():
    """(reference params, the same weights in the port's model)."""
    params = T.init_params(ref_cfg(), jax.random.PRNGKey(1))
    model = params_from_jax(port_cfg(), jax.tree.map(np.asarray, params),
                            device="cpu")
    return params, model


def tokens(B, S, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def as_long(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.int64))


def test_forward_matches_reference(pair):
    params, model = pair
    toks = tokens(2, 24)
    want, _, _ = T.forward(ref_cfg(), params, {"tokens": toks})
    got = model(as_long(toks))
    assert got.shape == (2, 24, ref_cfg().vocab_padded)
    close(got, want)


def test_prefill_matches_reference(pair):
    params, model = pair
    toks = tokens(2, 12, seed=1)
    cache_j, logits_j = T.prefill(ref_cfg(), params, {"tokens": toks},
                                  max_len=20)
    cache_t, logits_t = model.prefill(as_long(toks), 20)
    close(logits_t, logits_j)
    for key in ("k", "v"):
        assert cache_t[key].shape == cache_j[key].shape
        close(cache_t[key], cache_j[key])
    assert cache_t["pos"].tolist() == np.asarray(cache_j["pos"]).tolist()


@pytest.mark.parametrize("active", [None, (True, False), (False, True)])
def test_decode_steps_match_reference(pair, active):
    params, model = pair
    cache_j, _ = T.prefill(ref_cfg(), params, {"tokens": tokens(2, 10, 2)},
                           max_len=16)
    cache_t, _ = model.prefill(as_long(tokens(2, 10, 2)), 16)
    act_j = None if active is None else jnp.asarray(active)
    act_t = None if active is None else torch.tensor(active)
    for step in range(2):
        nxt = tokens(2, 1, seed=10 + step)[:, 0]
        cache_j, logits_j = T.decode_step(ref_cfg(), params, cache_j,
                                          jnp.asarray(nxt), active=act_j)
        cache_t, logits_t = model.decode_step(cache_t, as_long(nxt),
                                              active=act_t)
        close(logits_t, logits_j)
        for key in ("k", "v"):
            close(cache_t[key], cache_j[key])
        assert cache_t["pos"].tolist() == np.asarray(cache_j["pos"]).tolist()


def test_decode_at_full_cache_matches_reference(pair):
    """pos == Smax: attention reads the whole cache, and the commit lands
    on the last slot (dynamic_update_slice's clamp)."""
    params, model = pair
    toks = tokens(2, 8, seed=4)
    cache_j, _ = T.prefill(ref_cfg(), params, {"tokens": toks}, max_len=8)
    cache_t, _ = model.prefill(as_long(toks), 8)
    nxt = tokens(2, 1, seed=5)[:, 0]
    cache_j, logits_j = T.decode_step(ref_cfg(), params, cache_j,
                                      jnp.asarray(nxt))
    cache_t, logits_t = model.decode_step(cache_t, as_long(nxt))
    close(logits_t, logits_j)
    close(cache_t["k"], cache_j["k"])
    assert cache_t["pos"].tolist() == [9, 9]


def test_prefill_then_decode_matches_forward(pair):
    _, model = pair
    toks = tokens(2, 25, seed=6)
    full = model(as_long(toks))
    cache, _ = model.prefill(as_long(toks[:, :24]), 32)
    _, dec = model.decode_step(cache, as_long(toks[:, 24]))
    close(dec[:, 0], full[:, -1].numpy())


def test_active_mask_freezes_pos(pair):
    _, model = pair
    cache, _ = model.prefill(as_long(tokens(2, 16, seed=7)), 24)
    cache, _ = model.decode_step(cache, as_long(tokens(2, 1)[:, 0]),
                                 active=torch.tensor([True, False]))
    assert cache["pos"].tolist() == [17, 16]


def test_dense_equals_kernel_on_cpu(pair):
    """attn_impl="kernel" takes the kernels' plain versions on the CPU;
    it must equal the plain attention layers."""
    params, model = pair
    dense = params_from_jax(port_cfg(attn_impl="dense"),
                            jax.tree.map(np.asarray, params), device="cpu")
    toks = as_long(tokens(2, 12, seed=8))
    tight = dict(atol=1e-5, rtol=1e-5)
    close(dense(toks), model(toks).numpy(), **tight)
    cache_d, _ = dense.prefill(toks, 16)
    cache_k, _ = model.prefill(toks, 16)
    active = torch.tensor([True, False])
    _, ld = dense.decode_step(cache_d, toks[:, 0], active=active)
    _, lk = model.decode_step(cache_k, toks[:, 0], active=active)
    close(ld, lk.numpy(), **tight)


@pytest.mark.parametrize("variant", [
    dict(tie_embeddings=True),
    dict(embed_scale=True, activation="geglu"),
    dict(rope_fraction=0.5, qkv_bias=False),
])
def test_dense_variants_match_reference(variant):
    params = T.init_params(ref_cfg(**variant), jax.random.PRNGKey(3))
    model = params_from_jax(port_cfg(**variant),
                            jax.tree.map(np.asarray, params), device="cpu")
    toks = tokens(2, 10, seed=9)
    want, _, _ = T.forward(ref_cfg(**variant), params, {"tokens": toks})
    close(model(as_long(toks)), want)
    cache_j, _ = T.prefill(ref_cfg(**variant), params, {"tokens": toks},
                           max_len=12)
    cache_t, _ = model.prefill(as_long(toks), 12)
    _, dj = T.decode_step(ref_cfg(**variant), params, cache_j,
                          jnp.asarray(toks[:, 0]))
    _, dt = model.decode_step(cache_t, as_long(toks[:, 0]))
    close(dt, dj)


def test_commit_kv_clamps_like_reference():
    rng = np.random.default_rng(11)
    cache = rng.standard_normal((1, 3, 5, 2, 4), np.float32)
    new = rng.standard_normal((1, 3, 1, 2, 4), np.float32)
    pos = np.array([0, 4, 7], np.int32)
    want = T._commit_kv(jnp.asarray(cache), jnp.asarray(new),
                        jnp.asarray(pos))
    got = torch.from_numpy(cache[0].copy())
    _commit_kv(got, torch.from_numpy(new[0]), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])


def test_random_init_is_seeded_and_scaled():
    cfg = port_cfg()
    a = Transformer(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    b = Transformer(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.layers[0].mlp.w_up.weight            # [d_ff, d]: fan-in d
    assert w.abs().max() <= 2.0 / np.sqrt(cfg.d_model) + 1e-6
    assert abs(w.std().item() * np.sqrt(cfg.d_model) - 0.88) < 0.05
    assert torch.equal(a.layers[0].ln1.scale, torch.ones(cfg.d_model))
    assert a.layers[0].ln1.scale.dtype == torch.float32


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_family_constructs(arch):
    """Every architecture of the reference's registry is ported: the
    reduced config of each builds on the CPU, one per family at least,
    with the layers its family calls for."""
    assert set(configs.ARCH_IDS) == set(ref_configs.ARCH_IDS)
    cfg = configs.get_reduced(arch)
    model = Transformer(cfg, device="cpu")
    blk = model.layers[0]
    if cfg.family in ("ssm", "hybrid"):
        assert hasattr(blk, "mamba")
    else:
        assert hasattr(blk, "moe" if cfg.family == "moe" else "mlp")
    assert (model.embed is None) == (cfg.family == "audio")
    assert {configs.get_reduced(a).family for a in configs.ARCH_IDS} == {
        "dense", "moe", "ssm", "hybrid", "vlm", "audio"}
