"""The rest of the dense family in the port: chatglm3-6b, gemma-7b (with
its int8 KV cache) and llama3-405b, against the JAX package on the CPU.

The config copies equal the reference's field by field.  Reduced models
in float32 carry the reference's own parameters over by
``params_from_jax`` and must give its logits and caches in forward,
prefill and decode (atol 2e-4, rtol 2e-3, as tests/test_models.py); the
int8 cache's values may differ by one step where the two packages'
float keys straddle a rounding tie, so the int8 decode is also held on
the reference's own cache.  The serving engine on gemma-7b reduced with
an int8 cache gives the reference engine's schedule and greedy tokens.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import Transformer, _commit_kv  # noqa: E402
from repro_torch.serving import Engine, EngineConfig, Request  # noqa: E402

ARCHS = ("chatglm3-6b", "gemma-7b", "llama3-405b")
TOL = dict(atol=2e-4, rtol=2e-3)
# port fields whose value differs from the reference's by design
PORT_ONLY = {"attn_impl"}
# (arch, overrides): gemma-7b with its int8 cache, once at head_dim 256
MODEL_CASES = [
    ("chatglm3-6b", {}),
    ("llama3-405b", {}),
    ("gemma-7b", dict(kv_cache_dtype="int8")),
    ("gemma-7b", dict(kv_cache_dtype="int8", head_dim=256)),
]


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def as_long(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.int64))


def tokens(B, S, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def pair(arch: str, **kw):
    """(reference config, its parameters, the port's model with them)."""
    cfg_r = ref_configs.get_reduced(arch).replace(dtype="float32", **kw)
    cfg_p = configs.get_reduced(arch).replace(dtype="float32", **kw)
    params = jax.jit(partial(T.init_params, cfg_r))(jax.random.PRNGKey(1))
    model = params_from_jax(cfg_p, jax.tree.map(np.asarray, params),
                            device="cpu")
    return cfg_r, params, model


def assert_cache_close(cache_t: dict, cache_j: dict) -> None:
    """Equal keys; float entries within TOL; int8 entries within one
    step (rounding ties of float keys that differ in the last bit)."""
    assert set(cache_t) == set(cache_j)
    for key, want in cache_j.items():
        want = np.asarray(want)
        got = cache_t[key]
        assert tuple(got.shape) == want.shape, key
        if want.dtype == np.int8:
            assert got.dtype == torch.int8, key
            diff = np.abs(got.numpy().astype(np.int32) - want)
            assert diff.max() <= 1 and diff.mean() < 1e-3, key
        elif key == "pos":
            assert got.tolist() == want.tolist()
        else:
            close(got, want)


def as_torch_cache(cache_j: dict) -> dict:
    """A writable copy of a reference cache for the port's decode_step."""
    return {k: torch.from_numpy(np.array(v)) for k, v in cache_j.items()}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    assert arch in configs.ARCH_IDS
    for which in ("get", "get_reduced"):
        port = getattr(configs, which)(arch)
        ref = getattr(ref_configs, which)(arch)
        compared = [f.name for f in dataclasses.fields(port)
                    if f.name not in PORT_ONLY]
        assert all(hasattr(ref, name) for name in compared)
        diff = {n: (getattr(port, n), getattr(ref, n)) for n in compared
                if getattr(port, n) != getattr(ref, n)}
        assert not diff, (which, diff)


def test_kv_cache_dtype_is_validated():
    cfg = configs.get_reduced("gemma-7b")
    assert cfg.kv_cache_dtype == "bfloat16"
    assert configs.get("gemma-7b").kv_cache_dtype == "int8"
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        cfg.replace(kv_cache_dtype="float8")


def test_hybrid_int8_keeps_a_float_cache():
    """As in the reference, the hybrid family ignores kv_cache_dtype."""
    arch = "zamba2-1.2b"
    cfg_r = ref_configs.get_reduced(arch).replace(kv_cache_dtype="int8")
    cfg_p = configs.get_reduced(arch).replace(kv_cache_dtype="int8")
    want = T.init_cache(cfg_r, 2, 8)
    got = Transformer(cfg_p, device="cpu").init_cache(2, 8)
    assert set(got) == set(want) and "k_scale" not in got
    assert got["k"].dtype == torch.bfloat16
    assert str(want["k"].dtype) == "bfloat16"


def test_int8_cache_layout_matches_reference():
    cfg_r = ref_configs.get_reduced("gemma-7b").replace(kv_cache_dtype="int8")
    cfg_p = configs.get_reduced("gemma-7b").replace(kv_cache_dtype="int8")
    want = T.init_cache(cfg_r, 3, 12)
    got = Transformer(cfg_p, device="cpu").init_cache(3, 12)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)


def test_commit_kv_takes_scale_arrays():
    """_commit_kv writes [B,Smax,K] scales as the reference's does, the
    last slot where the position runs past the end."""
    rng = np.random.default_rng(11)
    cache = rng.standard_normal((1, 3, 5, 2), np.float32)
    new = rng.standard_normal((1, 3, 1, 2), np.float32)
    pos = np.array([0, 4, 7], np.int32)
    want = T._commit_kv(jnp.asarray(cache), jnp.asarray(new),
                        jnp.asarray(pos))
    got = torch.from_numpy(cache[0].copy())
    _commit_kv(got, torch.from_numpy(new[0]), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw", MODEL_CASES,
                         ids=[f"{a}-{'-'.join(map(str, k.values()))}"
                              for a, k in MODEL_CASES])
def test_model_matches_reference(arch, kw):
    """Forward, prefill and three decode steps with one slot inactive.
    With an int8 cache each step starts from the reference's cache: a
    key that straddles a rounding tie is stored one step apart by the
    two packages (~1e-3 in the next logits), which is quantization, not
    the decode under test; the entries each step commits are compared."""
    cfg_r, params, model = pair(arch, **kw)
    int8 = kw.get("kv_cache_dtype") == "int8"
    toks = tokens(2, 10, seed=1)
    want, _, _ = T.forward(cfg_r, params, {"tokens": toks})
    close(model(as_long(toks)), want)
    cache_j, logits_j = T.prefill(cfg_r, params, {"tokens": toks},
                                  max_len=16)
    cache_t, logits_t = model.prefill(as_long(toks), 16)
    close(logits_t, logits_j)
    assert_cache_close(cache_t, cache_j)
    assert (cache_t["k"].dtype == torch.int8) == int8
    active = (True, False)
    for step in range(3):
        if int8:
            cache_t = as_torch_cache(cache_j)
        nxt = tokens(2, 1, seed=10 + step)[:, 0]
        cache_j, logits_j = T.decode_step(cfg_r, params, cache_j,
                                          jnp.asarray(nxt),
                                          active=jnp.asarray(active))
        cache_t, logits_t = model.decode_step(cache_t, as_long(nxt),
                                              active=torch.tensor(active))
        close(logits_t, logits_j)
        assert_cache_close(cache_t, cache_j)
    assert cache_t["pos"].tolist() == [13, 10]


@pytest.mark.parametrize("head_dim", [32, 256])
def test_int8_decode_on_the_reference_cache(head_dim):
    """The port's decode_step on the reference's own int8 cache: no
    rounding tie stands between the two, so logits agree tightly and the
    committed int8 entries agree to one step."""
    cfg_r, params, model = pair("gemma-7b", kv_cache_dtype="int8",
                                head_dim=head_dim)
    cache_j, _ = T.prefill(cfg_r, params, {"tokens": tokens(2, 9, seed=3)},
                           max_len=12)
    cache_t = as_torch_cache(cache_j)
    nxt = tokens(2, 1, seed=4)[:, 0]
    active = (False, True)
    cache_j, logits_j = T.decode_step(cfg_r, params, cache_j,
                                      jnp.asarray(nxt),
                                      active=jnp.asarray(active))
    cache_t, logits_t = model.decode_step(cache_t, as_long(nxt),
                                          active=torch.tensor(active))
    close(logits_t, logits_j, atol=2e-5, rtol=2e-5)
    assert_cache_close(cache_t, cache_j)


def test_dense_equals_kernel_with_int8_cache_on_cpu():
    """attn_impl="kernel" (the decode kernel's plain version with the
    scales) equals attn_impl="dense" (the model layer) on an int8 cache."""
    cfg_r, params, model = pair("gemma-7b", kv_cache_dtype="int8",
                                head_dim=256)
    dense = params_from_jax(model.cfg.replace(attn_impl="dense"),
                            jax.tree.map(np.asarray, params), device="cpu")
    toks = as_long(tokens(2, 7, seed=5))
    cache_k, _ = model.prefill(toks, 10)
    cache_d, _ = dense.prefill(toks, 10)
    for step in range(2):
        _, lk = model.decode_step(cache_k, toks[:, step])
        _, ld = dense.decode_step(cache_d, toks[:, step])
        close(lk, ld.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def schedule(done):
    return [(r.rid, r.first_start, r.finish, r.served_ticks, r.n_ctx,
             r.demoted, r.queue_delay) for r in done]


def record_tokens(engine, log):
    run = engine._run_decode

    def wrapped(reqs):
        out = run(reqs)
        log.append((engine.t, sorted(out.items())))
        return out
    engine._run_decode = wrapped


def test_engine_int8_gemma_tokens_match_reference():
    """The slot copy carries k_scale and v_scale with the int8 keys and
    values: equal schedule and greedy tokens to the reference engine."""
    cfg_r, params, model = pair("gemma-7b", kv_cache_dtype="int8")
    rng = np.random.default_rng(2)
    n = 6
    svc = rng.integers(2, 9, n)
    arr = np.cumsum(rng.integers(0, 3, n))
    lens = (3, 5)
    prompts = {i: rng.integers(0, cfg_r.vocab, lens[i % 2]) for i in range(n)}

    def wl(cls):
        return [cls(rid=i, arrival=int(arr[i]), prompt_len=lens[i % 2],
                    n_tokens=int(svc[i])) for i in range(n)]
    ecfg = dict(lanes=2, n_slots=3, max_len=24, policy="sfs")
    ref = RefEngine(RefEngineConfig(**ecfg), model_cfg=cfg_r, params=params)
    port = Engine(EngineConfig(**ecfg), model, device="cpu")
    assert port.cache["k"].dtype == torch.int8
    assert port.cache["k_scale"].shape == (cfg_r.n_layers, 3, 24,
                                           cfg_r.n_kv_heads)
    toks_r, toks_p = [], []
    record_tokens(ref, toks_r)
    record_tokens(port, toks_p)
    done_r = ref.run(wl(RefRequest), prompts=prompts)
    done_p = port.run(wl(Request), prompts=prompts)
    assert schedule(done_p) == schedule(done_r)
    assert toks_p == toks_r
    assert sum(len(t) for _, t in toks_p) == int(svc.sum())
    assert port.cache["k_scale"].abs().sum() > 0


@pytest.mark.parametrize("arch", ["chatglm3-6b", "gemma-7b"])
def test_serve_main_runs_new_archs_on_cpu(arch):
    s = serve.main(["--arch", arch, "--device", "cpu", "--requests", "4",
                    "--policy", "sfs", "--slots", "4", "--max-len", "160"])
    assert s["n"] == 4 and s["incomplete"] == 0
    assert s["prefills"] == 4 and s["decode_steps"] > 0
