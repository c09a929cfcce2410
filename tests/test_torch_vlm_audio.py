"""The vlm and audio families in the port: llava-next-34b and
hubert-xlarge against the JAX package on the CPU.

The config copies equal the reference's.  Reduced models in float32
carry the reference's own parameters over by ``params_from_jax``; the
synthetic patch and frame embeddings are the reference's
(``repro.models.frontends``, drawn with ``jax.random``), passed to both
packages as numpy.  llava: forward and prefill with and without
``vision_embeds``, decode steps after them (also with an int8 cache,
each step on the reference's cache), and ``serve.main`` giving the
reference launcher's schedule.  hubert: the non-causal forward over
frames; it has no cache, prefill or decode step.  Tolerances are those
of tests/test_models.py (atol 2e-4, rtol 2e-3).
"""
import dataclasses
from functools import lru_cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import frontends as ref_frontends  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

VLM, AUDIO = "llava-next-34b", "hubert-xlarge"
TOL = dict(atol=2e-4, rtol=2e-3)
PORT_ONLY = {"attn_impl"}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Reduced models are many tiny tensor ops: intra-op threads add
    nothing, and beside the reference's own thread pool (and other test
    workers) their spin-waiting slows every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def as_long(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.int64))


def tokens(B, S, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@lru_cache(maxsize=None)
def ref_params(arch: str):
    """The reference's float32 parameters of the reduced ``arch`` (the
    KV cache's dtype changes none of them)."""
    cfg_r = ref_configs.get_reduced(arch).replace(dtype="float32")
    return jax.jit(partial(T.init_params, cfg_r))(jax.random.PRNGKey(1))


@lru_cache(maxsize=None)
def pair(arch: str, kv_cache_dtype: str = "bfloat16"):
    """(reference config, its parameters, the port's model with them)."""
    kw = dict(dtype="float32", kv_cache_dtype=kv_cache_dtype)
    cfg_r = ref_configs.get_reduced(arch).replace(**kw)
    params = ref_params(arch)
    model = params_from_jax(configs.get_reduced(arch).replace(**kw),
                            jax.tree.map(np.asarray, params), device="cpu")
    return cfg_r, params, model


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_config_copies_match_reference(arch):
    assert arch in configs.ARCH_IDS
    for which in ("get", "get_reduced"):
        port = getattr(configs, which)(arch)
        ref = getattr(ref_configs, which)(arch)
        compared = [f.name for f in dataclasses.fields(port)
                    if f.name not in PORT_ONLY]
        diff = {n: (getattr(port, n), getattr(ref, n)) for n in compared
                if getattr(port, n) != getattr(ref, n)}
        assert not diff, (which, diff)
    assert configs.get(VLM).kv_cache_dtype == "int8"
    assert not configs.get(AUDIO).causal


# ---------------------------------------------------------------------------
# vlm
# ---------------------------------------------------------------------------


def vision(cfg_r, B: int, seed: int = 3) -> np.ndarray:
    return np.array(ref_frontends.synth_vision_embeds(
        cfg_r, jax.random.PRNGKey(seed), B))


@pytest.mark.parametrize("with_vision", [False, True],
                         ids=["tokens", "vision"])
def test_vlm_matches_reference(with_vision):
    """forward, prefill (logits and cache) and two decode steps with one
    slot inactive, with and without the vision prefix."""
    cfg_r, params, model = pair(VLM)
    toks = tokens(2, 12, seed=1)
    batch = {"tokens": toks}
    ve_t = None
    if with_vision:
        ve = vision(cfg_r, 2)
        assert ve.shape == (2, cfg_r.n_prefix, cfg_r.d_model)
        batch["vision_embeds"] = ve
        ve_t = torch.from_numpy(ve)
    want, _, _ = T.forward(cfg_r, params, batch)
    close(model(as_long(toks), vision_embeds=ve_t), want)
    cache_j, logits_j = T.prefill(cfg_r, params, batch, max_len=16)
    cache_t, logits_t = model.prefill(as_long(toks), 16, vision_embeds=ve_t)
    close(logits_t, logits_j)
    for key in ("k", "v"):
        close(cache_t[key], cache_j[key])
    active = (False, True)
    for step in range(2):
        nxt = tokens(2, 1, seed=10 + step)[:, 0]
        cache_j, logits_j = T.decode_step(cfg_r, params, cache_j,
                                          jnp.asarray(nxt),
                                          active=jnp.asarray(active))
        cache_t, logits_t = model.decode_step(cache_t, as_long(nxt),
                                              active=torch.tensor(active))
        close(logits_t, logits_j)
        close(cache_t["k"], cache_j["k"])
    assert cache_t["pos"].tolist() == [12, 14]


def test_vision_prefix_changes_only_what_follows_it():
    """The vision embeddings replace the first n_prefix token embeddings:
    the logits change there and after (causal attention), and a prompt
    of exactly n_prefix tokens is all vision."""
    cfg_r, params, model = pair(VLM)
    P = cfg_r.n_prefix
    toks = as_long(tokens(1, P + 4, seed=2))
    ve = torch.from_numpy(vision(cfg_r, 1))
    plain = model(toks)
    seen = model(toks, vision_embeds=ve)
    assert (seen - plain).abs().amax(-1).min() > 1e-3
    other = toks.clone()
    other[:, :P] = (other[:, :P] + 1) % cfg_r.vocab
    close(model(other, vision_embeds=ve), seen.numpy(), atol=1e-6,
          rtol=1e-6)
    with pytest.raises(ValueError, match="vision"):
        model(toks[:, :P - 1], vision_embeds=ve)


def test_vlm_int8_decode_on_the_reference_cache():
    """llava's full config keeps an int8 cache: the prefill's int8
    entries within one step of the reference's, and a decode step on the
    reference's own cache gives its logits."""
    cfg_r, params, model = pair(VLM, kv_cache_dtype="int8")
    toks = tokens(2, 10, seed=4)
    batch = {"tokens": toks, "vision_embeds": vision(cfg_r, 2)}
    cache_j, logits_j = T.prefill(cfg_r, params, batch, max_len=12)
    cache_t, logits_t = model.prefill(
        as_long(toks), 12, vision_embeds=torch.from_numpy(
            batch["vision_embeds"]))
    close(logits_t, logits_j)
    assert set(cache_t) == set(cache_j)
    assert cache_t["k"].dtype == torch.int8
    for key in ("k", "v"):
        diff = np.abs(cache_t[key].numpy().astype(np.int32)
                      - np.asarray(cache_j[key]))
        assert diff.max() <= 1 and diff.mean() < 1e-3, key
    cache_t = {k: torch.from_numpy(np.array(v)) for k, v in cache_j.items()}
    nxt = tokens(2, 1, seed=5)[:, 0]
    _, logits_j = T.decode_step(cfg_r, params, cache_j, jnp.asarray(nxt))
    _, logits_t = model.decode_step(cache_t, as_long(nxt))
    close(logits_t, logits_j, atol=2e-5, rtol=2e-5)


def test_synth_vision_embeds():
    cfg = configs.get_reduced(VLM).replace(dtype="float32")
    a = frontends.synth_vision_embeds(cfg, torch.Generator().manual_seed(0),
                                      3)
    b = frontends.synth_vision_embeds(cfg, torch.Generator().manual_seed(0),
                                      3)
    assert a.shape == (3, cfg.n_prefix, cfg.d_model)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert abs(a.std().item() - 0.02) < 0.004
    bf = frontends.synth_vision_embeds(configs.get_reduced(VLM),
                                       torch.Generator().manual_seed(0), 1)
    assert bf.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="vlm"):
        frontends.synth_vision_embeds(configs.get_reduced(AUDIO),
                                      torch.Generator(), 1)


def test_serve_summary_matches_reference():
    """serve.main on reduced llava (tokens only, as the reference's
    engine): the reference launcher's schedule summary."""
    args = ["--arch", VLM, "--requests", "6", "--slots", "4", "--max-len",
            "160", "--policy", "sfs"]
    want = ref_serve.main(args)
    got = serve.main(args + ["--device", "cpu"])
    assert {k: got[k] for k in want} == want
    assert got["incomplete"] == 0 and got["prefills"] == 6
    assert got["decode_steps"] > 0


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------


def frames(cfg_r, B: int, S: int, seed: int = 6) -> np.ndarray:
    return np.array(ref_frontends.synth_audio_frames(
        cfg_r, jax.random.PRNGKey(seed), B, S))


def test_audio_forward_matches_reference():
    cfg_r, params, model = pair(AUDIO)
    assert model.embed is None
    assert "embed" not in params
    x = frames(cfg_r, 2, 20)
    want, aux_j, _ = T.forward(cfg_r, params, {"frames": x})
    got, aux_t = model(torch.from_numpy(x), return_aux=True)
    assert got.shape == (2, 20, cfg_r.vocab_padded)
    close(got, want)
    assert float(aux_t) == float(aux_j) == 0.0


def test_audio_attention_is_not_causal():
    """A change to the last frame reaches the first position's logits."""
    cfg_r, _, model = pair(AUDIO)
    x = torch.from_numpy(frames(cfg_r, 1, 9))
    y = x.clone()
    y[0, -1] += 1.0
    assert (model(x)[0, 0] - model(y)[0, 0]).abs().max() > 1e-4


def test_audio_is_encoder_only():
    cfg = configs.get_reduced(AUDIO).replace(dtype="float32")
    model = Transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        model.init_cache(2, 8)
    with pytest.raises(ValueError, match="encoder-only"):
        model.prefill(torch.zeros(1, 4, cfg.d_model), 8)
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode_step({}, torch.zeros(1, dtype=torch.long))
    for main, extra in ((serve.main, ["--device", "cpu"]),
                        (ref_serve.main, [])):
        with pytest.raises(SystemExit, match="encoder-only"):
            main(["--arch", AUDIO, "--requests", "2"] + extra)


def test_synth_audio_frames():
    cfg = configs.get_reduced(AUDIO)
    a = frontends.synth_audio_frames(cfg, torch.Generator().manual_seed(1),
                                     2, 7)
    assert a.shape == (2, 7, cfg.d_model) and a.dtype == torch.bfloat16
    assert torch.equal(a, frontends.synth_audio_frames(
        cfg, torch.Generator().manual_seed(1), 2, 7))
    with pytest.raises(ValueError, match="audio"):
        frontends.synth_audio_frames(configs.get_reduced(VLM),
                                     torch.Generator(), 1, 4)
