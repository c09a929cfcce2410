"""The port's Mamba2 blocks and the ssm / hybrid decoders against
repro.models.mamba2 and repro.models.transformer on the CPU.

Reduced mamba2-1.3b (ssm) and zamba2-1.2b (hybrid: 5 Mamba layers, the
shared block after layers 2 and 4, one layer left over) in float32, with
the reference's own parameters carried over by ``params_from_jax``.  The
same numpy inputs go to both packages; the reference's functions are
jitted.  Tolerances are those of tests/test_models.py (atol 2e-4, rtol
2e-3); a frozen slot's recurrent state must stay bit for bit.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import mamba2 as RM  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import mamba2 as PM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

ARCHS = ["mamba2-1.3b", "zamba2-1.2b"]
TOL = dict(atol=2e-4, rtol=2e-3)
MAX_LEN = 32


def ref_cfg(arch):
    return ref_configs.get_reduced(arch).replace(dtype="float32")


def port_cfg(arch, **kw):
    return configs.get_reduced(arch).replace(dtype="float32", **kw)


class Ref:
    """The reference model of one reduced arch: params and jitted entry
    points (prefill is compiled once per prompt length)."""

    def __init__(self, arch, seed):
        cfg = ref_cfg(arch)
        self.cfg = cfg
        self.params = jax.jit(partial(T.init_params, cfg))(
            jax.random.PRNGKey(seed))
        self._forward = jax.jit(
            lambda p, t: T.forward(cfg, p, {"tokens": t})[0])
        self._prefill = jax.jit(
            lambda p, t: T.prefill(cfg, p, {"tokens": t}, MAX_LEN))
        self._decode = jax.jit(partial(T.decode_step, cfg))

    def forward(self, toks):
        return np.asarray(self._forward(self.params, toks))

    def prefill(self, toks):
        return self._prefill(self.params, toks)

    def decode(self, cache, toks, active):
        return self._decode(self.params, cache, jnp.asarray(toks),
                            jnp.asarray(active))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference, the same weights in the port's model) per arch."""
    ref = Ref(request.param, seed=1)
    model = params_from_jax(port_cfg(request.param),
                            jax.tree.map(np.asarray, ref.params),
                            device="cpu")
    return ref, model


def tokens(B, S, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def as_long(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.int64))


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


def block_pair(seed=0):
    """A reduced mamba2 mixer's reference params and the port's block."""
    cfg = ref_cfg("mamba2-1.3b")
    p = jax.tree.map(np.asarray, RM.init_mamba_block(
        jax.random.PRNGKey(seed), cfg.d_model, cfg.ssm, jnp.float32))
    blk = PM.MambaBlock(cfg.d_model, port_cfg("mamba2-1.3b").ssm, "cpu",
                        torch.float32)
    sd = {"in_proj.weight": p["in_proj"].T, "out_proj.weight": p["out_proj"].T,
          "gate_norm.scale": p["gate_norm"]["scale"]}
    for name in ("conv_w", "conv_b", "A_log", "dt_bias", "D"):
        sd[name] = p[name]
    blk.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in sd.items()})
    return cfg, p, blk


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(with_tail):
    rng = np.random.default_rng(0)
    seq = rng.standard_normal((2, 5, 12), np.float32)
    w = rng.standard_normal((4, 12), np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    tail = rng.standard_normal((2, 3, 12), np.float32) if with_tail else None
    want = RM._causal_conv(jnp.asarray(seq), jnp.asarray(w), jnp.asarray(b),
                           tail=None if tail is None else jnp.asarray(tail))
    got = PM._causal_conv(
        torch.from_numpy(seq), torch.from_numpy(w), torch.from_numpy(b),
        tail=None if tail is None else torch.from_numpy(tail))
    close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("S", [2, 21])
def test_mamba_block_matches_reference(S, impl):
    """forward == mamba_block (y) and _mamba_prefill_states (the decode
    state), for a prompt shorter than the conv width and a ragged one
    (21 = 16 + 5 with chunk 16)."""
    cfg, p, blk = block_pair()
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model),
                                                 np.float32)
    want = jax.jit(RM.mamba_block, static_argnums=2)(p, jnp.asarray(x),
                                                      cfg.ssm)
    _, st = jax.jit(T._mamba_prefill_states, static_argnums=0)(
        cfg, p, jnp.asarray(x))
    with torch.no_grad():
        y, state = blk(torch.from_numpy(x), impl)
    close(y, want)
    close(state["h"], st["h"])
    close(state["conv_tail"], st["conv_tail"])
    assert state["conv_tail"].shape == (2, 3, blk.conv_w.shape[1])


def test_mamba_block_step_matches_reference():
    cfg, p, blk = block_pair(seed=2)
    rng = np.random.default_rng(3)
    H, P, N = blk.n_heads, cfg.ssm.head_dim, cfg.ssm.d_state
    x = rng.standard_normal((3, 1, cfg.d_model), np.float32)
    h = rng.standard_normal((3, H, P, N), np.float32)
    tail = rng.standard_normal((3, 3, blk.conv_w.shape[1]), np.float32)
    st, want = jax.jit(RM.mamba_block_step, static_argnums=3)(
        p, {"h": jnp.asarray(h), "conv_tail": jnp.asarray(tail)},
        jnp.asarray(x), cfg.ssm)
    with torch.no_grad():
        y, h2, tail2 = blk.step(torch.from_numpy(x), torch.from_numpy(h),
                                torch.from_numpy(tail))
    close(y, want)
    close(h2, st["h"])
    close(tail2, st["conv_tail"])


# ---------------------------------------------------------------------------
# The decoders
# ---------------------------------------------------------------------------


def test_forward_matches_reference(pair):
    ref, model = pair
    toks = tokens(2, 21)
    got = model(as_long(toks))
    assert got.shape == (2, 21, ref.cfg.vocab_padded)
    close(got, ref.forward(toks))


@pytest.mark.parametrize("S", [2, 12])
def test_prefill_matches_reference(pair, S):
    """Every cache key, for a 2-token prompt (conv tail left-padded) and a
    12-token one."""
    ref, model = pair
    toks = tokens(3, S, seed=S)
    cache_j, logits_j = ref.prefill(toks)
    cache_t, logits_t = model.prefill(as_long(toks), MAX_LEN)
    close(logits_t, logits_j)
    assert set(cache_t) == set(cache_j)
    for key in cache_j:
        assert cache_t[key].shape == cache_j[key].shape, key
        assert str(cache_t[key].dtype).split(".")[-1] == \
            str(cache_j[key].dtype), key
        close(cache_t[key], cache_j[key])


def test_decode_steps_match_reference_and_freeze_inactive(pair):
    """Several decode steps under a changing active mask: logits and every
    cache key follow the reference, and a slot that is off keeps its
    ssm_h and conv_tail bit for bit."""
    ref, model = pair
    toks = tokens(3, 12, seed=2)        # compiled by the prefill test too
    cache_j, _ = ref.prefill(toks)
    cache_t, _ = model.prefill(as_long(toks), MAX_LEN)
    masks = [(True, False, True), (False, True, True), (True, True, True),
             (True, True, False)]
    for step, active in enumerate(masks):
        before = {k: cache_t[k].clone() for k in ("ssm_h", "conv_tail")}
        nxt = tokens(3, 1, seed=10 + step)[:, 0]
        cache_j, logits_j = ref.decode(cache_j, nxt, active)
        cache_t, logits_t = model.decode_step(cache_t, as_long(nxt),
                                              torch.tensor(active))
        close(logits_t, logits_j)
        for key in cache_j:
            close(cache_t[key], cache_j[key])
        assert cache_t["pos"].tolist() == np.asarray(cache_j["pos"]).tolist()
        for slot in range(3):
            if not active[slot]:
                for key, old in before.items():
                    assert torch.equal(cache_t[key][:, slot], old[:, slot])


@pytest.mark.parametrize("S", [2, 20])
def test_prefill_then_decode_matches_forward(pair, S):
    _, model = pair
    toks = tokens(2, S + 2, seed=6)
    full = model(as_long(toks))
    cache, _ = model.prefill(as_long(toks[:, :S]), MAX_LEN)
    for i in range(S, S + 2):
        cache, dec = model.decode_step(cache, as_long(toks[:, i]))
        close(dec[:, 0], full[:, i].numpy())


def test_plain_equals_kernel_path_on_cpu(pair):
    """attn_impl="kernel" sends attention and the SSD step to the
    kernels' plain versions on the CPU; it must equal the plain path."""
    ref, model = pair
    plain = params_from_jax(port_cfg(model.cfg.name, attn_impl="dense"),
                            jax.tree.map(np.asarray, ref.params),
                            device="cpu")
    toks = as_long(tokens(2, 19, seed=8))
    tight = dict(atol=1e-5, rtol=1e-5)
    close(plain(toks), model(toks).numpy(), **tight)
    cache_p, _ = plain.prefill(toks, MAX_LEN)
    cache_k, _ = model.prefill(toks, MAX_LEN)
    for key in cache_p:
        close(cache_p[key], cache_k[key].numpy(), **tight)


def test_bfloat16_forward_follows_reference():
    """In bfloat16 the port mirrors the reference's casts (y becomes
    float32 at ``+ x * D``; the step casts back before the gate norm), so
    the logits agree to bfloat16 rounding."""
    arch = "zamba2-1.2b"
    cfg = ref_configs.get_reduced(arch)
    params = jax.jit(partial(T.init_params, cfg))(jax.random.PRNGKey(4))
    model = params_from_jax(configs.get_reduced(arch),
                            jax.tree.map(np.asarray, params), device="cpu")
    toks = tokens(2, 9, seed=9)
    want, _, _ = jax.jit(lambda p, t: T.forward(cfg, p, {"tokens": t}))(
        params, toks)
    got = model(as_long(toks))
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    err = float(np.abs(got.float().numpy()
                       - np.asarray(want, np.float32)).max())
    assert err <= 0.05 * scale, (err, scale)


def test_seeded_init_follows_reference_distributions():
    cfg = configs.get_reduced("mamba2-1.3b")
    a = Transformer(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    b = Transformer(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    m = a.layers[0].mamba
    H = m.n_heads
    assert torch.equal(m.A_log, torch.log(torch.arange(1, H + 1).float()))
    assert torch.equal(m.D, torch.ones(H))
    assert torch.equal(m.conv_b, torch.zeros_like(m.conv_b))
    assert torch.equal(m.gate_norm.scale, torch.ones(m.d_inner))
    dt0 = torch.nn.functional.softplus(m.dt_bias)   # back to dt0
    s = cfg.ssm
    assert dt0.min() >= s.dt_min * 0.999 and dt0.max() <= s.dt_max * 1.001
    w = m.conv_w.float()                                 # N(0, 1/W)
    assert abs(w.std().item() * np.sqrt(s.conv_width) - 1.0) < 0.1
    for lin in (m.in_proj, m.out_proj):                  # fan-in trunc normal
        fan_in = lin.weight.shape[1]
        assert lin.weight.float().abs().max() <= 2.0 / np.sqrt(fan_in) + 1e-2
    assert m.A_log.dtype == m.dt_bias.dtype == m.D.dtype == torch.float32
    assert m.conv_w.dtype == m.in_proj.weight.dtype == torch.bfloat16
