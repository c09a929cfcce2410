"""The MoE family in the port: ``repro_torch.models.moe`` and the moe
models against the JAX package on the CPU.

The layer against ``repro.models.moe.moe`` (jitted) at each reduced
config's MoE shape and at qwen3-moe-30b-a3b's 128 experts, top-8: the
default capacity (drops happen), a tight and a dropless one, a decode
step (S = 1), float32 and bfloat16.  y to atol = rtol = 2e-5 in float32
and 2e-2 in bfloat16, the three aux values to 1e-6, and the routes (each
token's top-k set and its keep mask) exactly equal.  A route may differ
only where the router's margin (the k-th minus the (k+1)-th probability)
is below 1e-5, where the two packages' float32 matmuls can round either
way; such a token is reported with its position and its sequence is left
out of the comparison of y or the logits.  The reduced qwen3-moe and dbrx
(also with an int8 cache) carry the reference's own parameters over by
``params_from_jax``: forward logits and aux, prefill and decode steps
(atol 2e-4, rtol 2e-3, as tests/test_models.py).
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
from repro.models import moe as REF  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)
Y_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# a route may flip between the two packages only below this margin
TIE_MARGIN = 1e-5
MOE_ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b")
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

def as_jnp(a: np.ndarray, dtype: str):
    return jnp.asarray(a, jnp.dtype(dtype))


def as_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


def layer_params(rng, d: int, cfg: MoEConfig) -> dict:
    """float32 numpy weights at the reference's fan-in scales."""
    E, F = cfg.n_experts, cfg.d_ff_expert
    shapes = {"w_router": ((d, E), d), "w_gate": ((E, d, F), d),
              "w_up": ((E, d, F), d), "w_down": ((E, F, d), F)}
    return {k: (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
        np.float32) for k, (shape, fan_in) in shapes.items()}


def ref_route(w_router, x, cfg: MoEConfig, C: int):
    """The reference's routing (repro/models/moe.py, top-k to the drop
    mask) in JAX: (gate_idx, keep) as numpy."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x, jnp.float32),
                        jnp.asarray(w_router))
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    flat = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32).reshape(
        B, S * K, E)
    pos = jnp.einsum("bte,bte->bt", jnp.cumsum(flat, axis=1) - flat,
                     flat).reshape(B, S, K).astype(jnp.int32)
    return np.asarray(gate_idx), np.asarray(pos < C)


def route_sets(idx: np.ndarray, keep: np.ndarray):
    """Each token's experts as a sorted set, with their keep flags (the
    order within the top k changes no queue position)."""
    order = np.argsort(idx, axis=-1, kind="stable")
    return (np.take_along_axis(idx, order, -1),
            np.take_along_axis(keep, order, -1))


def flipped_rows(got: MOE.Route, want_idx, want_keep, what: str) -> set:
    """Sequences whose routes differ at a near tie (reported); fails on
    a difference at a margin above TIE_MARGIN."""
    gi, gk = route_sets(got.gate_idx.numpy(), got.keep.numpy())
    wi, wk = route_sets(np.asarray(want_idx), np.asarray(want_keep))
    diff = ((gi != wi) | (gk != wk)).any(-1)           # [B,S]
    margin = got.margin.numpy()
    rows = set()
    for b, s in zip(*np.nonzero(diff)):
        assert margin[b, s] < TIE_MARGIN, (
            f"{what}: route of token (b={b}, s={s}) differs at router "
            f"margin {margin[b, s]:.3g}: port {gi[b, s]} keep "
            f"{gk[b, s]}, reference {wi[b, s]} keep {wk[b, s]}")
        print(f"{what}: near-tie route flip at (b={b}, s={s}), margin "
              f"{margin[b, s]:.3g}")
        rows.add(int(b))
    return rows


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

SHAPES = {  # name -> (d, MoEConfig)
    "qwen3-moe-reduced": (64, configs.get_reduced(MOE_ARCHS[0]).moe),
    "dbrx-reduced": (64, configs.get_reduced(MOE_ARCHS[1]).moe),
    "qwen3-moe-E128": (32, dataclasses.replace(
        configs.get(MOE_ARCHS[0]).moe, d_ff_expert=16)),
}
# (label, B, S, capacity): None is the default rule; "dropless" is S * K
CAPACITIES = [("default", 2, 24, None), ("tight", 2, 24, 1),
              ("dropless", 2, 24, "dropless"), ("decode", 4, 1, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,B,S,capacity", CAPACITIES,
                         ids=[c[0] for c in CAPACITIES])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_moe_layer_matches_reference(shape, label, B, S, capacity, dtype):
    d, cfg = SHAPES[shape]
    rng = np.random.default_rng(len(shape) + S)
    if capacity == "dropless":
        capacity = S * cfg.top_k
    params = layer_params(rng, d, cfg)
    x = rng.standard_normal((B, S, d), np.float32)
    # the reference's params: router float32, experts in the dtype
    p_j = {k: (jnp.asarray(v) if k == "w_router" else as_jnp(v, dtype))
           for k, v in params.items()}
    p_t = {k: (torch.from_numpy(v) if k == "w_router" else as_torch(v, dtype))
           for k, v in params.items()}
    y_j, aux_j = jax.jit(partial(REF.moe, cfg=cfg, capacity=capacity))(
        p_j, as_jnp(x, dtype))
    y_t, aux_t = MOE.moe(p_t, as_torch(x, dtype), cfg, capacity)
    assert y_t.dtype == getattr(torch, dtype) and y_t.shape == (B, S, d)

    x_t = as_torch(x, dtype)
    got = MOE.route(p_t["w_router"], x_t, cfg, capacity)
    C = MOE.capacity_for(cfg, S) if capacity is None else capacity
    assert got.capacity == C
    want_idx, want_keep = ref_route(params["w_router"], np.asarray(
        as_jnp(x, dtype), np.float32), cfg, C)
    # the routing helper is the reference's: its drop share is the layer's
    assert float(aux_j["moe_drop_frac"]) == pytest.approx(
        1.0 - want_keep.mean(), abs=1e-7)
    rows = flipped_rows(got, want_idx, want_keep, f"{shape} {label}")
    if label == "default" and S > 1:
        assert float(aux_t["moe_drop_frac"]) > 0      # drops happen
    if label == "dropless":
        assert float(aux_t["moe_drop_frac"]) == 0.0
    keep_rows = [b for b in range(B) if b not in rows]
    tol = Y_TOL[dtype]
    np.testing.assert_allclose(
        y_t.float().numpy()[keep_rows],
        np.asarray(y_j, np.float32)[keep_rows], atol=tol, rtol=tol)
    if not rows:
        for key in ("moe_aux", "moe_z", "moe_drop_frac"):
            assert float(aux_t[key]) == pytest.approx(float(aux_j[key]),
                                                      abs=1e-6), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_equal_logits_pick_the_lowest_experts(dtype):
    """A row of zeros gives E equal probabilities: lax.top_k takes the
    lowest indices, and so must the port (torch.topk promises no order
    on ties)."""
    d, cfg = SHAPES["qwen3-moe-E128"]
    rng = np.random.default_rng(5)
    params = layer_params(rng, d, cfg)
    x = rng.standard_normal((2, 6, d), np.float32)
    x[0, 2] = 0.0
    x[1] = 0.0                                  # a whole sequence of ties
    p_t = {k: (torch.from_numpy(v) if k == "w_router" else as_torch(v, dtype))
           for k, v in params.items()}
    got = MOE.route(p_t["w_router"], as_torch(x, dtype), cfg)
    want_idx, want_keep = ref_route(params["w_router"], np.asarray(
        as_jnp(x, dtype), np.float32), cfg, got.capacity)
    ties = np.arange(cfg.top_k)
    for idx in (got.gate_idx.numpy(), want_idx):
        assert np.array_equal(idx[0, 2], ties)
        assert (idx[1] == ties).all()
    assert np.array_equal(got.keep[1].numpy(), want_keep[1])
    assert not flipped_rows(got, want_idx, want_keep, "ties")
    # the same experts every token: only the first C tokens keep them
    assert got.keep[1, :, 0].tolist() == [s < got.capacity for s in range(6)]
    p_j = {k: (jnp.asarray(v) if k == "w_router" else as_jnp(v, dtype))
           for k, v in params.items()}
    y_j, _ = jax.jit(partial(REF.moe, cfg=cfg))(p_j, as_jnp(x, dtype))
    y_t, _ = MOE.moe(p_t, as_torch(x, dtype), cfg)
    np.testing.assert_allclose(y_t.float().numpy(), np.asarray(
        y_j, np.float32), atol=Y_TOL[dtype], rtol=Y_TOL[dtype])


@pytest.mark.parametrize("S", [1, 7, 8, 24, 600])
def test_capacity_rule_matches_reference(S):
    for arch in MOE_ARCHS:
        for cfg in (configs.get(arch).moe, configs.get_reduced(arch).moe):
            want = max(1, int(cfg.capacity_factor * S * cfg.top_k
                              / cfg.n_experts))
            assert MOE.capacity_for(cfg, S) == want
    # qwen3-moe at the serving prompt length: int(1.25*8*8/128) = 0 -> 1
    assert MOE.capacity_for(configs.get(MOE_ARCHS[0]).moe, 8) == 1
    assert MOE.capacity_for(configs.get(MOE_ARCHS[1]).moe, 8) == 2


def test_router_stays_float32_and_init_is_fan_in():
    cfg = configs.get_reduced(MOE_ARCHS[0]).replace(
        d_model=128, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=256))
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    m = model.layers[0].moe
    assert m.w_router.dtype == torch.float32
    assert m.w_gate.dtype == m.w_up.dtype == m.w_down.dtype == torch.bfloat16
    assert tuple(m.w_gate.shape) == (8, 128, 256)
    assert tuple(m.w_down.shape) == (8, 256, 128)
    # truncated normal at +-2 sigma: std 0.8796 of the 1/sqrt(fan-in) scale
    for w, fan_in in ((m.w_router, 128), (m.w_gate, 128), (m.w_up, 128),
                      (m.w_down, 256)):
        w = w.float()
        std = w.std().item() * np.sqrt(fan_in)
        assert abs(std / 0.8796 - 1) < 0.05, (tuple(w.shape), std)
        assert w.abs().max().item() <= 2.0 / np.sqrt(fan_in) + 1e-2
    assert not hasattr(model.layers[0], "mlp")


# ---------------------------------------------------------------------------
# configs and models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_copies_match_reference(arch):
    assert arch in configs.ARCH_IDS
    for which in ("get", "get_reduced"):
        port = getattr(configs, which)(arch)
        ref = getattr(ref_configs, which)(arch)
        compared = [f.name for f in dataclasses.fields(port)
                    if f.name not in PORT_ONLY]
        diff = {n: (getattr(port, n), getattr(ref, n)) for n in compared
                if n != "moe" and getattr(port, n) != getattr(ref, n)}
        assert not diff, (which, diff)
        assert dataclasses.asdict(port.moe) == dataclasses.asdict(ref.moe)


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


def tokens(B, S, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def as_long(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.int64))


class RouteLog:
    """Every MoE layer's input, call by call (forward pre-hooks)."""

    def __init__(self, model: Transformer):
        self.calls = []
        self.model = model
        self.hooks = [blk.moe.register_forward_pre_hook(
            partial(self._log, i)) for i, blk in enumerate(model.layers)]

    def _log(self, layer, module, args):
        self.calls.append((layer, args[0].detach().clone()))

    def flipped_rows(self, params, what: str) -> set:
        """Hold each call's port route to the reference's routing of the
        same input with the reference's router weights."""
        rows = set()
        cfg = self.model.cfg.moe
        for layer, x in self.calls:
            w = self.model.layers[layer].moe.w_router
            with torch.no_grad():
                got = MOE.route(w, x, cfg)
            want = ref_route(np.asarray(params["layers"]["moe"]["w_router"]
                                        [layer]), x.float().numpy(), cfg,
                             got.capacity)
            rows |= flipped_rows(got, *want, f"{what} layer {layer}")
        self.calls.clear()
        return rows

    def remove(self):
        for h in self.hooks:
            h.remove()


def close_rows(got: torch.Tensor, want, rows: set, **tol):
    keep = [b for b in range(got.shape[0]) if b not in rows]
    np.testing.assert_allclose(got.float().numpy()[keep],
                               np.asarray(want, np.float32)[keep],
                               **(tol or TOL))


MODEL_CASES = [("qwen3-moe-30b-a3b", {}), ("dbrx-132b", {}),
               ("dbrx-132b", dict(kv_cache_dtype="int8"))]


@pytest.mark.parametrize("arch,kw", MODEL_CASES,
                         ids=["qwen3-moe", "dbrx", "dbrx-int8"])
def test_model_matches_reference(arch, kw):
    """forward logits and aux, prefill (logits, cache), and three decode
    steps with one slot inactive; routes held layer by layer.  With an
    int8 cache each decode step starts from the reference's cache (a
    key on a rounding tie is stored one step apart, as in
    tests/test_torch_dense_family.py)."""
    cfg_r, params, model = pair(arch, **kw)
    int8 = kw.get("kv_cache_dtype") == "int8"
    log = RouteLog(model)
    toks = tokens(2, 10, seed=1)
    want, aux_j, _ = T.forward(cfg_r, params, {"tokens": toks})
    got, aux_t = model(as_long(toks), return_aux=True)
    rows = log.flipped_rows(params, f"{arch} forward")
    close_rows(got, want, rows)
    if not rows:
        assert float(aux_t) == pytest.approx(float(aux_j), abs=1e-6)
    assert float(aux_t) > 0

    cache_j, logits_j = T.prefill(cfg_r, params, {"tokens": toks},
                                  max_len=16)
    cache_t, logits_t = model.prefill(as_long(toks), 16)
    rows = log.flipped_rows(params, f"{arch} prefill")
    close_rows(logits_t, logits_j, rows)
    for key in cache_j:
        assert tuple(cache_t[key].shape) == cache_j[key].shape, key
    for key in ("k", "v"):
        got_kv = cache_t[key].transpose(0, 1)
        want_kv = np.swapaxes(np.asarray(cache_j[key]), 0, 1)
        if int8:     # rounding ties of float keys: one step apart
            keep = [b for b in range(2) if b not in rows]
            diff = np.abs(got_kv.numpy()[keep].astype(np.int32)
                          - want_kv[keep])
            assert diff.max() <= 1 and diff.mean() < 1e-3, key
        else:
            close_rows(got_kv, want_kv, rows)
    active = (True, False)
    for step in range(3):
        if int8:
            cache_t = {k: torch.from_numpy(np.array(v))
                       for k, v in cache_j.items()}
        nxt = tokens(2, 1, seed=10 + step)[:, 0]
        cache_j, logits_j = T.decode_step(cfg_r, params, cache_j,
                                          jnp.asarray(nxt),
                                          active=jnp.asarray(active))
        cache_t, logits_t = model.decode_step(cache_t, as_long(nxt),
                                              active=torch.tensor(active))
        rows |= log.flipped_rows(params, f"{arch} decode {step}")
        close_rows(logits_t, logits_j, rows)
        assert cache_t["pos"].tolist() == np.asarray(cache_j["pos"]).tolist()
    assert cache_t["pos"].tolist() == [13, 10]
    log.remove()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dropless_prefill_then_decode_matches_forward(arch):
    """tests/test_models.py's check on the port: with a dropless capacity
    factor, a prefill of 24 tokens and one decode step give the full
    forward's last logits."""
    base = configs.get_reduced(arch)
    m = base.moe
    cfg = base.replace(dtype="float32", vocab=512, moe=dataclasses.replace(
        m, capacity_factor=float(m.n_experts) / m.top_k))
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    toks = as_long(tokens(2, 25, seed=6))
    full = model(toks)
    cache, _ = model.prefill(toks[:, :24], 32)
    _, dec = model.decode_step(cache, toks[:, 24])
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               **TOL)


def test_dense_equals_kernel_on_cpu():
    """attn_impl="kernel" takes the kernels' plain versions on the CPU,
    and the MoE layer is the same code either way."""
    cfg_r, params, model = pair("qwen3-moe-30b-a3b")
    dense = params_from_jax(model.cfg.replace(attn_impl="dense"),
                            jax.tree.map(np.asarray, params), device="cpu")
    toks = as_long(tokens(2, 9, seed=8))
    tight = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dense(toks).numpy(), model(toks).numpy(),
                               **tight)
    cache_k, _ = model.prefill(toks, 12)
    cache_d, _ = dense.prefill(toks, 12)
    _, lk = model.decode_step(cache_k, toks[:, 0])
    _, ld = dense.decode_step(cache_d, toks[:, 0])
    np.testing.assert_allclose(lk.numpy(), ld.numpy(), **tight)


def test_serve_summary_matches_reference():
    """serve.main on reduced qwen3-moe: the reference launcher's schedule
    summary, every request complete."""
    args = ["--arch", "qwen3-moe-30b-a3b", "--requests", "6", "--slots",
            "4", "--max-len", "160", "--policy", "sfs"]
    want = ref_serve.main(args)
    got = serve.main(args + ["--device", "cpu"])
    assert {k: got[k] for k in want} == want
    assert got["incomplete"] == 0 and got["prefills"] == 6
    assert got["decode_steps"] > 0
