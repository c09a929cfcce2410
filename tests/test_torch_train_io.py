"""The port's training substrate on the CPU: int8 compression, checkpoints
(each package restores the other's), synthetic data, the launcher, the
step watchdog, the kernels' autograd guard, and counterparts of
``tests/test_train.py``'s ten tests.

* ``quantize`` and ``roundtrip`` equal the reference's bit for bit on
  seeded inputs, and ``apply_error_feedback`` over a reduced model's
  leaves equals the reference's over its parameter tree, gradients and
  residuals, bit for bit, twice in a row.  The roundtrip error is at most
  half a quantization step plus float32 rounding: ``block max / 254 *
  (1 + 2^-20)``.
* Checkpoints: the port's save and restore round-trip exactly, a resumed
  run equals a continuous one exactly, the reference's ``restore`` reads
  the port's checkpoint and the port reads the reference's, leaf for
  leaf and bit for bit (bfloat16 params, AdamW and Adafactor, with and
  without error feedback).
* Counterparts of the reference's tests, on the port's own data: the
  loss falls by more than 0.3 in 25 steps (also with int8 compression),
  the accumulation modes agree with one microbatch (loss to rel 1e-2,
  params within 5e-2), Adafactor's state is under 0.25x the params.
"""
import json
import os
import tempfile
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import compression as ref_comp  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro.train.data import DataConfig as RefDataConfig  # noqa: E402
from repro.train.data import make_batch as ref_make_batch  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.kernels.group_pick.kernel import pick_order_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import (  # noqa: E402
    ssd_intra_chunk_cuda)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.convert import (flat_train_state,  # noqa: E402
                                        state_dict_from_jax,
                                        train_state_from_jax)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.data import (DataConfig, DataIterator,  # noqa: E402
                                    make_batch)
from repro_torch.train.elastic import StepWatchdog  # noqa: E402
from repro_torch.train.step import (init_train_state,  # noqa: E402
                                    make_train_step)


@pytest.fixture(autouse=True, scope="module")
def few_intra_op_threads():
    """Reduced models are many small tensor ops; beside the reference's
    thread pool and other test workers, more threads only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_setup(arch="qwen2.5-3b", **cfg_kw):
    """The port's counterpart of tests/test_train.py's ``small_setup``
    (the reduced config in its own dtype, bfloat16)."""
    cfg = configs.get_reduced(arch).replace(**cfg_kw)
    o = opt.adamw(lr=1e-3, warmup_steps=5)
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(cfg, o, device="cpu", generator=gen)
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=3)
    return cfg, o, state, dc


def host_leaves(state) -> dict:
    """name -> numpy copy (bfloat16 as uint16 bits) of a port state."""
    out = {}
    for name, t in flat_train_state(state):
        t = t.detach().cpu()
        out[name] = (t.view(torch.int16).numpy().view(np.uint16)
                     if t.dtype == torch.bfloat16 else t.numpy().copy())
    return out


def ref_leaves(tree) -> dict:
    """name -> numpy (bfloat16 as uint16 bits) of a reference tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        out[".".join(str(k.key) for k in path)] = a
    return out


def assert_same_leaves(got: dict, want: dict):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

QUANT_CASES = [((777,), 1.0), ((3, 300), 1e-4), ((256,), 10.0),
               ((2, 5, 64), 0.3), ((1,), 2.0), ((1000,), 0.0)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape,scale", QUANT_CASES)
def test_quantize_bit_exact_with_reference(shape, scale, seed):
    x = (np.random.default_rng(seed).standard_normal(shape)
         .astype(np.float32) * np.float32(scale))
    q_r, s_r = ref_comp.quantize(jnp.asarray(x))
    q_p, s_p = comp.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r))
    np.testing.assert_array_equal(comp.roundtrip(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref_comp.roundtrip(
                                      jnp.asarray(x))))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("scale", [1e-4, 1e-2, 1.0, 10.0])
def test_quantize_roundtrip_error_bound(seed, scale):
    """Half a quantization step per element, plus float32 rounding of the
    division and the product (relative slack 2^-20)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(777)
                         .astype(np.float32) * np.float32(scale))
    rt = comp.roundtrip(x)
    pad = (-len(x)) % comp.BLOCK
    blocks = torch.nn.functional.pad(x, (0, pad)).reshape(-1, comp.BLOCK)
    bmax = blocks.abs().amax(dim=1).double()
    err = torch.nn.functional.pad((rt - x).abs(), (0, pad)).reshape(
        -1, comp.BLOCK).double()
    assert bool(torch.all(err <= bmax[:, None] / 254.0 * (1 + 2 ** -20)))


def test_error_feedback_matches_reference():
    """Two compressed steps over the reference's leaves: gradients and
    residuals bit for bit."""
    arch = "qwen2.5-3b"
    cfg_r = ref_configs.get_reduced(arch).replace(dtype="float32")
    cfg_p = configs.get_reduced(arch).replace(dtype="float32")
    state = init_train_state(cfg_p, opt.adamw(), device="cpu")
    params = {n: p for n, p in state["model"].named_parameters()}
    st_r = {}
    rng = np.random.default_rng(5)
    shapes = jax.eval_shape(partial(ref_step.init_train_state, cfg_r,
                                    ref_opt.adamw()),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    for _ in range(2):
        g_np = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
            np.float32) * 1e-2, shapes["params"])
        got, state = comp.apply_error_feedback(
            state_dict_from_jax(cfg_p, g_np), state)
        want, st_r = ref_comp.apply_error_feedback(
            jax.tree.map(jnp.asarray, g_np), st_r)
        want_by_name = state_dict_from_jax(cfg_p, jax.tree.map(np.asarray,
                                                               want))
        assert set(got) == set(params)
        for name in params:
            assert got[name].dtype == torch.float32
            np.testing.assert_array_equal(got[name].numpy(),
                                          want_by_name[name].numpy(), name)
        for key, e in ref_leaves(st_r["ef"]).items():
            np.testing.assert_array_equal(state["ef"][key].numpy(), e, key)


def test_error_feedback_carries_residual():
    cfg, o, state, _ = small_setup(dtype="float32")
    g = {n: torch.full(p.shape, 0.001)
         for n, p in state["model"].named_parameters()}
    got, state = comp.apply_error_feedback(g, state)
    assert "ef" in state
    total1 = sum(float(t.sum()) for t in got.values())
    got2, state = comp.apply_error_feedback(g, state)
    total2 = sum(float(t.sum()) for t in got2.values())
    assert total2 >= total1 - 1e-9


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_resume():
    cfg, o, state, dc = small_setup()
    step = make_train_step(cfg, o)
    it = DataIterator(dc)
    for _ in range(4):
        state, _ = step(state, next(it))
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(state, d, 4, extra=it.state_dict())
        assert ckpt.latest_step(d) == 4
        _, _, fresh, _ = small_setup()
        restored, extra = ckpt.restore(d, 4, fresh)
        assert_same_leaves(host_leaves(restored), host_leaves(state))
        # resumed run == continuous run (exact)
        it2 = DataIterator(dc)
        it2.load_state_dict(extra)
        s_cont, m_cont = step(state, next(it))
        s_res, m_res = step(restored, next(it2))
        assert_same_leaves(host_leaves(s_res), host_leaves(s_cont))
        assert float(m_res["loss"]) == float(m_cont["loss"])


def test_checkpoint_layout_is_the_references():
    _, _, state, _ = small_setup()
    with tempfile.TemporaryDirectory() as d:
        path = ckpt.save(state, d, 7, extra={"step": 7, "seed": 3})
        assert os.path.basename(path) == "step_00000007"
        assert not os.path.exists(path + ".tmp")
        with open(os.path.join(path, "manifest.json")) as f:
            man = json.load(f)
        assert man["step"] == 7 and man["extra"] == {"step": 7, "seed": 3}
        by_name = {leaf["name"]: leaf for leaf in man["leaves"]}
        emb = by_name["params.embed"]
        V, dm = state["model"].embed.weight.shape
        assert emb["dtype"] == "bfloat16" and emb["shape"] == [V, 2 * dm]
        assert np.load(os.path.join(path, "params.embed.npy")).dtype == \
            np.uint8
        assert by_name["opt.count"] == {"name": "opt.count", "shape": [],
                                        "dtype": "int32"}
        assert by_name["params.layers.attn.wq"]["shape"][0] == \
            state["model"].cfg.n_layers


CROSS_CASES = [("qwen2.5-3b", "adamw", None),
               ("qwen2.5-3b", "adamw", "int8_pod"),
               ("llama3-405b", "adafactor", None)]


@pytest.mark.parametrize("arch,name,gc", CROSS_CASES)
def test_each_package_restores_the_others_checkpoint(arch, name, gc):
    """bfloat16 params; the reference's state after one step (so the
    optimizer state and ``ef`` are not zero)."""
    cfg_r = ref_configs.get_reduced(arch)
    cfg_p = configs.get_reduced(arch)
    o_r = ref_opt.get_optimizer(name, lr=1e-3, warmup_steps=5)
    o_p = opt.get_optimizer(name, lr=1e-3, warmup_steps=5)
    st_r = jax.jit(partial(ref_step.init_train_state, cfg_r, o_r))(
        jax.random.PRNGKey(0))
    batch = ref_make_batch(RefDataConfig(vocab=cfg_r.vocab, seq_len=16,
                                         global_batch=2, seed=1),
                           jnp.int32(0))
    st_r, _ = jax.jit(ref_step.make_train_step(cfg_r, o_r, gc))(st_r, batch)
    want = ref_leaves(st_r)

    def port_target():
        state = init_train_state(cfg_p, o_p, device="cpu")
        if gc:
            state["ef"] = comp.init_error_feedback(state["model"])
        return state

    with tempfile.TemporaryDirectory() as d:
        # reference -> port
        ref_ckpt.save(st_r, d, 1, extra={"step": 1, "seed": 1})
        state, extra = ckpt.restore(d, 1, port_target())
        assert extra == {"step": 1, "seed": 1}
        assert_same_leaves(host_leaves(state), want)
        # port -> reference
        ckpt.save(state, d, 2)
        tgt = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                           st_r)
        back, _ = ref_ckpt.restore(d, 2, tgt)
        assert_same_leaves(ref_leaves(back), want)
    # and the in-memory conversion agrees with the files
    state = train_state_from_jax(port_target(),
                                 jax.tree.map(np.asarray, st_r))
    assert_same_leaves(host_leaves(state), want)


def test_restore_rejects_a_mismatched_state():
    _, _, state, _ = small_setup()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(state, d, 1)
        _, _, other, _ = small_setup("llama3-405b")
        with pytest.raises((KeyError, ValueError)):
            ckpt.restore(d, 1, other)


def test_async_saver():
    _, _, state, _ = small_setup()
    with tempfile.TemporaryDirectory() as d:
        saver = ckpt.AsyncSaver()
        saver.save(state, d, 1)
        saver.save(state, d, 2)         # waits for the first
        saver.wait()
        assert ckpt.latest_step(d) == 2
        assert saver.last_path == os.path.join(d, "step_00000002")
        assert sorted(os.listdir(d)) == ["step_00000001", "step_00000002"]
    assert ckpt.latest_step(os.path.join(d, "gone")) is None


# ---------------------------------------------------------------------------
# training (counterparts of tests/test_train.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gc", [None, "int8_pod"])
def test_loss_decreases(gc):
    cfg, o, state, dc = small_setup()
    step = make_train_step(cfg, o, grad_compression=gc)
    it = DataIterator(dc)
    first = None
    for _ in range(25):
        state, m = step(state, next(it))
        first = first if first is not None else float(m["loss"])
    assert float(m["loss"]) < first - 0.3
    assert ("ef" in state) == (gc is not None)


@pytest.mark.parametrize("mode,accum_dtype", [("scan", "float32"),
                                              ("fused", "float32"),
                                              ("unroll", "float32"),
                                              ("scan", "bfloat16")])
def test_grad_accum_modes_agree(mode, accum_dtype):
    cfg, o, state, dc = small_setup(microbatch=2)
    ref_step_fn = make_train_step(cfg.replace(microbatch=1), o)
    mode_step = make_train_step(cfg.replace(grad_accum=mode,
                                            grad_accum_dtype=accum_dtype), o)
    batch = make_batch(dc, 0)
    _, _, s2, _ = small_setup(microbatch=2)
    s1, m1 = ref_step_fn(state, batch)
    s2, m2 = mode_step(s2, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-2)
    d = max(float((a.detach().float() - b.detach().float()).abs().max())
            for a, b in zip(s1["model"].parameters(),
                            s2["model"].parameters()))
    assert d < 5e-2


def test_fused_runs_microbatches_last_to_first(monkeypatch):
    """JAX's backward scan adds the microbatches' gradients last to
    first; the fused mode's backward passes run in that order."""
    cfg, o, state, dc = small_setup(microbatch=4, grad_accum="fused")
    from repro_torch.train import step as step_mod
    seen = []
    real = step_mod.loss_fn

    def spy(model, mb):
        seen.append(int(mb["tokens"][0, 0]))
        return real(model, mb)
    monkeypatch.setattr(step_mod, "loss_fn", spy)
    batch = make_batch(dc, 0)
    make_train_step(cfg, o)(state, batch)
    assert seen == [int(batch["tokens"][i, 0]) for i in (3, 2, 1, 0)]


def test_adafactor_state_is_small_and_trains():
    cfg = configs.get_reduced("llama3-405b")
    o = opt.adafactor(lr=1e-3)
    state = init_train_state(cfg, o, device="cpu")
    par = sum(p.numel() * p.element_size()
              for p in state["model"].parameters())
    ost = sum(t.numel() * t.element_size()
              for f in state["opt"]["f"].values() for t in f.values())
    assert ost < 0.25 * par          # factored: far below AdamW's 4x
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=1)
    step = make_train_step(cfg, o)
    it = DataIterator(dc)
    for _ in range(3):
        state, m = step(state, next(it))
    assert np.isfinite(float(m["loss"]))


def test_train_step_refuses_the_kernel_path():
    cfg, o, state, dc = small_setup()
    state["model"].set_attn_impl("kernel")
    with pytest.raises(ValueError, match="dense"):
        make_train_step(cfg, o)(state, make_batch(dc, 0))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_data_determinism_and_shift():
    dc = DataConfig(vocab=100, seq_len=16, global_batch=2, seed=9)
    b1, b2 = make_batch(dc, 5), make_batch(dc, 5)
    np.testing.assert_array_equal(b1["tokens"].numpy(), b2["tokens"].numpy())
    assert not np.array_equal(b1["tokens"].numpy(),
                              make_batch(dc, 6)["tokens"].numpy())
    assert not np.array_equal(
        b1["tokens"].numpy(),
        make_batch(DataConfig(100, 16, 2, seed=10), 5)["tokens"].numpy())
    b = make_batch(dc, 0)
    assert b["labels"].shape == b["tokens"].shape
    assert b["tokens"].dtype == torch.int64
    # labels are next-token shifted
    np.testing.assert_array_equal(b["labels"][:, :-1].numpy(),
                                  b["tokens"][:, 1:].numpy())


def test_data_distribution():
    """u^4-warped Zipf marginal, and the Markov rule at even positions."""
    V = 1000
    b = make_batch(DataConfig(vocab=V, seq_len=64, global_batch=64, seed=2),
                   0)
    full = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1).numpy()
    assert full.min() >= 0 and full.max() < V
    odd = full[:, 1::2]
    # E[floor(u^4 V)] ~ V/5; a uniform draw would give V/2
    assert 0.15 * V < odd.mean() < 0.25 * V
    np.testing.assert_array_equal(full[:, 2::2],
                                  (full[:, 1:-1:2] * 31 + 7) % (V // 2))


def test_vlm_and_audio_batches():
    vd = DataConfig(vocab=64, seq_len=16, global_batch=2, seed=1,
                    kind="vlm", d_model=8, n_prefix=4)
    b = make_batch(vd, 0)
    assert b["vision_embeds"].shape == (2, 4, 8)
    assert b["vision_embeds"].dtype == torch.bfloat16
    assert bool((b["labels"][:, :4] == -1).all())
    assert bool((b["labels"][:, 4:] >= 0).all())
    ad = DataConfig(vocab=64, seq_len=16, global_batch=2, seed=1,
                    kind="audio", d_model=8)
    b = make_batch(ad, 0)
    assert b["frames"].shape == (2, 16, 8)
    assert b["frames"].dtype == torch.bfloat16
    assert b["labels"].shape == (2, 16)
    assert 0.005 < float(b["frames"].float().std()) < 0.04


def test_data_iterator_resumes():
    dc = DataConfig(vocab=100, seq_len=8, global_batch=2, seed=4)
    it = DataIterator(dc)
    next(it), next(it)
    st = it.state_dict()
    want = next(it)
    it2 = DataIterator(dc)
    it2.load_state_dict(st)
    np.testing.assert_array_equal(next(it2)["tokens"].numpy(),
                                  want["tokens"].numpy())
    with pytest.raises(ValueError, match="seed"):
        DataIterator(DataConfig(100, 8, 2, seed=5)).load_state_dict(st)


# ---------------------------------------------------------------------------
# the launcher, the watchdog and the kernels' guard
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "qwen2.5-3b", "--batch", "4", "--seq", "16",
          "--log-every", "2", "--device", "cpu"]


def test_launcher_trains_checkpoints_and_resumes(capsys):
    with tempfile.TemporaryDirectory() as d:
        _, cont = launch_train.main(LAUNCH + ["--steps", "6"])
        _, log = launch_train.main(LAUNCH + ["--steps", "4", "--ckpt-dir", d,
                                             "--ckpt-every", "2"])
        assert ckpt.latest_step(d) == 4
        assert [r["step"] for r in log] == [1, 2, 3, 4]
        state, res = launch_train.main(LAUNCH + ["--steps", "6", "--resume",
                                                 "--ckpt-dir", d,
                                                 "--ckpt-every", "100"])
        assert ckpt.latest_step(d) == 4
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "|g|" in out
    assert [r["step"] for r in res] == [5, 6]
    assert state["step"] == 6
    # the resumed steps equal the continuous run's on the CPU
    for a, b in zip(res, cont[4:]):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])


def test_launcher_resets_an_indivisible_microbatch():
    state, log = launch_train.main(["--arch", "mamba2-1.3b", "--batch", "3",
                                    "--seq", "8", "--steps", "1",
                                    "--device", "cpu"])
    assert state["model"].cfg.family == "ssm" and len(log) == 1


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--steps", "1"])


def test_watchdog_fires_on_a_slow_step():
    fired = []
    wd = StepWatchdog(timeout_s=0.05,
                      on_timeout=lambda s, dt: fired.append((s, dt)))
    with wd.step(3):
        import time
        time.sleep(0.3)
    with wd.step(4):
        pass
    assert wd.timeouts == [3] and fired[0][0] == 3 and fired[0][1] >= 0.05


def _guard_cases():
    g = dict(requires_grad=True)
    x = torch.zeros(1, 2, 1, 1, 16, **g)
    return {
        "flash_attention": lambda: flash_attention_cuda(
            torch.zeros(1, 2, 2, 16, **g), torch.zeros(3), torch.zeros(3)),
        "decode_attention": lambda: decode_attention_cuda(
            torch.zeros(1, 2, 16), torch.zeros(1, 4, 1, 16, **g),
            torch.zeros(1, 4, 1, 16), torch.zeros(1, dtype=torch.int32)),
        "ssd_scan": lambda: ssd_intra_chunk_cuda(
            x, torch.zeros(2), torch.zeros(2), torch.zeros(2), x, x),
        "group_pick": lambda: pick_order_cuda(
            torch.zeros(2, 4, **g), torch.zeros(2, 4, dtype=torch.int32), 1),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssd_scan", "group_pick"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    """The guard runs first: CPU tensors of the wrong shapes still raise
    the grad error; without grad the next check fires instead."""
    call = _guard_cases()[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad():
        with pytest.raises((ValueError, TypeError)) as err:
            call()
    assert "requires grad" not in str(err.value)
