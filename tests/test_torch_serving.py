"""The port's serving engine against repro.serving.Engine on the CPU.

Synthetic mode must reproduce the reference's schedule tick for tick;
model mode (reduced qwen2.5-3b, mamba2-1.3b and zamba2-1.2b, float32, the
reference's weights) must also produce the same greedy token stream.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import Engine, EngineConfig, Request  # noqa: E402

POLICIES = ["sfs", "cfs", "fifo", "srtf"]


def workload(request_cls, n=60, lanes=4, seed=0, prompt_lens=(4,)):
    """Short-dominant mix with some stalls, as in tests/test_serving.py."""
    rng = np.random.default_rng(seed)
    svc = np.where(rng.random(n) < 0.8, rng.integers(2, 8, n),
                   rng.integers(30, 80, n))
    iats = rng.exponential(1.0, n)
    arr = np.cumsum(iats * svc.sum() / lanes / iats.sum()).astype(int)
    out = []
    for i in range(n):
        ev = ((1, int(rng.integers(2, 8))),) if rng.random() < 0.3 \
            and svc[i] > 3 else ()
        out.append(request_cls(rid=i, arrival=int(arr[i]),
                               prompt_len=int(prompt_lens[i % len(
                                   prompt_lens)]),
                               n_tokens=int(svc[i]), stall_events=ev))
    return out


def schedule(done):
    return [(r.rid, r.first_start, r.finish, r.served_ticks, r.n_ctx,
             r.demoted, r.queue_delay) for r in done]


@pytest.mark.parametrize("policy", POLICIES)
def test_synthetic_schedule_matches_reference(policy):
    ref = RefEngine(RefEngineConfig(lanes=4, n_slots=24, policy=policy))
    port = Engine(EngineConfig(lanes=4, n_slots=24, policy=policy),
                  device="cpu")
    done_r = ref.run(workload(RefRequest))
    done_p = port.run(workload(Request))
    assert port.tick_log == ref.tick_log
    assert schedule(done_p) == schedule(done_r)
    assert port.lane_busy_ticks == ref.lane_busy_ticks


def record_tokens(engine, log):
    """Wrap this instance's ``_run_decode`` to log each tick's tokens."""
    run = engine._run_decode

    def wrapped(reqs):
        out = run(reqs)
        log.append((engine.t, sorted(out.items())))
        return out
    engine._run_decode = wrapped


def model_mode_matches_reference(arch, policy, lens):
    """Run the port's and the reference's engines in model mode on the
    same workload and weights: equal schedules and greedy tokens."""
    cfg_r = ref_configs.get_reduced(arch).replace(dtype="float32")
    cfg_p = configs.get_reduced(arch).replace(dtype="float32")
    params = jax.jit(partial(T.init_params, cfg_r))(jax.random.PRNGKey(0))
    model = params_from_jax(cfg_p, jax.tree.map(np.asarray, params),
                            device="cpu")
    rng = np.random.default_rng(1)
    wl_r = workload(RefRequest, n=8, lanes=2, seed=2, prompt_lens=lens)
    for r in wl_r:
        r.n_tokens = min(r.n_tokens, 12)
    prompts = {r.rid: rng.integers(0, cfg_r.vocab, r.prompt_len)
               for r in wl_r}
    wl_p = [Request(rid=r.rid, arrival=r.arrival, prompt_len=r.prompt_len,
                    n_tokens=r.n_tokens, stall_events=r.stall_events)
            for r in wl_r]
    ecfg = dict(lanes=2, n_slots=4, max_len=32, policy=policy)
    ref = RefEngine(RefEngineConfig(**ecfg), model_cfg=cfg_r, params=params)
    port = Engine(EngineConfig(**ecfg), model, device="cpu")
    toks_r, toks_p = [], []
    record_tokens(ref, toks_r)
    record_tokens(port, toks_p)
    done_r = ref.run(wl_r, prompts=prompts)
    done_p = port.run(wl_p, prompts=prompts)
    assert schedule(done_p) == schedule(done_r)
    assert sum(len(t) for _, t in toks_p) == sum(r.n_tokens for r in wl_p)
    assert toks_p == toks_r
    assert port.n_prefills == len(wl_p)


@pytest.mark.parametrize("policy", ["sfs", "cfs"])
def test_model_mode_tokens_match_reference(policy):
    model_mode_matches_reference("qwen2.5-3b", policy, lens=(3, 6))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_model_mode_ssm_hybrid_tokens_match_reference(arch):
    """The recurrent state and conv tail travel through the slot copy
    and the frozen-slot decode like the reference's, down to the greedy
    tokens; a 2-token prompt is shorter than the conv tail."""
    model_mode_matches_reference(arch, "sfs", lens=(2, 6))


def test_one_device_to_host_copy_per_tick(monkeypatch):
    """Model mode moves each tick's token ids to the host in one copy."""
    cfg = configs.get_reduced("qwen2.5-3b").replace(dtype="float32")
    from repro_torch.models.transformer import Transformer
    model = Transformer(cfg, device="cpu")
    eng = Engine(EngineConfig(lanes=2, n_slots=4, max_len=32), model,
                 device="cpu")
    copies = []
    tolist = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda self: copies.append(eng.t) or tolist(self))
    wl = [Request(rid=i, arrival=i, prompt_len=4, n_tokens=3 + i)
          for i in range(4)]
    eng.run(wl)
    worked = [t for t, n_active, _ in eng.tick_log if n_active]
    assert copies == worked


def test_serve_main_runs_on_cpu():
    s = serve.main(["--device", "cpu", "--requests", "6", "--policy",
                    "sfs", "--slots", "4", "--max-len", "160"])
    assert s["n"] == 6 and s["incomplete"] == 0
    assert s["prefills"] == 6 and s["decode_steps"] > 0


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_serve_main_runs_ssm_and_hybrid_on_cpu(arch):
    s = serve.main(["--arch", arch, "--device", "cpu", "--requests", "4",
                    "--policy", "sfs", "--slots", "4", "--max-len", "160"])
    assert s["n"] == 4 and s["incomplete"] == 0
    assert s["prefills"] == 4 and s["decode_steps"] > 0


def test_serve_replicas_runs():
    """``--replicas 2`` runs through the ported router (the name is kept
    from when the path raised): the workload is spread over both
    replicas and every request completes."""
    s = serve.main(["--device", "cpu", "--replicas", "2", "--synthetic"])
    assert s["n"] == 80 and s["incomplete"] == 0
    assert sum(s["dispatch_counts"]) == 80
    assert min(s["dispatch_counts"]) > 0
