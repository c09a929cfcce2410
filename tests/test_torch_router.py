"""Multi-replica serving: the port's ``Router`` and ``serve --replicas``
against the JAX package's on the CPU.

Two reduced engines over one model (the reference's parameters, through
``params_from_jax``) must feed the same tokens, engine by engine and
tick by tick, and produce the same schedule as the reference's router
over reference engines; each engine keeps its one device-to-host copy per
tick; a failed engine is drained and its requests re-run elsewhere, as in
the reference; and ``serve.main(["--replicas", "2", ...])`` reports the
reference launcher's summary.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.serving import Cluster as RefCluster  # noqa: E402
from repro.serving import ClusterConfig as RefClusterConfig  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import Router as RefRouter  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serving import (Cluster, ClusterConfig, Engine,  # noqa: E402
                                 EngineConfig, Request, Router)


def workload(request_cls, n=10, seed=2):
    """Short-dominant stream over two replicas of 2 lanes, with stalls."""
    rng = np.random.default_rng(seed)
    svc = np.where(rng.random(n) < 0.8, rng.integers(2, 8, n),
                   rng.integers(9, 13, n))
    arr = np.cumsum(rng.exponential(svc.mean() / 4, n)).astype(int)
    return [request_cls(rid=i, arrival=int(arr[i]),
                        prompt_len=int((3, 6)[i % 2]), n_tokens=int(svc[i]),
                        stall_events=((1, 2),) if i % 3 == 0 else ())
            for i in range(n)]


def schedule(done):
    return [(r.rid, r.first_start, r.finish, r.served_ticks, r.n_ctx,
             r.demoted, r.queue_delay) for r in done]


def record_tokens(engine, log):
    """Log this engine's decode tokens and its pending next tokens after
    every tick."""
    tick = engine.tick

    def wrapped(arrivals=()):
        t = engine.t
        tick(arrivals)
        log.append((t, sorted(engine.next_token.items()),
                    engine.lane_busy_ticks))
    engine.tick = wrapped


def models(arch):
    cfg_r = ref_configs.get_reduced(arch).replace(dtype="float32")
    cfg_p = configs.get_reduced(arch).replace(dtype="float32")
    params = jax.jit(partial(T.init_params, cfg_r))(jax.random.PRNGKey(0))
    model = params_from_jax(cfg_p, jax.tree.map(np.asarray, params),
                            device="cpu")
    return cfg_r, params, model


def replicas(arch, make, cfg=None, n_engines=2):
    """(reference done, port done, reference logs, port logs, port
    router or cluster) of ``make(engines, cfg)`` over ``n_engines``
    engines of each package that share one model."""
    cfg_r, params, model = models(arch)
    ecfg = dict(lanes=2, n_slots=3, max_len=32, policy="sfs")
    ref = [RefEngine(RefEngineConfig(**ecfg), model_cfg=cfg_r,
                     params=params) for _ in range(n_engines)]
    port = [Engine(EngineConfig(**ecfg), model, device="cpu")
            for _ in range(n_engines)]
    logs_r = [[] for _ in ref]
    logs_p = [[] for _ in port]
    for e, log in zip(ref + port, logs_r + logs_p):
        record_tokens(e, log)
    rng = np.random.default_rng(1)
    wl_r = workload(RefRequest)
    prompts = {r.rid: rng.integers(0, cfg_r.vocab, r.prompt_len)
               for r in wl_r}
    wl_p = workload(Request)
    for r, p in zip(wl_r, wl_p):
        r._prompt = p._prompt = prompts[r.rid]
    done_r = make[0](ref, cfg).run(wl_r)
    front = make[1](port, cfg)
    done_p = front.run(wl_p)
    return done_r, done_p, logs_r, logs_p, front


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-1.2b"])
def test_router_tokens_match_reference(arch):
    done_r, done_p, logs_r, logs_p, router = replicas(
        arch, (lambda e, _: RefRouter(e), lambda e, _: Router(e)))
    assert schedule(done_p) == schedule(done_r)
    assert logs_p == logs_r
    assert all(any(toks for _, toks, _ in log) for log in logs_p)
    assert sum(e.n_prefills for e in router.engines) == len(done_p)
    assert all(e.n_prefills > 0 for e in router.engines)


def test_failed_model_engine_is_drained_as_in_reference():
    """Engine 1 fails mid-run: its requests are evicted (slot pool and
    scheduler reset, cache tensors left as they are) and re-run on the
    survivor, whose next prefill of a slot overwrites it — same tokens
    and schedule as the reference."""
    cfg = dict(policy="least-outstanding",
               lifecycle="lifecycle:fail=12,fail_server=1")
    done_r, done_p, logs_r, logs_p, cluster = replicas(
        "qwen2.5-3b", (lambda e, c: RefCluster(e, RefClusterConfig(**c)),
                       lambda e, c: Cluster(e, ClusterConfig(**c))), cfg)
    assert schedule(done_p) == schedule(done_r)
    assert logs_p == logs_r
    failed = cluster.engines[1]
    assert not failed.by_slot and not failed.pending_slot
    assert failed.n_prefills > 0           # it had work before it failed
    assert sum(cluster.dispatch_counts) > len(done_p) == 10   # requeued


def test_one_device_to_host_copy_per_engine_tick(monkeypatch):
    """A cluster tick ticks each engine in turn; every engine that worked
    in a tick copies its token ids to the host once, as alone."""
    cfg = configs.get_reduced("qwen2.5-3b").replace(dtype="float32")
    model = Transformer(cfg, device="cpu")
    engines = [Engine(EngineConfig(lanes=2, n_slots=4, max_len=32), model,
                      device="cpu") for _ in range(2)]
    ticking, copies = [], []
    for i, e in enumerate(engines):
        def tick(arrivals=(), i=i, e=e, plain=e.tick):
            ticking.append(i)
            plain(arrivals)
            ticking.pop()
        e.tick = tick
    tolist = torch.Tensor.tolist
    monkeypatch.setattr(
        torch.Tensor, "tolist",
        lambda self: copies.append((ticking[-1], engines[ticking[-1]].t))
        or tolist(self))
    wl = [Request(rid=i, arrival=i // 2, prompt_len=4, n_tokens=3 + i % 4)
          for i in range(8)]
    Router(engines).run(wl)
    worked = [(i, t) for i, e in enumerate(engines)
              for t, n_active, _ in e.tick_log if n_active]
    assert sorted(copies) == worked
    assert {i for i, _ in worked} == {0, 1}


SERVE = ["--requests", "10", "--slots", "4", "--max-len", "160",
         "--policy", "sfs", "--replicas", "2"]


@pytest.mark.parametrize("arch,synthetic", [("qwen2.5-3b", True),
                                            ("qwen2.5-3b", False),
                                            ("zamba2-1.2b", False)])
def test_serve_replicas_summary_matches_reference(arch, synthetic):
    args = SERVE + ["--arch", arch] + (["--synthetic"] if synthetic else [])
    want = ref_serve.main(args)
    got = serve.main(args + ["--device", "cpu"])
    assert {k: got[k] for k in want} == want
    assert got["incomplete"] == 0 and sum(got["dispatch_counts"]) == 10
    assert min(got["dispatch_counts"]) > 0
    if synthetic:
        assert got["prefills"] == got["decode_steps"] == 0
    else:
        assert got["prefills"] == 10 and got["decode_steps"] > 0
