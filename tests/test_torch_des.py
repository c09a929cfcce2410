"""The port's single-server discrete-event simulator against the JAX
package's on the CPU.

``repro_torch.core.simulator.simulate`` must give every ``JobStats``
field equal to the reference's, and of the same Python type (a
fingerprint hashes ``repr`` of them), under each of the six DES policies
and the SFS knobs (fixed slice, hinted demotion, I/O-oblivious FILTER,
switch cost, no overload bypass).  The policy constructors, the
``SimConfig`` <-> ``ServerSpec`` converters and the ``SimResult``
metrics must agree too, and SFS must beat CFS on short-function p50 in
both of the port's execution models, as ``tests/test_agreement.py``
holds the reference to.  Exact equality throughout.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FaaSBenchConfig as RefFaaS  # noqa: E402
from repro.core import generate as ref_generate  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core import policies as ref_policies  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.core.spec import ServerSpec as RefServer  # noqa: E402
from repro_torch.core import (FaaSBenchConfig, SimConfig,  # noqa: E402
                              generate, metrics, policies, simulate)
from repro_torch.core.spec import (DES_POLICIES,  # noqa: E402
                                   DES_SCHED_FIELDS, ServerSpec)

STAT_FIELDS = ("rid", "arrival", "service", "io_total", "finish", "n_ctx",
               "demoted", "queue_delay")
SHORT_TICKS = 10          # tick-engine short bucket (tokens)
SHORT_S = 0.1             # DES short bucket (seconds, Azure Table I)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tick engine's tiny ops gain nothing from intra-op threads, and
    with several test workers on one machine their spin-waiting stalls
    every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def workloads(**kw):
    base = dict(n_requests=400, cores=4, load=1.0, seed=4,
                io_fraction=0.3, n_functions=12)
    base.update(kw)
    return ref_generate(RefFaaS(**base)), generate(FaaSBenchConfig(**base))


def stat_rows(res):
    return [tuple(getattr(s, f) for f in STAT_FIELDS) for s in res.stats]


def stat_types(res):
    return [tuple(type(getattr(s, f)) for f in STAT_FIELDS)
            for s in res.stats]


def assert_same_result(a, b):
    assert stat_rows(a) == stat_rows(b)
    assert stat_types(a) == stat_types(b)
    assert [(s.turnaround, s.rte, s.slowdown) for s in a.stats] == \
        [(s.turnaround, s.rte, s.slowdown) for s in b.stats]
    assert (a.busy_time, a.makespan, a.n_ctx_total) == \
        (b.busy_time, b.makespan, b.n_ctx_total)
    assert a.queue_delay_timeline == b.queue_delay_timeline
    assert a.slice_timeline == b.slice_timeline


def run_both(cfg_kw, **wl_kw):
    rreqs, preqs = workloads(**wl_kw)
    a = ref_simulate(rreqs, RefSimConfig(**cfg_kw))
    b = simulate(preqs, SimConfig(**cfg_kw))
    return a, b


@pytest.mark.parametrize("policy", DES_POLICIES)
def test_simulate_matches_reference_per_policy(policy):
    a, b = run_both(dict(cores=4, policy=policy))
    assert_same_result(a, b)
    assert len(b.stats) == 400


@pytest.mark.parametrize("knobs", [
    dict(slice_s=0.05),
    dict(hinted_demotion=True),
    dict(io_aware=False),
    dict(ctx_switch_cost_s=0.0),
    dict(ctx_switch_cost_s=500e-6),
    dict(overload_factor=None, adaptive_window=20, slice_init_s=0.02),
    dict(poll_interval_s=0.001),
], ids=["fixed-slice", "hinted", "io-oblivious", "no-switch-cost",
        "switch-cost-500us", "no-bypass", "poll-1ms"])
def test_simulate_sfs_knobs_match_reference(knobs):
    a, b = run_both(dict(cores=4, policy="sfs", **knobs), iat="trace")
    assert_same_result(a, b)


@pytest.mark.parametrize("policy, knobs", [
    ("rr", dict(rr_quantum_s=0.01)),
    ("cfs", dict(cfs_latency_s=0.012, cfs_min_gran_s=0.002)),
    ("fifo", dict(ctx_switch_cost_s=250e-6)),
    ("srtf", dict(ctx_switch_cost_s=0.0)),
])
def test_simulate_baseline_knobs_match_reference(policy, knobs):
    a, b = run_both(dict(cores=3, policy=policy, **knobs), load=0.9)
    assert_same_result(a, b)


def test_simulator_result_and_stats_types():
    _, b = run_both(dict(cores=4, policy="sfs"))
    s = b.stats[0]
    assert type(s.rid) is int and type(s.finish) is float
    assert type(s.n_ctx) is int and type(s.demoted) is bool
    assert [s.rid for s in b.stats] == list(range(400))


@pytest.mark.parametrize("name, kw", [
    ("sfs", {}),
    ("sfs", dict(slice_s=0.2, adaptive_window=10, overload_factor=None,
                 io_aware=False, poll_interval_s=0.002)),
    ("cfs", dict(latency_s=0.012, min_gran_s=0.001)),
    ("fifo", {}), ("rr", dict(quantum_s=0.02)), ("srtf", {}),
    ("ideal", {}),
])
def test_policy_constructors_match_reference(name, kw):
    want = getattr(ref_policies, name)(6, **kw)
    got = getattr(policies, name)(6, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(policies.make(name, 6, **kw)) == \
        dataclasses.asdict(ref_policies.make(name, 6, **kw))
    assert policies.ALL_POLICIES == ref_policies.ALL_POLICIES


@pytest.mark.parametrize("kw", [
    dict(),
    dict(cores=6, policy="cfs", cfs_latency_s=0.012),
    dict(cores=2, policy="sfs", slice_s=0.05, hinted_demotion=True,
         io_aware=False, ctx_switch_cost_s=0.0),
    dict(cores=8, policy="rr", rr_quantum_s=0.02, overload_factor=None),
    dict(cores=3, policy="srtf", poll_interval_s=0.001,
         adaptive_window=7, slice_init_s=0.3, cfs_min_gran_s=0.002),
])
def test_sim_config_to_spec_round_trips(kw):
    cfg = SimConfig(**kw)
    spec = cfg.to_spec()
    ref_spec = RefSimConfig(**kw).to_spec()
    assert isinstance(spec, ServerSpec)
    assert str(spec) == str(ref_spec)
    assert ServerSpec.parse(str(spec)) == spec
    assert spec.to_sim_config() == cfg
    assert ServerSpec.from_sim_config(cfg) == spec
    assert dataclasses.asdict(RefServer.parse(str(spec)).to_sim_config()) \
        == dataclasses.asdict(cfg)


def test_des_knob_map_matches_reference():
    from repro.core import spec as ref_spec
    assert DES_SCHED_FIELDS == ref_spec.DES_SCHED_FIELDS
    assert DES_POLICIES == ref_spec.DES_POLICIES
    assert set(DES_SCHED_FIELDS.values()) < {
        f.name for f in dataclasses.fields(SimConfig)}


def test_to_sim_config_refusals():
    with pytest.raises(ValueError, match="not a DES policy"):
        ServerSpec(cores=2, scheduler="edf").to_sim_config()
    with pytest.raises(ValueError, match="unknown scheduler knob"):
        ServerSpec(cores=2, scheduler="sfs:stall_aware=True").to_sim_config()


def test_metrics_compare_and_buckets_match_reference():
    rreqs, preqs = workloads(n_requests=500, cores=6, io_fraction=0.0,
                             n_functions=0, seed=9)
    ra = {p: ref_simulate(rreqs, RefSimConfig(cores=6, policy=p))
          for p in ("sfs", "cfs")}
    pa = {p: simulate(preqs, SimConfig(cores=6, policy=p))
          for p in ("sfs", "cfs")}
    for tol in (1.0, 1.1):
        assert dataclasses.asdict(metrics.compare(pa["sfs"], pa["cfs"],
                                                  tol)) == \
            dataclasses.asdict(ref_metrics.compare(ra["sfs"], ra["cfs"],
                                                   tol))
    for p in ("sfs", "cfs"):
        a, b = ra[p], pa[p]
        assert metrics.result_bucket_stats(b) == \
            ref_metrics.result_bucket_stats(a)
        assert metrics.result_bucket_stats(b, edges=(0.05, 0.5, 2.0),
                                           ps=(50, 90, 99.9)) == \
            ref_metrics.result_bucket_stats(a, edges=(0.05, 0.5, 2.0),
                                            ps=(50, 90, 99.9))
        np.testing.assert_array_equal(metrics.turnarounds(b),
                                      ref_metrics.turnarounds(a))
        np.testing.assert_array_equal(metrics.rtes(b), ref_metrics.rtes(a))
        for x, y in zip(metrics.cdf(metrics.rtes(b), n=50),
                        ref_metrics.cdf(ref_metrics.rtes(a), n=50)):
            np.testing.assert_array_equal(x, y)
        for thr in (0.1, 0.5, 0.9):
            assert metrics.frac_rte_below(b, thr) == \
                ref_metrics.frac_rte_below(a, thr)
            assert metrics.frac_rte_atleast(b, thr) == \
                ref_metrics.frac_rte_atleast(a, thr)
        assert metrics.mean_turnaround(b) == ref_metrics.mean_turnaround(a)
        assert metrics.median_turnaround(b) == \
            ref_metrics.median_turnaround(a)
    xs, ys = metrics.cdf(np.array([]))
    assert xs.size == ys.size == 0


def _tick_workload(n=150, lanes=4, load=1.0, seed=5, short_frac=0.8):
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    svc = np.where(rng.random(n) < short_frac,
                   rng.integers(2, 8, n), rng.integers(30, 80, n))
    span = svc.sum() / (load * lanes)
    iats = rng.exponential(1.0, n)
    arr = np.cumsum(iats * span / iats.sum()).astype(int)
    return [Request(rid=i, arrival=int(arr[i]), prompt_len=4,
                    n_tokens=int(svc[i])) for i in range(n)]


def _short_p50_engine(policy, seed):
    from repro_torch.serving import Engine, EngineConfig
    eng = Engine(EngineConfig(lanes=4, n_slots=256, policy=policy),
                 device="cpu")
    done = eng.run(_tick_workload(seed=seed), max_ticks=2_000_000)
    ta = np.array([r.turnaround for r in done
                   if r.service_demand < SHORT_TICKS])
    return float(np.median(ta))


def _short_p50_des(policy, seed):
    reqs = generate(FaaSBenchConfig(n_requests=2000, cores=12, load=1.0,
                                    seed=seed))
    res = simulate(reqs, SimConfig(cores=12, policy=policy))
    ta = np.array([s.turnaround for s in res.stats
                   if s.service < SHORT_S])
    return float(np.median(ta))


def test_sfs_improves_short_p50_in_both_layers():
    """The paper's headline claim in both of the port's execution
    models: its tick engine on the CPU and its discrete-event
    simulator."""
    for seed in (5, 6):
        engine_sfs = _short_p50_engine("sfs", seed)
        engine_cfs = _short_p50_engine("cfs", seed)
        assert engine_sfs <= engine_cfs, (seed, engine_sfs, engine_cfs)
    for seed in (5, 6):
        des_sfs = _short_p50_des("sfs", seed)
        des_cfs = _short_p50_des("cfs", seed)
        assert des_sfs < des_cfs, (seed, des_sfs, des_cfs)
