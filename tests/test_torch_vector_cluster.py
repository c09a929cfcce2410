"""The port's vector backend (``engine="vector"``) on the CPU.

Inside the port the three tick-semantics backends — ``tick`` (per-object
engines), ``vector`` (numpy struct-of-arrays groups) and ``torch`` (the
fleet stepping) — must agree field for field on shared seeds, with
servers pinned to the object engine riding inside a vector cluster; the
vector backend must equal the JAX package's, trace for trace; and the
port's ``vector`` and ``tick`` must reproduce a recorded row of
``benchmarks/baselines/BENCH_cluster.json``.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core.spec import ExperimentSpec as RefSpec  # noqa: E402
from repro.core.spec import ServerSpec as RefServer  # noqa: E402
from repro.core.spec import TickWorkloadSpec as RefWorkload  # noqa: E402
from repro.core.spec import run_experiment as run_ref  # noqa: E402
from repro.core.telemetry import Telemetry as RefTelemetry  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.spec import ServerSpec, TickWorkloadSpec  # noqa: E402
from repro_torch.core.telemetry import Telemetry  # noqa: E402
from repro_torch.serving import Request, VectorCluster  # noqa: E402

BASELINES = (Path(__file__).resolve().parents[1] / "benchmarks"
             / "baselines" / "BENCH_cluster.json")
DISPATCH = ["hash", "least-outstanding", "pull", "sfs-aware"]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The fleet's tick program is hundreds of tiny tensor ops: intra-op
    threads add nothing to it, and with several test workers on one
    machine their spin-waiting stalls every process ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def full_fingerprint(reqs):
    """Every per-request field the engines mutate."""
    return [(r.rid, r.finish, r.served_ticks, r.n_ctx, r.demoted,
             r.first_start, r.queue_delay, r.queue_enter, r.vruntime,
             r.slice_left, r.tokens_done, r.prefill_done, r.slot)
            for r in reqs]


def run(engine, servers, dispatch, predictor, wl, **knobs):
    return repro_torch.run_experiment(repro_torch.ExperimentSpec(
        engine=engine, servers=servers, dispatch=dispatch,
        predictor=predictor, workload=wl, **knobs), max_ticks=2_000_000,
        device="cpu")


def assert_same(a, b):
    assert full_fingerprint(a.raw) == full_fingerprint(b.raw)
    assert a.dispatch_counts == b.dispatch_counts
    assert a.eta_log == b.eta_log
    assert a.overload_bypasses == b.overload_bypasses
    assert (a.shed, a.timeouts, a.retries) == (b.shed, b.timeouts,
                                               b.retries)
    assert a.fingerprint() == b.fingerprint()


@pytest.mark.parametrize("n_engines", [1, 4, 8])
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_tick_vector_torch_agree(n_engines, dispatch):
    servers = ("cores=4",) * n_engines
    wl = TickWorkloadSpec(n=250, load=1.0, seed=23)
    tick = run("tick", servers, dispatch, "history", wl)
    for engine in ("vector", "torch"):
        assert_same(tick, run(engine, servers, dispatch, "history", wl))
    assert tick.n == 250


def test_three_backends_agree_on_mixed_groups():
    """Two sfs groups of different shapes and a cfs group: several
    groups in one cluster."""
    servers = ("cores=6",) * 2 + ("cores=4",) + ("cores=2;scheduler=cfs",) * 2
    wl = TickWorkloadSpec(n=400, load=1.0, seed=11)
    tick = run("tick", servers, "sfs-aware", "oracle", wl)
    for engine in ("vector", "torch"):
        assert_same(tick, run(engine, servers, "sfs-aware", "oracle", wl))


@pytest.mark.parametrize("dispatch", ["least-outstanding", "pull"])
def test_vector_with_object_stragglers_equals_tick(dispatch):
    """An srtf and a fifo server (which cannot vectorize) ride inside a
    vector cluster as per-object engines beside an sfs group, and the
    run still equals the all-object cluster."""
    servers = ("cores=4", "cores=4", "cores=4;scheduler=srtf",
               "cores=4;scheduler=srtf", "cores=2;scheduler=fifo")
    wl = TickWorkloadSpec(n=300, load=0.9, seed=3)
    tick = run("tick", servers, dispatch, "history", wl)
    vec = run("vector", servers, dispatch, "history", wl)
    assert_same(tick, vec)
    c = VectorCluster([ServerSpec.parse(s) for s in servers], device="cpu")
    assert c.summary()["stragglers"] == [2, 3, 4]
    assert c.stragglers[2].device.type == "cpu"


def test_vector_refusals():
    c = VectorCluster(["cores=2"], device="cpu")
    with pytest.raises(ValueError, match="stall events"):
        c._submit(0, Request(rid=0, arrival=0, prompt_len=4, n_tokens=5,
                             stall_events=((1, 2),)))
    # stall events are fine on a straggler (a per-object engine)
    c = VectorCluster(["cores=2;scheduler=fifo"], device="cpu")
    done = c.run([Request(rid=0, arrival=0, prompt_len=4, n_tokens=5,
                          stall_events=((1, 2),))])
    assert done[0].finish is not None


def traced(engine, servers, wl, **knobs):
    tel = Telemetry(trace=True)
    res = repro_torch.run_experiment(repro_torch.ExperimentSpec(
        engine=engine, servers=servers, dispatch="sfs-aware",
        predictor="history", workload=wl, **knobs), max_ticks=2_000_000,
        telemetry=tel, device="cpu")
    return res, tel.trace.canonical()


CHAOS = dict(lifecycle="lifecycle:cold=3,ttl=60,cap=4",
             faults="faults:mttf=150,mttr=60,blast=2,episodes=2,seed=9",
             retry="retry:timeout=120,retries=2,backoff=8,shed=10")


@pytest.mark.parametrize("knobs", ["none", "chaos"])
def test_vector_trace_equals_reference_vector(knobs):
    """The port's vector backend against the JAX package's, event for
    event; and against the port's own tick backend."""
    servers = ("cores=2",) * 4
    wl = ("bimodal:n=250,seed=5,load=1.2|zipf:funcs=8,s=1.2"
          if knobs == "chaos" else TickWorkloadSpec(n=300, load=1.2,
                                                    seed=11))
    kw = CHAOS if knobs == "chaos" else {}
    res, canon = traced("vector", servers, wl, **kw)
    rtel = RefTelemetry(trace=True)
    ref = run_ref(RefSpec(
        engine="vector", servers=tuple(RefServer.parse(s) for s in servers),
        dispatch="sfs-aware", predictor="history",
        workload=(wl if isinstance(wl, str)
                  else RefWorkload(n=300, load=1.2, seed=11)), **kw),
        max_ticks=2_000_000, telemetry=rtel)
    assert canon == rtel.trace.canonical()
    assert full_fingerprint(res.raw) == full_fingerprint(ref.raw)
    assert res.dispatch_counts == ref.dispatch_counts
    assert res.eta_log == ref.eta_log
    assert (res.shed, res.timeouts, res.retries) == (ref.shed, ref.timeouts,
                                                     ref.retries)
    tick, tick_canon = traced("tick", servers, wl, **kw)
    assert tick_canon == canon
    kinds = {e[1] for e in canon}
    assert "complete" in kinds
    if knobs == "chaos":
        assert {"fail", "recover", "timeout", "retry", "shed"} <= kinds


def test_recorded_elastic_row():
    """``run_elastic`` of ``benchmarks/cluster_sweep.py`` at load 0.8
    under sfs-aware (16 x 4 engines, 20,000 requests, cold starts, a
    flash crowd, a failure and an autoscaler), recorded on the JAX
    package's vector backend: the port's vector and tick backends
    reproduce its fingerprint and shed count."""
    rows = [r for r in json.loads(BASELINES.read_text())["rows"]
            if r["scenario"] == "elastic" and r["policy"] == "sfs-aware"
            and r["load"] == 0.8]
    assert len(rows) == 1
    want = rows[0]
    spec = dict(
        servers=tuple(ServerSpec(cores=4) for _ in range(16)),
        dispatch="sfs-aware",
        workload=("bimodal:n=20000,seed=7,load=0.8|zipf:funcs=16,s=1.1"
                  "|flash:at=1000,x=2,dur=1000"),
        lifecycle="lifecycle:cold=2,ttl=400,cap=8,fail=2600,fail_server=3",
        scaling="scale:min=12,T=25,up=0.6,down=0.15,step=2")
    for engine in ("vector", "tick"):
        res = repro_torch.run_experiment(
            repro_torch.ExperimentSpec(engine=engine, **spec),
            max_ticks=50_000_000, device="cpu")
        assert res.fingerprint()[:16] == want["provenance"]["result_fp"]
        assert res.shed == want["shed"]
        assert res.n + res.shed == want["n"]
