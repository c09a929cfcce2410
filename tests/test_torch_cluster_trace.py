"""Canonical lifecycle-trace equality between the port's fleet backend
and the JAX package's ``engine="jax"`` — strictly stronger than the
end-state fingerprints: every routing decision, FILTER admit, bypass,
demotion, preemption, cold start, failure, requeue, scale, timeout,
retry, shed and completion must match, event for event (the
``_run_traced`` pattern of ``tests/test_agreement.py``)."""
import pytest

torch = pytest.importorskip("torch")

from repro.core.spec import ExperimentSpec as JaxSpec  # noqa: E402
from repro.core.spec import ServerSpec as JaxServer  # noqa: E402
from repro.core.spec import TickWorkloadSpec as JaxWorkload  # noqa: E402
from repro.core.spec import run_experiment as run_jax  # noqa: E402
from repro.core.telemetry import Telemetry as JaxTelemetry  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.spec import TickWorkloadSpec  # noqa: E402
from repro_torch.core.telemetry import Telemetry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The fleet's tick program is hundreds of tiny tensor ops: intra-op
    threads add nothing to it, and with several test workers on one
    machine their spin-waiting stalls every process ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_traced(servers, dispatch, predictor, wl, **knobs):
    """(jax result, jax trace, torch result, torch trace)."""
    jwl = (JaxWorkload(**wl) if isinstance(wl, dict) else wl)
    twl = (TickWorkloadSpec(**wl) if isinstance(wl, dict) else wl)
    jtel = JaxTelemetry(trace=True)
    jx = run_jax(JaxSpec(
        engine="jax", servers=tuple(JaxServer.parse(s) for s in servers),
        dispatch=dispatch, predictor=predictor, workload=jwl, **knobs),
        max_ticks=2_000_000, telemetry=jtel)
    ttel = Telemetry(trace=True)
    tt = repro_torch.run_experiment(repro_torch.ExperimentSpec(
        servers=servers, dispatch=dispatch, predictor=predictor,
        workload=twl, **knobs), max_ticks=2_000_000, telemetry=ttel,
        device="cpu")
    assert jx.fingerprint() == tt.fingerprint()
    assert (jx.shed, jx.timeouts, jx.retries) == (tt.shed, tt.timeouts,
                                                  tt.retries)
    return jx, jtel.trace, tt, ttel.trace


@pytest.mark.parametrize("n_engines", [4, 64])
def test_trace_agreement_torch_vs_jax(n_engines):
    servers = ("cores=4",) * n_engines
    _, jtr, tt, ttr = run_traced(servers, "sfs-aware", "history",
                                 dict(n=400, load=1.0, seed=23))
    assert ttr.canonical() == jtr.canonical()
    counts = ttr.counts()
    assert counts["arrival"] == counts["dispatch"] == tt.n
    assert counts["complete"] == tt.n
    assert counts["admit"] > 0                  # FILTER actually engaged


def test_trace_agreement_covers_demote_and_preempt():
    """High load with hinted demotion, so the rarer demote/preempt/bypass
    kinds are exercised."""
    servers = ("cores=2;scheduler=sfs:hinted_demotion=True",) * 4
    _, jtr, _, ttr = run_traced(servers, "sfs-aware", "oracle",
                                dict(n=300, load=1.5, seed=11))
    assert ttr.canonical() == jtr.canonical()
    counts = ttr.counts()
    assert counts["demote"] > 0 and counts["preempt"] > 0


@pytest.mark.parametrize("dispatch", ["hash", "sfs-aware"])
def test_trace_agreement_cold_start_keep_alive(dispatch):
    servers = ("cores=2",) * 4
    _, jtr, _, ttr = run_traced(
        servers, dispatch, "history",
        "bimodal:n=250,seed=23|zipf:funcs=8,s=1.2",
        lifecycle="lifecycle:cold=3,ttl=60,cap=4")
    assert ttr.canonical() == jtr.canonical()
    counts = ttr.counts()
    assert counts["cold_start"] > 0
    assert counts["fail"] == counts["requeue"] == counts["scale"] == 0


def test_trace_agreement_failure_drain_and_scaling():
    servers = ("cores=2",) * 4
    _, jtr, tt, ttr = run_traced(
        servers, "sfs-aware", "history",
        "bimodal:n=250,seed=5,load=1.2|flash:at=150,x=4,dur=200",
        lifecycle="lifecycle:cold=3,ttl=60,cap=4,fail=40,fail_server=1",
        scaling="scale:min=2,T=25,up=0.5,down=0.1")
    assert ttr.canonical() == jtr.canonical()
    assert tt.n == 250                          # drained work is re-run
    counts = ttr.counts()
    assert counts["fail"] == 1 and counts["requeue"] > 0
    assert counts["scale"] > 0 and counts["cold_start"] > 0


def test_trace_agreement_under_chaos_schedule():
    """Fault episodes with recovery, timeouts with backoff retries and
    admission shedding: the gap/chunk fast paths must stop at every
    boundary exactly where the reference does."""
    servers = ("cores=2",) * 4
    _, jtr, tt, ttr = run_traced(
        servers, "sfs-aware", "history",
        "bimodal:n=250,seed=5,load=1.2|zipf:funcs=8,s=1.2",
        lifecycle="lifecycle:cold=3,ttl=60,cap=4",
        faults="faults:mttf=150,mttr=60,blast=2,episodes=2,seed=9",
        retry="retry:timeout=120,retries=2,backoff=8,shed=10")
    assert ttr.canonical() == jtr.canonical()
    counts = ttr.counts()
    assert counts["fail"] > 0 and counts["recover"] > 0
    assert counts["timeout"] > 0 and counts["retry"] > 0
    assert counts["shed"] > 0
    assert tt.n + tt.shed == 250
    assert counts["complete"] == tt.n
