"""The port's per-object cluster (``engine="tick"``) against the JAX
package's ``engine="tick"`` on the CPU.

Every per-request field, the dispatch counts, the ETA log, the overload
bypasses and the canonical lifecycle traces (``complete`` events
included) must match, under the four dispatch policies, with stalls,
mixed schedulers, and the lifecycle, scaling, fault and retry knobs; the
engine's dispatch hooks must read the same at every tick, and the spec
converters must round-trip as the reference's do.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.spec import ExperimentSpec as RefSpec  # noqa: E402
from repro.core.spec import ServerSpec as RefServer  # noqa: E402
from repro.core.spec import TickWorkloadSpec as RefWorkload  # noqa: E402
from repro.core.spec import run_experiment as run_ref  # noqa: E402
from repro.core.telemetry import Telemetry as RefTelemetry  # noqa: E402
from repro.serving import ClusterConfig as RefClusterConfig  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.spec import ServerSpec, TickWorkloadSpec  # noqa: E402
from repro_torch.core.telemetry import Telemetry  # noqa: E402
from repro_torch.serving import (ClusterConfig, Engine,  # noqa: E402
                                 EngineConfig, Request)

DISPATCH = ["hash", "least-outstanding", "pull", "sfs-aware"]
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Nothing here needs intra-op threads, and with several test workers
    on one machine their spin-waiting stalls every process."""
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


def run_both(servers, dispatch, predictor, wl=None, rows=None, trace=False,
             **knobs):
    """(reference result, port result, reference trace, port trace) of
    one ``engine="tick"`` spec; ``wl`` is a TickWorkloadSpec's fields or
    a pipe string, ``rows`` an explicit request list as
    ``(rid, arrival, n_tokens, stall_events)``."""
    reqs = {}
    if rows is not None:
        reqs = {"ref": [RefRequest(rid=i, arrival=a, prompt_len=4,
                                   n_tokens=n, stall_events=ev)
                        for i, a, n, ev in rows],
                "port": [Request(rid=i, arrival=a, prompt_len=4,
                                 n_tokens=n, stall_events=ev)
                         for i, a, n, ev in rows]}
    jtel = RefTelemetry(trace=True) if trace else None
    ref = run_ref(RefSpec(
        engine="tick", servers=tuple(RefServer.parse(s) for s in servers),
        dispatch=dispatch, predictor=predictor,
        workload=RefWorkload(**wl) if isinstance(wl, dict) else wl,
        **knobs), reqs.get("ref"), max_ticks=2_000_000, telemetry=jtel)
    ttel = Telemetry(trace=True) if trace else None
    port = repro_torch.run_experiment(repro_torch.ExperimentSpec(
        engine="tick", servers=servers, dispatch=dispatch,
        predictor=predictor,
        workload=TickWorkloadSpec(**wl) if isinstance(wl, dict) else wl,
        **knobs), reqs.get("port"), max_ticks=2_000_000, telemetry=ttel,
        device="cpu")
    assert ref.fingerprint() == port.fingerprint()
    assert full_fingerprint(ref.raw) == full_fingerprint(port.raw)
    assert ref.dispatch_counts == port.dispatch_counts
    assert ref.eta_log == port.eta_log
    assert ref.overload_bypasses == port.overload_bypasses
    assert (ref.shed, ref.timeouts, ref.retries) == (port.shed,
                                                      port.timeouts,
                                                      port.retries)
    return (ref, port, jtel.trace if trace else None,
            ttel.trace if trace else None)


@pytest.mark.parametrize("n_engines", [1, 3, 8])
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_tick_bit_exact_vs_reference(n_engines, dispatch):
    """Learned-predictor feedback included: the completion order the
    engines report drives every later routing decision."""
    _, port, _, _ = run_both(("cores=4",) * n_engines, dispatch, "history",
                             dict(n=250, load=1.0, seed=23))
    assert port.n == 250


def stall_rows(n=220, seed=4):
    rng = np.random.default_rng(seed)
    svc = np.where(rng.random(n) < 0.8, rng.integers(2, 8, n),
                   rng.integers(30, 80, n))
    arr = np.cumsum(rng.exponential(svc.mean() / 14.0, n)).astype(int)
    return [(i, int(arr[i]), int(svc[i]),
             ((1, int(rng.integers(2, 8))),) if rng.random() < 0.3
             and svc[i] > 3 else ()) for i in range(n)]


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_tick_mixed_pool_with_stalls(dispatch):
    """sfs, cfs, fifo and srtf servers of different shapes in one
    cluster, with requests parking on stall events."""
    servers = ("cores=4", "cores=2;scheduler=cfs", "cores=3;scheduler=fifo",
               "cores=2;scheduler=srtf;slots=6",
               "cores=3;scheduler=sfs:hinted_demotion=True")
    rows = stall_rows()
    assert any(ev for *_, ev in rows)
    _, port, _, _ = run_both(servers, dispatch, "class", rows=rows)
    assert port.n == len(rows)


def test_trace_agreement_with_completions():
    _, port, rtr, ptr = run_both(("cores=4",) * 4, "sfs-aware", "history",
                                 dict(n=400, load=1.0, seed=23), trace=True)
    assert ptr.canonical() == rtr.canonical()
    counts = ptr.counts()
    assert counts["arrival"] == counts["dispatch"] == port.n
    assert counts["complete"] == port.n
    assert counts["admit"] > 0


def test_trace_agreement_demote_preempt_and_stalls():
    servers = ("cores=2;scheduler=sfs:hinted_demotion=True",) * 3 + (
        "cores=2;scheduler=cfs",)
    _, port, rtr, ptr = run_both(servers, "sfs-aware", "oracle",
                                 rows=stall_rows(seed=9), trace=True)
    assert ptr.canonical() == rtr.canonical()
    counts = ptr.counts()
    assert counts["demote"] > 0 and counts["preempt"] > 0
    assert counts["complete"] == port.n


KNOBS = {
    "cold-start": dict(
        wl="bimodal:n=250,seed=23|zipf:funcs=8,s=1.2",
        lifecycle="lifecycle:cold=3,ttl=60,cap=4"),
    "fail-drain-scale": dict(
        wl="bimodal:n=250,seed=5,load=1.2|flash:at=150,x=4,dur=200",
        lifecycle="lifecycle:cold=3,ttl=60,cap=4,fail=40,fail_server=1",
        scaling="scale:min=2,T=25,up=0.5,down=0.1"),
    "chaos": dict(
        wl="bimodal:n=250,seed=5,load=1.2|zipf:funcs=8,s=1.2",
        lifecycle="lifecycle:cold=3,ttl=60,cap=4",
        faults="faults:mttf=150,mttr=60,blast=2,episodes=2,seed=9",
        retry="retry:timeout=120,retries=2,backoff=8,shed=10"),
}


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("dispatch", ["hash", "sfs-aware"])
def test_trace_agreement_lifecycle_faults_retry(knobs, dispatch):
    kw = dict(KNOBS[knobs])
    wl = kw.pop("wl")
    ref, port, rtr, ptr = run_both(("cores=2",) * 4, dispatch, "history",
                                   wl, trace=True, **kw)
    assert ptr.canonical() == rtr.canonical()
    counts = ptr.counts()
    assert counts["complete"] == port.n
    assert port.n + port.shed == 250
    if knobs == "cold-start":
        assert counts["cold_start"] > 0
    elif knobs == "fail-drain-scale":
        assert counts["fail"] == 1 and counts["requeue"] > 0
        assert counts["scale"] > 0
    else:
        assert counts["fail"] > 0 and counts["timeout"] > 0
        assert counts["retry"] > 0


def test_engine_hooks_match_reference_every_tick():
    """``outstanding``, ``runnable_count`` and ``free_capacity`` read the
    same as the reference engine's at every tick of a workload with
    stalls, and ``on_finish`` sees the same completions in the same
    order."""
    rows = stall_rows(n=120, seed=3)
    ecfg = dict(lanes=3, n_slots=10, policy="sfs")
    ref = RefEngine(RefEngineConfig(**ecfg))
    port = Engine(EngineConfig(**ecfg), device="cpu")
    fin_r, fin_p = [], []
    ref.on_finish = lambda r, t: fin_r.append((r.rid, t))
    port.on_finish = lambda r, t: fin_p.append((r.rid, t))
    wl_r = [RefRequest(rid=i, arrival=a, prompt_len=4, n_tokens=n,
                       stall_events=ev) for i, a, n, ev in rows]
    wl_p = [Request(rid=i, arrival=a, prompt_len=4, n_tokens=n,
                    stall_events=ev) for i, a, n, ev in rows]
    i, hooks_r, hooks_p, stalled = 0, [], [], 0
    while len(ref.finished) < len(rows):
        arr_r, arr_p = [], []
        while i < len(rows) and rows[i][1] <= ref.t:
            arr_r.append(wl_r[i])
            arr_p.append(wl_p[i])
            i += 1
        ref.tick(arr_r)
        port.tick(arr_p)
        stalled += ref.n_stalled > 0
        for e, out in ((ref, hooks_r), (port, hooks_p)):
            out.append((e.outstanding(), e.runnable_count(),
                        e.free_capacity()))
    assert stalled > 0
    assert hooks_p == hooks_r
    assert fin_p == fin_r and len(fin_p) == len(rows)


SCHED_KW = [
    dict(policy="sfs"),
    dict(policy="sfs", sched_kw=dict(slice_ticks=5, overload_factor=None,
                                     hinted_demotion=True)),
    dict(lanes=6, n_slots=40, max_len=512, policy="sfs",
         sched_kw=dict(adaptive_window=50, slice_init=16.0,
                       overload_factor=2.5)),
    dict(lanes=2, policy="cfs"),
    dict(policy="fifo"),
    dict(policy="srtf", n_slots=3),
]


@pytest.mark.parametrize("kw", SCHED_KW)
def test_engine_config_spec_round_trip(kw):
    """``EngineConfig.to_spec`` -> ``ServerSpec.from_engine_config`` ->
    ``to_engine_config`` is lossless, through the string form too, and
    equals the reference's conversion."""
    ecfg = EngineConfig(**kw)
    spec = ecfg.to_spec()
    assert spec == ServerSpec.from_engine_config(ecfg)
    assert spec.to_engine_config() == ecfg
    assert ServerSpec.parse(str(spec)) == spec
    assert ServerSpec.parse(str(spec)).to_engine_config() == ecfg
    ref = RefEngineConfig(**kw).to_spec()
    assert str(spec) == str(ref)
    assert vars(spec.to_engine_config()) == vars(ref.to_engine_config())


@pytest.mark.parametrize("text", [
    "cores=2", "cores=6;scheduler=sfs:O=3;slots=96",
    "cores=4;scheduler=cfs;max_len=64", "cores=2;scheduler=srtf"])
def test_server_spec_string_matches_reference(text):
    spec = ServerSpec.parse(text)
    assert str(spec) == str(RefServer.parse(text))
    assert ServerSpec.parse(str(spec)) == spec
    assert vars(spec.to_engine_config()) == vars(
        RefServer.parse(text).to_engine_config())


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(policy="sfs-aware", predictor="history", overload_factor=2.0,
         adaptive_window=50, slice_init=16.0),
    dict(policy="pull", predictor="class",
         lifecycle="lifecycle:cold=3,ttl=60,cap=4,fail=40,fail_server=1",
         scaling="scale:min=2,T=25,up=0.5,down=0.1"),
    dict(policy="least-outstanding", predictor="none",
         faults="faults:mttf=150,mttr=60,blast=2,episodes=2,seed=9",
         retry="retry:timeout=120,retries=2,backoff=8,shed=10"),
])
def test_cluster_config_to_spec_matches_reference(cfg):
    engines = [EngineConfig(lanes=2), EngineConfig(lanes=4, policy="cfs")]
    ref_engines = [RefEngineConfig(lanes=2),
                   RefEngineConfig(lanes=4, policy="cfs")]
    port = ClusterConfig(**cfg).to_spec([e.to_spec() for e in engines])
    ref = RefClusterConfig(**cfg).to_spec([e.to_spec() for e in ref_engines])
    want = ref.to_json()
    assert port.engine == want["engine"] == "tick"
    got = {"servers": [str(s) for s in port.servers],
           "dispatch": str(port.dispatch),
           "predictor": str(port.predictor)}
    for k in ("lifecycle", "scaling", "faults", "retry"):
        v = getattr(port, k)
        got[k] = None if v is None else str(v)
    assert got == {k: want[k] for k in got}
    # the converted spec runs the same schedule in both packages
    wl = dict(n=120, load=1.0, seed=2)
    res = repro_torch.run_experiment(
        port.__class__(**{**vars(port), "workload": TickWorkloadSpec(**wl)}),
        device="cpu")
    ref_res = run_ref(ref.__class__(**{**vars(ref),
                                       "workload": RefWorkload(**wl)}))
    assert res.fingerprint() == ref_res.fingerprint()


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("policy", ["sfs-aware", "hash"])
@pytest.mark.parametrize("load", [0.6, 0.8])
def test_chaos_rows_tick_equals_reference_tick(policy, load):
    """The chaos rows of ``benchmarks/cluster_sweep.py`` at full size
    (16 x 4 engines, 20,000 requests, three fault episodes, retries,
    shedding) on ``engine="tick"``: the port equals the JAX package's
    tick backend, whose fingerprints ``chip_smoke.py`` holds the card's
    host run to.  They differ from the recorded rows (its vector backend
    keeps a failed engine's adaptive slice; a fresh per-object scheduler
    does not)."""
    cs = chip_smoke()
    spec = cs.recorded_spec("chaos", policy, load)
    ref = run_ref(RefSpec(
        engine="tick", servers=tuple(RefServer(cores=s.cores)
                                     for s in spec["servers"]),
        **{k: v for k, v in spec.items() if k != "servers"}),
        max_ticks=50_000_000)
    port = repro_torch.run_experiment(
        repro_torch.ExperimentSpec(engine="tick", **spec),
        max_ticks=50_000_000, device="cpu")
    got = (port.fingerprint()[:16], port.shed)
    assert got == (ref.fingerprint()[:16], ref.shed)
    assert got == cs.TICK_CHAOS[(policy, load)]
    assert port.n + port.shed == 20_000
    assert full_fingerprint(port.raw) == full_fingerprint(ref.raw)
