"""The port's multi-server discrete-event simulator (``engine="des"``)
against the JAX package's on the CPU.

``repro_torch.run_experiment(ExperimentSpec(engine="des"), device="cpu")``
must give the reference's fingerprint, chaos counts (shed, timeouts,
retries), dispatch counts, ETA log and canonical lifecycle trace, under
the four dispatch policies and the four predictors, with dispatch
latency, mixed servers, hinted demotion, lifecycle + scaling and faults
+ retries.  The provenance dict (``to_json``) must equal the
reference's, every recorded provenance must rebuild and round-trip, and
the recorded goldens must hold: the three ``GOLDEN_HINTED`` SHA-256s of
``benchmarks/predict_sweep.py`` and a ``layer: "des"`` row of
``benchmarks/baselines/BENCH_cluster.json``.  Exact equality throughout.

The goldens hold where numpy draws FaaSBench's workloads as the
recording host did: its np.log and np.exp round by numpy's build and
the CPU's SIMD path.  ``chip_smoke.DES_REDRAWN`` names the two recorded
seeds whose workload no host tried draws as the recording host did.
"""
import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FaaSBenchConfig as RefFaaS  # noqa: E402
from repro.core import generate as ref_generate  # noqa: E402
from repro.core.spec import ExperimentSpec as RefSpec  # noqa: E402
from repro.core.spec import TickWorkloadSpec as RefTick  # noqa: E402
from repro.core.spec import run_experiment as run_ref  # noqa: E402
from repro.core.simulator import ClusterSimConfig as RefCSC  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.core.telemetry import Telemetry as RefTelemetry  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import (ClusterSimConfig, FaaSBenchConfig,  # noqa: E402
                              SimConfig, generate, simulate,
                              simulate_cluster)
from repro_torch.core.metrics import bucket_stats  # noqa: E402
from repro_torch.core.spec import (ExperimentSpec, ServerSpec,  # noqa: E402
                                   TickWorkloadSpec)
from repro_torch.core.telemetry import Telemetry  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"
DISPATCH = ["hash", "least-outstanding", "pull", "sfs-aware"]
PREDICTORS = ["oracle", "none", "history", "class"]
MIXED = ("cores=6", "cores=6", "cores=2;scheduler=cfs",
         "cores=2;scheduler=cfs")
HINTED = ("cores=2;scheduler=sfs:hinted_demotion=True",) * 4
WL = dict(n_requests=300, cores=8, load=0.9, seed=7, n_functions=12,
          iat="trace", n_spikes=2, spike_size=30)

# benchmarks/predict_sweep.py: GOLDEN_CFG and GOLDEN_HINTED, the
# SHA-256 of the (rid, finish, n_ctx, demoted) stream of the oracle
# predictor's cluster run on 4 x 4 cores
GOLDEN_CFG = dict(n=1200, servers=4, cores=4, load=1.0, seed=17)
GOLDEN_HINTED = {
    "sfs-aware":
        "a96a0323aae69a19d91fee50df050d06243bcb48f2e7a8f1d9ae22dc3bfa0eb0",
    "hash":
        "9eab3216441016fbaf421e55d50231f631dc86b7d685f3cfb9d95ec56cbd46aa",
    "least-outstanding":
        "fc10ad89f5ca614068e133ff26403431c2cae1f4b6d59b19a682776e79baf6a4",
}


def run_both(servers, dispatch="sfs-aware", predictor="oracle", wl=WL,
             trace=True, **knobs):
    """(reference result, port result, reference telemetry, port
    telemetry) of one ``engine="des"`` spec over pre-generated
    requests."""
    kw = dict(engine="des", servers=servers, dispatch=dispatch,
              predictor=predictor, **knobs)
    rtel = RefTelemetry(trace=True, series_cadence=1) if trace else None
    ptel = Telemetry(trace=True, series_cadence=1) if trace else None
    a = run_ref(RefSpec(**kw), requests=ref_generate(RefFaaS(**wl)),
                telemetry=rtel)
    b = repro_torch.run_experiment(
        ExperimentSpec(**kw), requests=generate(FaaSBenchConfig(**wl)),
        telemetry=ptel, device="cpu")
    return a, b, rtel, ptel


def assert_same(a, b, rtel=None, ptel=None):
    assert b.engine == "des" and b.unit == "s"
    assert a.fingerprint() == b.fingerprint()
    assert (a.n, a.shed, a.timeouts, a.retries) == \
        (b.n, b.shed, b.timeouts, b.retries)
    assert a.dispatch_counts == b.dispatch_counts
    assert a.eta_log == b.eta_log
    assert a.overload_bypasses == b.overload_bypasses
    assert a.dispatch_S == b.dispatch_S
    assert (a.policy, a.predictor) == (b.policy, b.predictor)
    for f in ("rids", "service", "turnaround", "rte", "finish", "n_ctx",
              "demoted"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.buckets() == b.buckets()
    if rtel is not None:
        assert rtel.trace.canonical() == ptel.trace.canonical()
        assert rtel.trace.digest() == ptel.trace.digest()
        assert rtel.series.samples == ptel.series.samples
        assert rtel.series.counters == ptel.series.counters


@pytest.mark.parametrize("predictor", PREDICTORS)
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_des_matches_reference(dispatch, predictor):
    assert_same(*run_both(("cores=2",) * 4, dispatch, predictor))


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_des_mixed_servers_match_reference(dispatch):
    wl = dict(WL, cores=16, n_functions=0, iat="poisson")
    assert_same(*run_both(MIXED, dispatch, "history", wl))


@pytest.mark.parametrize("predictor", ["history", "class"])
def test_des_hinted_demotion_matches_reference(predictor):
    assert_same(*run_both(HINTED, "sfs-aware", predictor))


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_des_dispatch_latency_matches_reference(dispatch):
    a, b, rtel, ptel = run_both(("cores=2",) * 4, dispatch, "history",
                                dispatch_latency=0.004)
    assert_same(a, b, rtel, ptel)
    assert b.spec.dispatch_latency == 0.004


@pytest.mark.parametrize("dispatch", ["least-outstanding", "sfs-aware"])
def test_des_lifecycle_and_scaling_match_reference(dispatch):
    a, b, rtel, ptel = run_both(
        ("cores=2",) * 4, dispatch, "history",
        lifecycle="lifecycle:cold=0.05,ttl=2,cap=2,fail=10,fail_server=1",
        scaling="scale:min=2,T=1,up=0.5,down=0.2,step=1")
    assert_same(a, b, rtel, ptel)
    c = ptel.trace.counts()
    assert c["fail"] == 1 and c["cold_start"] > 0 and c["scale"] > 0


@pytest.mark.parametrize("dispatch", ["hash", "sfs-aware"])
def test_des_faults_and_retry_match_reference(dispatch):
    wl = dict(n_requests=1000, cores=2, load=1.6, seed=7, n_functions=8)
    a, b, rtel, ptel = run_both(
        ("cores=2",) * 3, dispatch, "oracle", wl,
        lifecycle="lifecycle:cold=0.05",
        faults="faults:mttf=20,mttr=8,blast=2,episodes=4,seed=4,first=5",
        retry="retry:timeout=2,retries=2,backoff=0.5,shed=6")
    assert_same(a, b, rtel, ptel)
    assert b.timeouts > 0 and b.retries > 0 and b.shed > 0
    assert b.n + b.shed == 1000


def test_des_from_the_spec_workload_matches_reference():
    """No request list: both packages generate from the spec's
    FaaSBenchConfig, and telemetry changes nothing."""
    kw = dict(engine="des", servers=MIXED, dispatch="pull",
              predictor="class:margin=1.5,boundary=0.6")
    a = run_ref(RefSpec(**kw, workload=RefFaaS(**WL)))
    b = repro_torch.run_experiment(
        ExperimentSpec(**kw, workload=FaaSBenchConfig(**WL)), device="cpu")
    assert_same(a, b)
    c = repro_torch.run_experiment(
        ExperimentSpec(**kw, workload=FaaSBenchConfig(**WL)), device="cpu",
        telemetry=Telemetry(trace=True, series_cadence=1, profile=True))
    assert c.fingerprint() == b.fingerprint()
    assert c.telemetry.trace.counts()["complete"] == c.n


def _spec_pairs():
    faas = dict(n_requests=500, cores=8, load=1.1, seed=13, iat="trace",
                io_fraction=0.2, n_functions=16)
    tick = dict(n=100, load=0.8, seed=3)
    common = dict(servers=MIXED, dispatch="sfs-aware:O=2,N=50",
                  predictor="class:margin=1.5,boundary=0.6")
    return [
        (RefSpec(engine="des", workload=RefFaaS(**faas), **common),
         ExperimentSpec(engine="des", workload=FaaSBenchConfig(**faas),
                        **common)),
        (RefSpec(engine="des", dispatch_latency=0.002,
                 lifecycle="lifecycle:cold=0.05,ttl=2",
                 scaling="scale:min=2,T=2",
                 faults="faults:mttf=20,mttr=8,blast=2",
                 retry="retry:timeout=2,retries=1"),
         ExperimentSpec(engine="des", dispatch_latency=0.002,
                        lifecycle="lifecycle:cold=0.05,ttl=2",
                        scaling="scale:min=2,T=2",
                        faults="faults:mttf=20,mttr=8,blast=2",
                        retry="retry:timeout=2,retries=1")),
        (RefSpec(engine="vector", workload=RefTick(**tick), **common),
         ExperimentSpec(engine="vector", workload=TickWorkloadSpec(**tick),
                        **common)),
        (RefSpec(engine="tick", workload="bimodal:n=50|zipf:funcs=4"),
         ExperimentSpec(engine="tick", workload="bimodal:n=50|zipf:funcs=4")),
    ]


@pytest.mark.parametrize("case", range(4))
def test_to_json_equals_reference(case):
    ref_spec, spec = _spec_pairs()[case]
    d = spec.to_json()
    assert json.dumps(d) == json.dumps(ref_spec.to_json())
    back = ExperimentSpec.from_json(json.loads(json.dumps(d)))
    assert back == spec
    assert back.to_json() == d


def test_recorded_provenance_round_trips():
    """Every recorded provenance of an engine the port runs rebuilds
    through the port's ``from_json`` and gives back the same dict."""
    seen = {"des": 0, "tick": 0, "vector": 0}
    for name in ("BENCH_cluster.json", "BENCH_predict.json"):
        for row in json.loads((BASELINES / name).read_text())["rows"]:
            d = row.get("provenance", {}).get("spec")
            if d is None or d["engine"] not in seen:
                continue
            seen[d["engine"]] += 1
            spec = ExperimentSpec.from_json(d)
            assert json.loads(json.dumps(spec.to_json())) == d
            assert RefSpec.from_json(d).to_json() == spec.to_json()
    assert seen == {"des": 25, "tick": 16, "vector": 14}


@pytest.mark.parametrize("servers", [None, MIXED])
def test_cluster_sim_config_to_spec_round_trips(servers):
    kw = dict(n_servers=3, dispatch="sfs-aware", predictor="history",
              dispatch_latency_s=0.003, overload_factor=2.0,
              adaptive_window=40, slice_init_s=0.05,
              lifecycle="lifecycle:cold=0.05", retry="retry:timeout=2")
    if servers is None:
        cfg = ClusterSimConfig(server=SimConfig(cores=3, policy="cfs"), **kw)
        ref_cfg = RefCSC(server=RefSimConfig(cores=3, policy="cfs"), **kw)
    else:
        specs = [ServerSpec.parse(s) for s in servers]
        cfg = ClusterSimConfig(servers=[s.to_sim_config() for s in specs],
                               **kw)
        ref_cfg = RefCSC(servers=[RefSimConfig(**dataclasses.asdict(
            s.to_sim_config())) for s in specs], **kw)
    wl = FaaSBenchConfig(n_requests=300, cores=9, seed=2)
    spec = cfg.to_spec(workload=wl)
    assert spec.engine == "des"
    assert spec.to_json() == ref_cfg.to_spec(
        workload=RefFaaS(n_requests=300, cores=9, seed=2)).to_json()
    back = spec.to_cluster_sim_config()
    assert back.server_configs() == cfg.server_configs()
    assert (back.dispatch_latency_s, back.predictor) == \
        (cfg.dispatch_latency_s, spec.predictor)
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    reqs = generate(wl)
    assert simulate_cluster(reqs, cfg).merged.stats == \
        simulate_cluster(reqs, back).merged.stats


@pytest.mark.parametrize("dispatch", sorted(GOLDEN_HINTED))
def test_golden_hinted_digests(dispatch):
    g = GOLDEN_CFG
    reqs = generate(FaaSBenchConfig(n_requests=g["n"],
                                    cores=g["servers"] * g["cores"],
                                    load=g["load"], seed=g["seed"]))
    res = simulate_cluster(reqs, ClusterSimConfig(
        n_servers=g["servers"], dispatch=dispatch, predictor="oracle",
        server=SimConfig(cores=g["cores"], policy="sfs")))
    blob = repr([(s.rid, s.finish, s.n_ctx, s.demoted)
                 for s in res.merged.stats]).encode()
    assert hashlib.sha256(blob).hexdigest() == GOLDEN_HINTED[dispatch]


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorded_row(name, **match):
    rows = [r for r in json.loads((BASELINES / name).read_text())["rows"]
            if all(r.get(k) == v for k, v in match.items())]
    assert len(rows) == 1, match
    return rows[0]


def test_recorded_des_row_replays():
    """The uniform hash load-1.0 DES row of BENCH_cluster.json, rebuilt
    from its provenance: each seed's fingerprint equals the recorded one
    (for its seed in ``chip_smoke.DES_REDRAWN``, the reference's own on
    this host's workload, which must be the one it was taken on), and
    the pooled n and short/long p99 equal the row's, as
    benchmarks/run.py derives them."""
    cs = chip_smoke()
    label = "cluster uniform hash load=1.0"
    row = recorded_row("BENCH_cluster.json", layer="des",
                       scenario="uniform", policy="hash", load=1.0)
    prov = row["provenance"]
    base = ExperimentSpec.from_json(prov["spec"])
    ref_base = RefSpec.from_json(prov["spec"])
    svc, ta, rte = [], [], []
    for seed, want in zip(prov["seed"], prov["result_fp"]):
        spec = dataclasses.replace(
            base, workload=dataclasses.replace(base.workload, seed=seed))
        res = repro_torch.run_experiment(spec, device="cpu")
        if (label, seed) in cs.DES_REDRAWN:
            digest, want = cs.DES_REDRAWN[(label, seed)]
            assert cs.workload_digest(generate(spec.workload)) == digest
            ref = run_ref(dataclasses.replace(
                ref_base, workload=dataclasses.replace(ref_base.workload,
                                                       seed=seed)))
            assert ref.fingerprint()[:16] == want
        assert res.fingerprint()[:16] == want
        svc.append(res.service)
        ta.append(res.turnaround)
        rte.append(res.rte)
    b = bucket_stats(np.concatenate(svc), np.concatenate(ta),
                     np.concatenate(rte))
    keys = list(b)
    assert sum(len(x) for x in svc) == row["n"]
    assert (b[keys[0]]["p99"], b[keys[-1]]["p99"]) == \
        (row["short_p99"], row["long_p99"])


def test_redrawn_predict_seed():
    """The BENCH_predict.json seed of ``chip_smoke.DES_REDRAWN``: both
    packages draw the workload it names and give its fingerprint."""
    cs = chip_smoke()
    [(label, seed)] = [k for k in cs.DES_REDRAWN
                       if k[0].startswith("predict")]
    predictor, dispatch, load, iat = label.split()[1:]
    row = recorded_row("BENCH_predict.json", predictor=predictor,
                       dispatch=dispatch, load=float(load[5:]), iat=iat)
    prov = row["provenance"]
    digest, want = cs.DES_REDRAWN[(label, seed)]
    assert want != prov["result_fp"][prov["seed"].index(seed)]
    wl = ExperimentSpec.from_json(dict(prov["spec"],
                                       workload=prov["workload"])).workload
    reqs = generate(dataclasses.replace(wl, seed=seed))
    ref_reqs = ref_generate(RefFaaS(**dict(dataclasses.asdict(wl),
                                           seed=seed)))
    assert cs.workload_digest(reqs) == cs.workload_digest(ref_reqs) == digest
    got = repro_torch.run_experiment(ExperimentSpec.from_json(prov["spec"]),
                                     requests=reqs, device="cpu")
    ref = run_ref(RefSpec.from_json(prov["spec"]), requests=ref_reqs)
    assert got.fingerprint()[:16] == ref.fingerprint()[:16] == want


def test_one_server_hash_cluster_is_the_simulator():
    reqs = generate(FaaSBenchConfig(**WL))
    one = simulate(reqs, SimConfig(cores=8, policy="sfs"))
    clu = simulate_cluster(reqs, ClusterSimConfig(
        n_servers=1, dispatch="hash", server=SimConfig(cores=8)))
    assert clu.merged.stats == one.stats
    assert clu.merged.slice_timeline == one.slice_timeline


def test_des_refusals():
    with pytest.raises(ValueError, match="needs a FaaSBenchConfig"):
        repro_torch.run_experiment(ExperimentSpec(engine="des"),
                                   device="cpu")
    with pytest.raises(ValueError, match="DES-only"):
        ExperimentSpec(engine="vector", dispatch_latency=0.01)
    with pytest.raises(ValueError, match="no event loop"):
        simulate_cluster([], ClusterSimConfig(
            n_servers=2, server=SimConfig(policy="ideal")))


def test_des_resolves_the_device():
    """The DES places nothing on the device, but its entry point takes
    the card by default like every engine, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    spec = ExperimentSpec(engine="des", servers=("cores=2",),
                          workload=FaaSBenchConfig(n_requests=20, cores=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.run_experiment(spec)
    assert repro_torch.run_experiment(spec, device="cpu").n == 20
