"""The telemetry and result API tail of the port against the JAX
package's: ``TraceRecorder.by_rid`` and ``chrome_events``,
``save_chrome_trace``'s file, ``FleetSeries.to_dict``,
``HostProfile.format``'s phase names and ``ExperimentResult.summary()``
(apart from ``wall_s``).  Each engine runs one spec in both packages
with every collector on: the reference's ``jax`` against the port's
``torch`` (on the CPU), and ``tick``, ``vector`` and ``des`` against
themselves."""
import json

import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core.telemetry import Telemetry as RefTelemetry  # noqa: E402
from repro.core.telemetry import \
    save_chrome_trace as ref_save_chrome_trace  # noqa: E402
from repro.core.workload import FaaSBenchConfig as RefFaaS  # noqa: E402
from repro_torch.core.telemetry import (HostProfile, Telemetry,  # noqa: E402
                                        save_chrome_trace)
from repro_torch.core.workload import FaaSBenchConfig  # noqa: E402

# port engine -> the reference's engine of the same semantics
ENGINES = {"torch": "jax", "tick": "tick", "vector": "vector", "des": "des"}
PHASE = {"jax": "torch"}          # the fleet backend's phase-name prefix


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec_kw(engine: str, pkg) -> dict:
    if engine == "des":
        faas = RefFaaS if pkg is repro else FaaSBenchConfig
        return dict(engine="des", servers=("cores=4",) * 3,
                    dispatch="sfs-aware", predictor="history",
                    workload=faas(n_requests=300, cores=12, load=0.9,
                                  seed=5))
    return dict(engine=engine, servers=("cores=4",) * 8,
                dispatch="sfs-aware", predictor="history",
                workload=pkg.TickWorkloadSpec(n=300, load=1.0, seed=23))


@pytest.fixture(scope="module", params=sorted(ENGINES))
def runs(request):
    """(reference result, port result) of one engine's spec, traced,
    sampled and profiled."""
    engine = request.param
    cadence = 0.5 if engine == "des" else 20
    rtel = RefTelemetry(trace=True, series_cadence=cadence, profile=True)
    ref = repro.run_experiment(
        repro.ExperimentSpec(**spec_kw(ENGINES[engine], repro)),
        telemetry=rtel)
    ptel = Telemetry(trace=True, series_cadence=cadence, profile=True)
    port = repro_torch.run_experiment(
        repro_torch.ExperimentSpec(**spec_kw(engine, repro_torch)),
        telemetry=ptel, device="cpu")
    assert ref.fingerprint() == port.fingerprint()
    return ref, port


def test_by_rid_matches_reference(runs):
    ref, port = runs
    rt, pt = ref.telemetry.trace, port.telemetry.trace
    assert pt.canonical() == rt.canonical()
    for rid in list(range(16)) + [int(port.rids[-1]), -1]:
        assert pt.by_rid(rid) == rt.by_rid(rid), rid
    assert [e[1] for e in pt.by_rid(0)][:2] == ["arrival", "dispatch"]


def test_chrome_events_and_saved_trace_match_reference(runs, tmp_path):
    ref, port = runs
    rt, pt = ref.telemetry.trace, port.telemetry.trace
    for kw in ({}, dict(pid=3, label="sfs-aware", scale=1000.0)):
        assert pt.chrome_events(**kw) == rt.chrome_events(**kw)
    paths = {}
    for name, save, tr in (("ref", ref_save_chrome_trace, rt),
                           ("port", save_chrome_trace, pt)):
        paths[name] = save(str(tmp_path / f"{name}.json"),
                           {"sfs-aware": tr, "again": tr})
    text = {k: open(p).read() for k, p in paths.items()}
    assert text["port"] == text["ref"]
    body = json.loads(text["port"])
    assert body["displayTimeUnit"] == "ms"
    assert {e["pid"] for e in body["traceEvents"]} == {0, 1}


def test_series_to_dict_matches_reference(runs):
    ref, port = runs
    got, want = port.telemetry.series.to_dict(), ref.telemetry.series.to_dict()
    assert got["samples"], "no samples taken"
    assert got == want


def test_profile_format_names_the_reference_phases(runs):
    ref, port = runs

    def names(prof):
        return sorted(line.split()[0] for line in prof.format().splitlines())
    want = names(ref.telemetry.profile)
    if ref.engine in PHASE:
        want = sorted(n.replace(ref.engine + "_", PHASE[ref.engine] + "_")
                      for n in want)
    assert names(port.telemetry.profile) == want
    assert HostProfile().format() == "  (no phases recorded)"


def test_summary_matches_reference_but_wall(runs):
    ref, port = runs
    got, want = port.summary(), ref.summary()
    assert got.pop("wall_s") >= 0 and want.pop("wall_s") >= 0
    want["engine"] = {"jax": "torch"}.get(want["engine"], want["engine"])
    assert got == want
