"""The port's FaaSBench generator against the JAX package's on the CPU.

``repro_torch.core.workload`` is a copy of the reference's DES workload
module: the same config draws the same requests, field for field and
type for type, over poisson, uniform and trace arrivals, with and
without a per-function app model, I/O operations and spikes.  The
duration tables, ``function_table`` and ``offered_load`` must be equal
too.  Exact equality throughout.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import workload as ref  # noqa: E402
from repro_torch.core import workload as port  # noqa: E402


def request_tuple(r):
    return (r.rid, r.arrival, r.service, r.io_events, r.func_id)


def request_types(r):
    return tuple(type(v) for v in request_tuple(r)) + tuple(
        type(x) for ev in r.io_events for x in ev)


def assert_same_requests(a, b):
    assert len(a) == len(b)
    assert [request_tuple(r) for r in a] == [request_tuple(r) for r in b]
    assert [request_types(r) for r in a] == [request_types(r) for r in b]
    assert [r.total_io for r in a] == [r.total_io for r in b]
    assert [r.ideal_turnaround for r in a] == [r.ideal_turnaround
                                              for r in b]


@pytest.mark.parametrize("spikes", [5, 0])
@pytest.mark.parametrize("io_fraction", [0.0, 0.3])
@pytest.mark.parametrize("n_functions", [0, 48])
@pytest.mark.parametrize("iat", ["poisson", "uniform", "trace"])
def test_generate_matches_reference(iat, n_functions, io_fraction, spikes):
    kw = dict(n_requests=900, cores=12, load=0.9, iat=iat,
              io_fraction=io_fraction, n_functions=n_functions,
              n_spikes=spikes, spike_size=60, seed=3)
    a = ref.generate(ref.FaaSBenchConfig(**kw))
    b = port.generate(port.FaaSBenchConfig(**kw))
    assert_same_requests(a, b)
    assert ref.offered_load(a, 12) == port.offered_load(b, 12)


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_default_config_and_raw_tail_match_reference(seed):
    """The default config (10,000 requests, 12 cores) and the raw Azure
    tail table draw the same streams; the configs' fields are equal."""
    assert (dataclasses.asdict(port.FaaSBenchConfig())
            == dataclasses.asdict(ref.FaaSBenchConfig()))
    assert port.AZURE_TABLE_I == ref.AZURE_TABLE_I
    assert port.AZURE_TABLE_I_RAW_TAIL == ref.AZURE_TABLE_I_RAW_TAIL
    a = ref.generate(ref.FaaSBenchConfig(seed=seed))
    b = port.generate(port.FaaSBenchConfig(seed=seed))
    assert_same_requests(a, b)
    kw = dict(n_requests=500, cores=4, load=1.2, seed=seed,
              duration_table=ref.AZURE_TABLE_I_RAW_TAIL, iat="trace")
    assert_same_requests(ref.generate(ref.FaaSBenchConfig(**kw)),
                         port.generate(port.FaaSBenchConfig(**kw)))


@pytest.mark.parametrize("n_functions", [6, 7, 16, 48, 101])
def test_function_table_matches_reference(n_functions):
    want = ref.function_table(n_functions)
    got = port.function_table(n_functions)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_function_table_refuses_too_few_functions():
    for mod in (ref, port):
        with pytest.raises(ValueError, match="at least one function"):
            mod.function_table(5)


@pytest.mark.parametrize("n, n_spikes, size", [
    (100, 5, 30), (100, 3, 0), (10, 5, 20), (1000, 5, 120), (40, 9, 4)])
def test_spike_windows_match_reference(n, n_spikes, size):
    a = ref._spike_windows(np.random.default_rng(5), n, n_spikes, size)
    b = port._spike_windows(np.random.default_rng(5), n, n_spikes, size)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_offered_load_of_a_handmade_stream():
    reqs = [port.Request(rid=i, arrival=0.5 * i, service=0.25)
            for i in range(5)]
    refs = [ref.Request(rid=i, arrival=0.5 * i, service=0.25)
            for i in range(5)]
    assert port.offered_load(reqs, 2) == ref.offered_load(refs, 2) == 0.3125
    assert port.offered_load(reqs[:1], 2) == float("inf")


def test_unknown_iat_raises():
    with pytest.raises(ValueError, match="unknown iat kind"):
        port.generate(port.FaaSBenchConfig(n_requests=10, iat="burst"))


def test_the_des_request_is_not_the_serving_request():
    from repro_torch.serving.request import Request as ServingRequest
    assert port.Request is not ServingRequest
    r = port.Request(rid=1, arrival=0.1, service=0.2,
                     io_events=((0.0, 0.05),))
    with pytest.raises(dataclasses.FrozenInstanceError):
        r.service = 1.0
    assert r.total_io == 0.05 and r.ideal_turnaround == 0.2 + 0.05
