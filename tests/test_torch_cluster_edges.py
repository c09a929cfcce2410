"""Edges of the port's fleet backend, mirroring ``tests/test_jax_cluster.py``:
the unsupported-feature gates, empty ticks, the gap-advance and 64-tick
chunk fast paths (commit, overflow rollback, cooldown), device-region
growth, and the porting hazards of the tick body (no input written, int32
throughout, one device->host copy per tick).  The reference of every
comparison is the JAX package's ``JaxCluster`` on the same requests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.spec import ServerSpec as JaxServer  # noqa: E402
from repro.serving import ClusterConfig as JaxConfig  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving.jax_cluster import JaxCluster  # noqa: E402
import repro_torch.serving.torch_cluster as tc_mod  # noqa: E402
from repro_torch.core.spec import ServerSpec  # noqa: E402
from repro_torch.serving.cluster import ClusterConfig  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.torch_cluster import (_SCAN_CHUNK,  # noqa: E402
                                               TorchCluster)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The fleet's tick program is hundreds of tiny tensor ops: intra-op
    threads add nothing to it, and with several test workers on one
    machine their spin-waiting stalls every process ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fingerprint(reqs):
    return [(r.rid, r.finish, r.served_ticks, r.n_ctx, r.demoted,
             r.first_start, r.queue_delay, r.queue_enter, r.vruntime,
             r.slice_left, r.tokens_done, r.prefill_done, r.slot)
            for r in reqs]


def cluster(specs, policy="hash"):
    return TorchCluster([ServerSpec.parse(s) for s in specs],
                        ClusterConfig(policy=policy), device="cpu")


def jax_run(specs, policy, rows, max_ticks=200_000):
    """JaxCluster.run over the same (rid, arrival, n_tokens) rows."""
    jc = JaxCluster([JaxServer.parse(s) for s in specs],
                    JaxConfig(policy=policy))
    return jc.run([JaxRequest(rid=r, arrival=a, prompt_len=4, n_tokens=n)
                   for r, a, n in rows], max_ticks=max_ticks)


def requests(rows):
    return [Request(rid=r, arrival=a, prompt_len=4, n_tokens=n)
            for r, a, n in rows]


def per_tick_run(c, workload, max_ticks=200_000):
    """cluster.run() minus the multi-tick fast paths."""
    workload = sorted(workload, key=lambda r: r.arrival)
    i, n = 0, len(workload)
    while c._finished_count() < n:
        assert c.t <= max_ticks, "per-tick reference ran away"
        arrivals = []
        while i < n and workload[i].arrival <= c.t:
            arrivals.append(workload[i])
            i += 1
        c.tick(arrivals)
    return sorted(c._collect(), key=lambda r: r.rid)


# ---------------------------------------------------------------------------
# Grouping and the unsupported-feature gates
# ---------------------------------------------------------------------------


def test_homogeneous_servers_form_one_group():
    s = cluster(["cores=4"] * 8).summary()
    assert s["backend"] == "torch" and s["device"] == "cpu"
    assert len(s["groups"]) == 1
    assert s["groups"][0]["members"] == list(range(8))


def test_unvectorizable_scheduler_raises():
    with pytest.raises(ValueError, match="torch fleet backend"):
        cluster(["cores=4;scheduler=srtf"])


def test_object_pinned_server_raises():
    """The port has no per-object engines, so a server string pinned to
    one does not parse."""
    with pytest.raises(ValueError, match="unknown server field 'engine'"):
        cluster(["cores=4;engine=object"])


def test_stall_events_rejected_at_submit():
    c = cluster(["cores=2"])
    req = Request(rid=0, arrival=0, prompt_len=4, n_tokens=5,
                  stall_events=((2, 3),))
    with pytest.raises(ValueError, match="stall events"):
        c.tick([req])


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchCluster([ServerSpec(cores=2)])


# ---------------------------------------------------------------------------
# Empty ticks and the event-skip (gap advance) fast path
# ---------------------------------------------------------------------------


def test_empty_ticks_are_inert():
    c = cluster(["cores=2;slots=8"] * 3)
    for _ in range(50):
        c.tick(())
    assert c.t == 50
    assert c._finished_count() == 0
    g = c.groups[0]
    assert g.filter_count.sum() == 0 and g.cfs_count.sum() == 0
    assert g.outstanding.sum() == 0
    assert (g.free_slots == 8).all()
    c.tick([Request(rid=0, arrival=c.t, prompt_len=4, n_tokens=3)])
    for _ in range(10):
        c.tick(())
    assert c._finished_count() == 1


def sparse_rows():
    """Arrival gaps far wider than any service demand."""
    rng = np.random.default_rng(41)
    out = []
    for i in range(6):
        ntok = int(rng.integers(2, 8) if rng.random() < 0.7
                   else rng.integers(30, 60))
        out.append((i, i * 120, ntok))
    return out


@pytest.mark.parametrize("policy", ["least-outstanding", "sfs-aware"])
def test_fast_paths_match_per_tick_stepping(policy):
    specs = ["cores=2"] * 3
    fired = []

    class Spy(TorchCluster):
        def _fast_forward(self, window):
            took = super()._fast_forward(window)
            fired.append(took)
            return took

    fast = Spy([ServerSpec.parse(s) for s in specs],
               ClusterConfig(policy=policy), device="cpu")
    got = fast.run(requests(sparse_rows()), max_ticks=200_000)
    ref = cluster(specs, policy)
    want = per_tick_run(ref, requests(sparse_rows()))
    assert any(fired), "sparse workload never engaged a fast path"
    assert fingerprint(got) == fingerprint(want)
    assert fingerprint(got) == fingerprint(jax_run(specs, policy,
                                                   sparse_rows()))
    n = len(ref.tick_log)
    assert fast.t - ref.t < _SCAN_CHUNK
    assert fast.tick_log[:n] == ref.tick_log
    assert all(c == (0,) * len(specs) for _, _, c in fast.tick_log[n:])


def test_gap_advance_skips_pure_drain():
    c = cluster(["cores=2"])
    steps = []
    g = c.groups[0]
    orig = g.step_tick

    def counting(t):
        steps.append(t)
        return orig(t)

    g.step_tick = counting
    done = c.run([Request(rid=0, arrival=0, prompt_len=4, n_tokens=400)],
                 max_ticks=10_000)
    assert len(done) == 1 and done[0].finish is not None
    assert c.t >= 400
    assert len(steps) < 50


# ---------------------------------------------------------------------------
# 64-tick chunks: commit, overflow, cooldown
# ---------------------------------------------------------------------------


def burst_rows():
    """16 identical long requests at t=0: pools rotate (chunk territory)
    and completions land in same-tick bursts (overflow territory)."""
    return [(i, 0, 90) for i in range(16)]


def test_scan_chunks_commit_and_match_jax():
    specs = ["cores=2"] * 4
    committed = []

    class Spy(TorchCluster):
        def _scan_window(self):
            took = super()._scan_window()
            committed.append(took)
            return took

    c = Spy([ServerSpec.parse(s) for s in specs],
            ClusterConfig(policy="least-outstanding"), device="cpu")
    got = c.run(requests(burst_rows()), max_ticks=50_000)
    assert any(committed), "burst drain never committed a chunk"
    assert fingerprint(got) == fingerprint(
        jax_run(specs, "least-outstanding", burst_rows(), 50_000))


def test_scan_overflow_cooldown_still_exact(monkeypatch):
    """A blown per-tick event buffer rolls the whole chunk back and
    replays it per tick — a one-event buffer makes every burst overflow,
    and the run must still equal the reference."""
    specs = ["cores=2"] * 4
    monkeypatch.setattr(tc_mod, "_scan_evcap", lambda G, L, sfs: 1)
    c = cluster(specs, "least-outstanding")
    got = c.run(requests(burst_rows()), max_ticks=50_000)
    assert c._scan_cooldown > 0, "no overflow with a 1-event buffer"
    assert fingerprint(got) == fingerprint(
        jax_run(specs, "least-outstanding", burst_rows(), 50_000))


def test_scan_evcap_sizing():
    assert tc_mod._scan_evcap(4, 2, False) == 8
    assert tc_mod._scan_evcap(4, 2, True) == 16
    assert tc_mod._scan_evcap(1024, 8, True) == tc_mod._SCAN_EVCAP_MAX
    assert _SCAN_CHUNK <= tc_mod._SCAN_EVCAP_MAX


# ---------------------------------------------------------------------------
# Device-region growth (queue ring / pool / arrival buffer)
# ---------------------------------------------------------------------------


def flood_rows():
    rng = np.random.default_rng(13)
    return [(i, 0, int(rng.integers(2, 30))) for i in range(300)]


def test_region_growth_under_single_tick_flood():
    """300 simultaneous arrivals on one 4-lane engine blow all three
    device regions past their initial sizes in the first step."""
    specs = ["cores=4;slots=2048"]
    c = cluster(specs, "hash")
    g = c.groups[0]
    qcap0, cap0, acap0 = g.QCAP, g.CAP, g.ACAP
    got = c.run(requests(flood_rows()), max_ticks=200_000)
    assert g.QCAP > qcap0 and g.CAP > cap0 and g.ACAP > acap0
    assert fingerprint(got) == fingerprint(jax_run(specs, "hash",
                                                   flood_rows()))


# ---------------------------------------------------------------------------
# Porting hazards of the tick body
# ---------------------------------------------------------------------------


def busy_cluster():
    """A 3-engine sfs group mid-run: queues, lanes and pools all hold
    requests, some pools smaller than the lane count."""
    c = cluster(["cores=4"] * 3, "least-outstanding")
    rng = np.random.default_rng(2)
    rows = [(i, i // 4, int(rng.integers(2, 60))) for i in range(40)]
    reqs = requests(rows)
    for t in range(12):
        c.tick([r for r in reqs if r.arrival == t])
    return c


def test_tick_body_writes_no_input():
    """The chunk's rollback needs the pre-chunk state intact: the tick
    body and the gap advance return new tensors and leave their inputs
    as they were."""
    g = busy_cluster().groups[0]
    before = {k: v.clone() for k, v in g._state.items()}
    S, thr = g._dev_i32(g.S, g._thr32())
    for t in range(3):
        tc_mod._tick_core(g.G, g.lanes, g.QCAP, g.CAP, True,
                          tc_mod._scan_evcap(g.G, g.lanes, True), True,
                          g._state, g._arr0, 12 + t, S, thr)
        tc_mod._advance_core(g.G, g.lanes, g.CAP, True, g._state, 5, 12)
    for k, v in g._state.items():
        assert torch.equal(v, before[k]), k


def test_state_stays_int32():
    g = busy_cluster().groups[0]
    assert {v.dtype for v in g._state.values()} == {torch.int32}
    state, out = tc_mod._tick_core(
        g.G, g.lanes, g.QCAP, g.CAP, True, 2 * g.G * g.lanes, False,
        g._state, g._arr0, 12, *g._dev_i32(g.S, g._thr32()))
    assert {v.dtype for v in state.values()} == {torch.int32}
    assert out["head"].dtype == torch.int32
    assert out["events"].dtype == torch.int32


def test_one_host_copy_per_tick(monkeypatch):
    """Each step pulls its scalars and mirrors in one copy, and the
    events only on ticks that have any."""
    c = busy_cluster()
    g = c.groups[0]
    pulls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        pulls.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    for t in range(c.t, c.t + 30):
        pulls.clear()
        n_done = c._finished_count()
        c.tick(())
        events = c._finished_count() - n_done
        assert len(pulls) == (2 if events else 1), (t, pulls)
        assert pulls[0] == (2 + 5 * g.G,)
