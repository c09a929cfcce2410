"""The port's fleet backend (``repro_torch.run_experiment``,
``TorchCluster``) against the JAX package's ``engine="jax"``, field for
field, on shared seeds — the counterpart of the jax-vs-vector agreement
in ``tests/test_agreement.py``.  Both run on the CPU; the torch side takes
the plain group pick there."""
import pytest

torch = pytest.importorskip("torch")

from repro.core.spec import ExperimentSpec as JaxSpec  # noqa: E402
from repro.core.spec import ServerSpec as JaxServer  # noqa: E402
from repro.core.spec import TickWorkloadSpec as JaxWorkload  # noqa: E402
from repro.core.spec import run_experiment as run_jax  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.spec import TickWorkloadSpec  # noqa: E402


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


def run_both(servers, dispatch, predictor, n, load, seed):
    """(jax result, torch result) of one spec on one seed."""
    jx = run_jax(JaxSpec(
        engine="jax", servers=tuple(JaxServer.parse(s) for s in servers),
        dispatch=dispatch, predictor=predictor,
        workload=JaxWorkload(n=n, load=load, seed=seed)),
        max_ticks=2_000_000)
    tt = repro_torch.run_experiment(repro_torch.ExperimentSpec(
        servers=servers, dispatch=dispatch, predictor=predictor,
        workload=TickWorkloadSpec(n=n, load=load, seed=seed)),
        max_ticks=2_000_000, device="cpu")
    return jx, tt


def assert_equal_runs(jx, tt):
    assert full_fingerprint(jx.raw) == full_fingerprint(tt.raw)
    assert jx.dispatch_counts == tt.dispatch_counts
    assert jx.eta_log == tt.eta_log
    assert jx.overload_bypasses == tt.overload_bypasses
    assert jx.fingerprint() == tt.fingerprint()
    assert (jx.shed, jx.timeouts, jx.retries) == (tt.shed, tt.timeouts,
                                                  tt.retries)


@pytest.mark.parametrize("n_engines", [4, 64])
@pytest.mark.parametrize("dispatch", ["hash", "least-outstanding", "pull",
                                      "sfs-aware"])
def test_torch_backend_bit_exact_vs_jax(n_engines, dispatch):
    """Includes the learned-predictor feedback loop: completions must
    replay in the reference's order or the history predictor's
    observation stream (and every later dispatch) diverges."""
    servers = ("cores=4",) * n_engines
    jx, tt = run_both(servers, dispatch, "history", 250, 1.0, 23)
    assert tt.engine == "torch" and tt.n == 250
    assert_equal_runs(jx, tt)


def test_torch_backend_bit_exact_on_cfs_group():
    """Pure-CFS groups take the sfs=False tick body (no FILTER event
    lanes, single event grid)."""
    servers = ("cores=4;scheduler=cfs",) * 8
    jx, tt = run_both(servers, "least-outstanding", "oracle", 300, 1.0, 17)
    assert_equal_runs(jx, tt)


def test_torch_backend_bit_exact_on_mixed_groups():
    """Several groups of different shapes in one cluster (two sfs shapes
    plus cfs servers), each stepped by its own tick program."""
    servers = ("cores=6", "cores=6", "cores=4", "cores=2;scheduler=cfs",
               "cores=2;scheduler=cfs")
    jx, tt = run_both(servers, "sfs-aware", "oracle", 150, 1.0, 11)
    assert_equal_runs(jx, tt)
