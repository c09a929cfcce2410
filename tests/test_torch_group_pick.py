"""The port's group pick (``repro_torch.kernels.group_pick``) against the
JAX package's: the plain PyTorch version equals ``pick_order_argmin`` and
the Pallas kernel in interpret mode integer for integer, the ``CAP`` tail
included, and equals the stable-argsort ``pick_order_ref`` on the first
``min(kmax, valid keys)`` columns.  The CUDA kernel itself is held to the
plain version on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.group_pick.kernel import pick_order_pallas  # noqa: E402
from repro.kernels.group_pick.ref import (pick_order_argmin,  # noqa: E402
                                          pick_order_ref)
from repro_torch.kernels.group_pick import kernel as gk  # noqa: E402
from repro_torch.kernels.group_pick import ops  # noqa: E402
from repro_torch.kernels.group_pick.ref import (IMAX,  # noqa: E402
                                                pick_order_ref as torch_ref)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The fleet's tick program is hundreds of tiny tensor ops: intra-op
    threads add nothing to it, and with several test workers on one
    machine their spin-waiting stalls every process ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pick_case(seed: int, G: int, cap: int, kmax: int):
    """Keys like the tick body's (``tests/test_jax_cluster.py``): heavy
    vruntime ties, unique rids, ~30% sentinel slots, one empty row, and
    one row with fewer valid keys than ``kmax``."""
    rng = np.random.default_rng(seed)
    vr = rng.integers(0, 6, (G, cap)).astype(np.int32)
    rid = rng.permutation(G * cap).reshape(G, cap).astype(np.int32)
    hole = rng.random((G, cap)) < 0.3
    hole[0] = True
    hole[1] = True
    hole[1, rng.choice(cap, size=max(1, kmax // 2), replace=False)] = False
    vr[hole] = IMAX
    rid[hole] = IMAX
    return vr, rid


def port(vr, rid, kmax):
    return ops.pick_order(torch.from_numpy(vr), torch.from_numpy(rid),
                          kmax).numpy()


CASES = [(G, cap, kmax) for G, cap in ((8, 16), (5, 33), (3, 64))
         for kmax in (1, 4, 8)]


@pytest.mark.parametrize("G,cap,kmax", CASES)
def test_plain_pick_equals_argmin_and_pallas(G, cap, kmax):
    vr, rid = pick_case(3 + cap + kmax, G, cap, kmax)
    got = port(vr, rid, kmax)
    assert got.dtype == np.int32 and got.shape == (G, kmax)
    want = np.asarray(pick_order_argmin(jnp.asarray(vr), jnp.asarray(rid),
                                        kmax))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(pick_order_pallas(jnp.asarray(vr), jnp.asarray(rid),
                                          kmax, gb=1, interpret=True))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("G,cap,kmax", CASES)
def test_plain_pick_equals_argsort_on_valid_columns(G, cap, kmax):
    vr, rid = pick_case(7 + cap + kmax, G, cap, kmax)
    got = port(vr, rid, kmax)
    want = np.asarray(pick_order_ref(jnp.asarray(vr), jnp.asarray(rid),
                                     kmax))
    valid = (vr < IMAX).sum(axis=1)
    for g in range(G):
        m = min(kmax, int(valid[g]))
        np.testing.assert_array_equal(got[g, :m], want[g, :m])


def test_run_out_tail_is_cap():
    """Two valid keys, kmax=4: the reference kernel and argmin give
    [0, 3, CAP, CAP] where the argsort gives [0, 3, 1, 2]; the port
    matches the kernel."""
    cap = 8
    vr = np.full((1, cap), IMAX, np.int32)
    rid = np.full((1, cap), IMAX, np.int32)
    vr[0, [0, 3]] = [1, 2]
    rid[0, [0, 3]] = [10, 11]
    got = port(vr, rid, 4)
    np.testing.assert_array_equal(got, [[0, 3, cap, cap]])
    np.testing.assert_array_equal(
        got, np.asarray(pick_order_pallas(jnp.asarray(vr), jnp.asarray(rid),
                                          4, interpret=True)))
    np.testing.assert_array_equal(
        np.asarray(pick_order_ref(jnp.asarray(vr), jnp.asarray(rid), 4)),
        [[0, 3, 1, 2]])


def test_cpu_tensors_never_launch_and_wrapper_refuses_them():
    vr, rid = pick_case(1, 4, 16, 4)
    gk.launches = 0
    port(vr, rid, 4)
    assert gk.launches == 0
    with pytest.raises(ValueError, match="CUDA device"):
        gk.pick_order_cuda(torch.from_numpy(vr), torch.from_numpy(rid), 4)


def test_shape_checks():
    a = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="one shape"):
        torch_ref(a, torch.zeros(2, 5, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="kmax"):
        torch_ref(a, a, -1)
    assert torch_ref(a, a, 0).shape == (2, 0)

