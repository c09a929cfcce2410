"""A model of how ``csrc/group_pick.cu``'s register variant
(``group_pick_reg_kernel<KPL>``, CAP <= 256) computes a round, held equal
to the port's plain version, to the JAX package's ``pick_order_argmin``
and to its Pallas kernel in interpret mode.

The kernel keeps a row in one warp: lane ``l`` holds the keys of positions
``l + 32 j`` for ``j < KPL`` with a taken bit each, and a round is three
masked minima, each a minimum over the lane's own registers followed by
one warp-wide minimum (``redux.sync``): min vruntime; min rid among the
slots at that vruntime, taken ones included; least position among the
untaken slots at both (CAP when none).  Lane ``i % 32`` keeps round i's
winner.  ``lanes_model`` follows those steps on numpy arrays shaped
``[G, KPL, 32]``.  The card checks the kernel itself (``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.group_pick.kernel import pick_order_pallas  # noqa: E402
from repro.kernels.group_pick.ref import pick_order_argmin  # noqa: E402
from repro_torch.kernels.group_pick.ref import IMAX, pick_order_ref  # noqa: E402


def keys_per_lane(cap: int) -> int:
    """KPL of the variant the entry point picks for ``cap`` <= 256."""
    return next(k for k in (1, 2, 4, 8) if cap <= 32 * k)


def lanes_model(vr: np.ndarray, rid: np.ndarray, kmax: int) -> np.ndarray:
    G, cap = vr.shape
    kpl = keys_per_lane(cap)
    width = 32 * kpl
    pos = np.arange(width).reshape(kpl, 32)           # [j, lane]
    v = np.full((G, width), IMAX, np.int64)
    r = np.full((G, width), IMAX, np.int64)
    v[:, :cap], r[:, :cap] = vr, rid
    v, r = v.reshape(G, kpl, 32), r.reshape(G, kpl, 32)
    avail = np.broadcast_to(pos < cap, v.shape).copy()
    out = np.empty((G, kmax), np.int32)
    rows = np.arange(G)
    for i in range(kmax):
        m1 = v.min(axis=1).min(axis=1)                # lanes, then the warp
        tie = v == m1[:, None, None]
        m2 = np.where(tie, r, IMAX).min(axis=1).min(axis=1)
        win = tie & (r == m2[:, None, None]) & avail
        p = np.where(win, pos, cap).min(axis=1).min(axis=1)
        out[:, i] = p
        hit = p < cap
        j, lane = p[hit] // 32, p[hit] % 32
        v[rows[hit], j, lane] = IMAX
        avail[rows[hit], j, lane] = False
    return out


def pick_rows(seed: int, G: int, cap: int, kmax: int):
    """Heavy vruntime ties, unique rids, ~30% sentinel slots, an empty
    row, and rows with fewer valid keys than kmax (the run-out tail)."""
    rng = np.random.default_rng(seed)
    vr = rng.integers(0, 6, (G, cap)).astype(np.int32)
    rid = rng.permutation(G * cap).reshape(G, cap).astype(np.int32)
    hole = rng.random((G, cap)) < 0.3
    hole[0] = True
    for g in (1, 2):
        hole[g] = True
        keep = rng.choice(cap, size=min(cap, max(1, kmax // (g + 1))),
                          replace=False)
        hole[g, keep] = False
    vr[hole] = IMAX
    rid[hole] = IMAX
    return vr, rid


CASES = [(cap, kmax) for cap in (5, 32, 33, 64, 100, 256)
         for kmax in (1, 8, 40)]


@pytest.mark.parametrize("cap,kmax", CASES)
def test_lanes_model_equals_plain_argmin_and_pallas(cap, kmax):
    G = 8
    vr, rid = pick_rows(cap * 7 + kmax, G, cap, kmax)
    got = lanes_model(vr, rid, kmax)
    plain = pick_order_ref(torch.from_numpy(vr), torch.from_numpy(rid),
                           kmax).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(
        got, np.asarray(pick_order_argmin(jnp.asarray(vr), jnp.asarray(rid),
                                          kmax)))
    np.testing.assert_array_equal(
        got, np.asarray(pick_order_pallas(jnp.asarray(vr), jnp.asarray(rid),
                                          kmax, interpret=True)))


def test_lanes_model_run_out_tail_is_cap():
    """Two valid keys, kmax 4: the reference's [0, 3, CAP, CAP]; an empty
    row's sentinels come in position order."""
    cap = 40
    vr = np.full((2, cap), IMAX, np.int32)
    rid = np.full((2, cap), IMAX, np.int32)
    vr[0, [0, 35]] = [1, 2]
    rid[0, [0, 35]] = [10, 11]
    np.testing.assert_array_equal(lanes_model(vr, rid, 4),
                                  [[0, 35, cap, cap], [0, 1, 2, 3]])
