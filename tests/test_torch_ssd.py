"""The port's SSD step on the CPU: the plain version of the ``ssd_scan``
kernel against the JAX package's Pallas kernel (interpret mode), and the
port's ``ssd_chunked`` against the reference's ``ssd_chunked`` and its
sequential ``ssd_reference``.

The same numpy inputs go to both packages.  Tolerances are the
reference's: tests/test_kernels.py for the intra-chunk step (float32
atol 3e-5 / rtol 3e-4, bfloat16 3e-2), tests/test_models.py for the
chunked scan (atol 1e-4 / rtol 1e-3).  The CUDA kernel itself runs only on
a card (``python3 chip_smoke.py``); here the dispatcher must take the
plain version for CPU tensors and the launch wrapper must refuse them.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_intra_chunk_pallas  # noqa: E402
from repro.models import mamba2 as RM  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref  # noqa: E402
from repro_torch.models import mamba2 as PM  # noqa: E402

SSD_CASES = [
    # (b, nc, Q, H, P, N), as in tests/test_kernels.py
    (1, 2, 16, 8, 8, 16),
    (2, 3, 32, 16, 8, 16),
    (1, 4, 64, 8, 4, 32),
]
TOL = {"float32": dict(atol=3e-5, rtol=3e-4),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
SCAN_TOL = dict(atol=1e-4, rtol=1e-3)


def softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def intra_inputs(case, seed, decay=1.0):
    """xc, dtc, cum, tot, Bc, Cc as numpy float32, shaped as the kernel
    takes them; ``decay`` scales the per-step log decay."""
    b, nc, Q, H, P, N = case
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((b, nc, Q, H, P), np.float32)
    dtc = softplus(rng.standard_normal((b, nc, Q, H), np.float32))
    la = -decay * softplus(rng.standard_normal((b, nc, Q, H), np.float32))
    cum = np.cumsum(la, axis=2, dtype=np.float32)
    tot = np.ascontiguousarray(cum[:, :, -1, :])
    Bc = 0.5 * rng.standard_normal((b, nc, Q, 1, N), np.float32)
    Cc = 0.5 * rng.standard_normal((b, nc, Q, 1, N), np.float32)
    return xc, dtc, cum, tot, Bc, Cc


def pallas(xc, dtc, cum, tot, Bc, Cc, x_dtype=jnp.float32):
    H = xc.shape[3]
    hb = 8 if H % 8 == 0 else (4 if H % 4 == 0 else 1)
    y, s = ssd_intra_chunk_pallas(jnp.asarray(xc, x_dtype), jnp.asarray(dtc),
                                  jnp.asarray(cum), jnp.asarray(tot),
                                  jnp.asarray(Bc), jnp.asarray(Cc), hb=hb)
    return np.asarray(y), np.asarray(s)


def plain(xc, dtc, cum, tot, Bc, Cc, x_dtype=torch.float32):
    t = [torch.from_numpy(a) for a in (xc, dtc, cum, tot, Bc, Cc)]
    t[0] = t[0].to(x_dtype)
    y, s = ssd_intra_chunk_ref(*t)
    return y.numpy(), s.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_matches_pallas(case, dtype):
    args = intra_inputs(case, seed=sum(case))
    y1, s1 = pallas(*args, x_dtype=getattr(jnp, dtype))
    y2, s2 = plain(*args, x_dtype=getattr(torch, dtype))
    assert y2.dtype == np.float32 and s2.dtype == np.float32
    np.testing.assert_allclose(y2, y1, **TOL[dtype])
    np.testing.assert_allclose(s2, s1, **TOL[dtype])


def test_ssd_plain_strong_decay_gives_no_nan():
    """cum falls by ~100 a step: above the diagonal exp(cum_l - cum_m)
    would overflow to inf (and inf * 0 is NaN) unless it is masked before
    the exponential."""
    args = intra_inputs((1, 2, 32, 8, 8, 16), seed=3, decay=100.0)
    assert args[2].min() < -1000
    y2, s2 = plain(*args)
    assert np.isfinite(y2).all() and np.isfinite(s2).all()
    y1, s1 = pallas(*args)
    np.testing.assert_allclose(y2, y1, **TOL["float32"])
    np.testing.assert_allclose(s2, s1, **TOL["float32"])


def test_ssd_plain_dt_zero_steps_add_exactly_nothing():
    """The padded tail of a ragged sequence (dt = 0) leaves y and the
    states bit for bit as they are, whatever x holds there."""
    xc, dtc, cum, tot, Bc, Cc = intra_inputs((2, 2, 16, 8, 8, 16), seed=4)
    dtc[:, :, 11:] = 0.0
    y1, s1 = plain(xc, dtc, cum, tot, Bc, Cc)
    xz = xc.copy()
    xz[:, :, 11:] = 0.0
    y2, s2 = plain(xz, dtc, cum, tot, Bc, Cc)
    np.testing.assert_array_equal(y1, y2)
    np.testing.assert_array_equal(s1, s2)


SCAN_CASES = [
    # (b, S, H, P, N, Q), as in tests/test_models.py (incl. ragged S % Q)
    (1, 32, 2, 4, 8, 8),
    (2, 48, 4, 8, 16, 16),
    (1, 40, 8, 8, 4, 16),
]


def scan_inputs(case, seed, with_h0):
    b, S, H, P, N, Q = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P), np.float32)
    dt = softplus(rng.standard_normal((b, S, H), np.float32))
    A = -np.exp(rng.standard_normal(H).astype(np.float32))
    B = 0.5 * rng.standard_normal((b, S, 1, N), np.float32)
    C = 0.5 * rng.standard_normal((b, S, 1, N), np.float32)
    h0 = (rng.standard_normal((b, H, P, N), np.float32) if with_h0
          else None)
    return (x, dt, A, B, C), h0


@functools.lru_cache(maxsize=None)
def reference_scans(case, with_h0):
    """The reference's chunked scan and sequential oracle (jitted) on
    ``scan_inputs(case, ...)``, as numpy: ((y, h), (y, h))."""
    args, h0 = scan_inputs(case, seed=sum(case) + with_h0, with_h0=with_h0)
    jargs = [jnp.asarray(a) for a in args]
    jh0 = None if h0 is None else jnp.asarray(h0)
    chunked = jax.jit(RM.ssd_chunked, static_argnames=("Q", "impl"))
    out = (chunked(*jargs, Q=case[-1], h0=jh0),
           jax.jit(RM.ssd_reference)(*jargs, h0=jh0))
    return tuple(tuple(np.asarray(a) for a in pair) for pair in out)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_ssd_chunked_matches_reference(case, impl):
    """``impl="kernel"`` takes the kernel's plain version on the CPU; both
    equal the reference's chunked scan and its sequential oracle, from a
    zero and from a given initial state."""
    for with_h0 in (False, True):
        args, h0 = scan_inputs(case, seed=sum(case) + with_h0,
                               with_h0=with_h0)
        y, h = PM.ssd_chunked(*[torch.from_numpy(a) for a in args],
                              Q=case[-1],
                              h0=None if h0 is None else torch.from_numpy(h0),
                              impl=impl)
        for want_y, want_h in reference_scans(case, with_h0):
            assert y.shape == want_y.shape and h.shape == want_h.shape
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                       **SCAN_TOL)
            np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                                       **SCAN_TOL)


def test_ssd_reference_matches_reference():
    args, h0 = scan_inputs((2, 20, 4, 8, 16, 8), seed=7, with_h0=True)
    y_r, h_r = jax.jit(RM.ssd_reference)(*[jnp.asarray(a) for a in args],
                                         h0=jnp.asarray(h0))
    y, h = PM.ssd_reference(*[torch.from_numpy(a) for a in args],
                            h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **SCAN_TOL)


def test_ssd_chunked_bfloat16_keeps_dtypes():
    """y comes back in x's dtype, the final state in float32."""
    args, _ = scan_inputs((1, 24, 4, 8, 16, 16), seed=8, with_h0=False)
    t = [torch.from_numpy(a) for a in args]
    t[0] = t[0].bfloat16()
    y, h = PM.ssd_chunked(*t, Q=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y_c, h_c = jax.jit(RM.ssd_chunked, static_argnames=("Q",))(
        jnp.asarray(args[0], jnp.bfloat16),
        *[jnp.asarray(a) for a in args[1:]], Q=16)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_c, np.float32), **TOL["bfloat16"])
    np.testing.assert_allclose(h.numpy(), np.asarray(h_c), **SCAN_TOL)


def test_ops_take_plain_version_on_cpu_without_launching():
    ssd_kernel.launches = 0
    t = [torch.from_numpy(a) for a in intra_inputs((1, 1, 8, 4, 8, 16), 9)]
    for got, want in zip(ssd_ops.ssd_intra_chunk(*t), ssd_intra_chunk_ref(*t)):
        assert torch.equal(got, want)
    assert ssd_kernel.launches == 0


def test_launch_wrapper_refuses_cpu_tensors():
    """The wrapper never computes on the CPU in the kernel's place."""
    t = [torch.from_numpy(a) for a in intra_inputs((1, 1, 8, 4, 8, 16), 10)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_intra_chunk_cuda(*t)
    assert ssd_kernel.launches == 0


def test_plain_rejects_shapes_that_do_not_fit():
    xc, dtc, cum, tot, Bc, Cc = [
        torch.from_numpy(a) for a in intra_inputs((1, 1, 8, 4, 8, 16), 11)]
    with pytest.raises(ValueError):
        ssd_intra_chunk_ref(xc, dtc, cum, tot[:, :, :3], Bc, Cc)
    with pytest.raises(ValueError):
        ssd_intra_chunk_ref(xc, dtc, cum, tot, Bc.expand(1, 1, 8, 3, 16), Cc)
