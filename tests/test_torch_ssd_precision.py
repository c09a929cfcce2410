"""Why ``csrc/ssd_scan.cu`` splits every float32 operand into two TF32
parts, checked on the CPU.

The kernel runs its three contractions (C.B^T, W.x and the state's
(x.w)^T.B) on the tensor cores in TF32, which keeps 10 of float32's 23
mantissa bits.  ``tf32x3`` below emulates its arithmetic: each operand
``a`` becomes ``hi = tf32(a)`` (round to nearest, ties away from zero, as
``cvt.rna.tf32.f32``) and ``lo = a - hi``, of which the tensor cores read
the TF32 part (the low 13 bits dropped), and a product is
``lo.hi + hi.lo + hi.hi`` with float32 sums; the weights, exponentials and
masking stay float32.  Held to the plain version (``ssd_intra_chunk_ref``
of the port and of the JAX package) at the float32 tolerance the card's
check uses (atol 3e-5 / rtol 3e-4, as tests/test_kernels.py holds the TPU
kernel), the emulation passes at a full 256-step chunk, under strong decay,
at d_state 64 and at a ragged chunk, while one TF32 rounding of each
operand does not.  A bfloat16 x is exact in TF32 (its lo part is 0),
which is why the kernel skips that product for bfloat16 inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_intra_chunk_ref as jax_ref)
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref  # noqa: E402

F32_TOL = dict(atol=3e-5, rtol=3e-4)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: add half of the 13 dropped bits to the magnitude and
    cut them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def cut(a: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a float32 operand: its low 13 bits
    dropped."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32(a)
    return hi, cut(a - hi)


def tf32_mm(a: torch.Tensor, b: torch.Tensor, three: bool) -> torch.Tensor:
    """a @ b (batched) as the tensor cores compute it: three products of
    the split parts, small ones first, or one product of TF32 roundings."""
    if not three:
        return tf32(a) @ tf32(b)
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def tf32x3(xc, dtc, cum, tot, Bc, Cc, three: bool = True):
    """The kernel's arithmetic on the CPU (n_groups = 1), float32."""
    b, nc, Q, H, P = xc.shape
    xf = xc.float()
    Bm, Cm = Bc[:, :, :, 0].float(), Cc[:, :, :, 0].float()  # [b,nc,Q,N]
    s = tf32_mm(Cm, Bm.transpose(-1, -2), three)            # [b,nc,Q,Q]
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # [b,nc,l,m,H]
    mask = torch.ones(Q, Q, dtype=torch.bool).tril()
    dec = dec.masked_fill(~mask[None, None, :, :, None], float("-inf"))
    w = s[..., None] * torch.exp(dec) * dtc[:, :, None, :, :]
    y = tf32_mm(w.permute(0, 1, 4, 2, 3),                   # [b,nc,H,l,m]
                xf.permute(0, 1, 3, 2, 4), three)            # [b,nc,H,m,P]
    wm = torch.exp(tot[:, :, None, :] - cum) * dtc           # [b,nc,Q,H]
    xw = (xf * wm[..., None]).permute(0, 1, 3, 4, 2)         # [b,nc,H,P,Q]
    st = tf32_mm(xw, Bm[:, :, None], three)                  # [b,nc,H,P,N]
    return y.permute(0, 1, 3, 2, 4), st


def inputs(case, seed, decay=1.0):
    """As chip_smoke.ssd_inputs draws them, from numpy: softplus step
    sizes, log decays of -decay * softplus(N(0, 1)), B and C ~ N(0, 1/4)."""
    b, nc, Q, H, P, N = case
    rng = np.random.default_rng(seed)

    def softplus(v):
        return np.logaddexp(v, 0.0).astype(np.float32)
    xc = rng.standard_normal((b, nc, Q, H, P), np.float32)
    dtc = softplus(rng.standard_normal((b, nc, Q, H), np.float32))
    la = -decay * softplus(rng.standard_normal((b, nc, Q, H), np.float32))
    cum = np.cumsum(la, axis=2, dtype=np.float32)
    tot = np.ascontiguousarray(cum[:, :, -1, :])
    Bc = 0.5 * rng.standard_normal((b, nc, Q, 1, N), np.float32)
    Cc = 0.5 * rng.standard_normal((b, nc, Q, 1, N), np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (xc, dtc, cum, tot, Bc, Cc)]


def assert_close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32_TOL)


# (label, (b, nc, Q, H, P, N), decay)
SPLIT_CASES = [
    ("chunk", (1, 1, 256, 4, 64, 128), 1.0),
    ("decay", (1, 1, 256, 4, 64, 128), 100.0),
    ("zamba2", (1, 2, 256, 4, 64, 64), 1.0),
    ("ragged", (2, 1, 100, 3, 64, 128), 1.0),
    ("serving", (1, 1, 8, 8, 64, 128), 1.0),
]


@pytest.mark.parametrize("label,case,decay", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_split_tf32_holds_float32_tolerance(label, case, decay):
    args = inputs(case, seed=len(label) + case[2], decay=decay)
    got = tf32x3(*args)
    assert_close(got, ssd_intra_chunk_ref(*args))
    want = jax_ref(*(jnp.asarray(a.numpy()) for a in args))
    assert_close(got, [torch.from_numpy(np.array(w)) for w in want])


def test_one_tf32_rounding_breaks_float32_tolerance():
    """Without the split the y error at a full chunk is hundreds of times
    the tolerance."""
    args = inputs((1, 1, 256, 4, 64, 128), seed=1)
    want = ssd_intra_chunk_ref(*args)
    one = tf32x3(*args, three=False)
    three = tf32x3(*args)
    for o, t, w in zip(one, three, want):
        assert not torch.allclose(o, w, **F32_TOL)
        assert torch.allclose(t, w, **F32_TOL)
    err_one = (one[0] - want[0]).abs().max().item()
    err_three = (three[0] - want[0]).abs().max().item()
    assert err_one > 100 * err_three


def test_dt_zero_steps_add_exactly_nothing_through_the_split():
    """Weights of dt = 0 steps are 0, so are both split halves, so the
    outputs do not depend on x at those steps at all."""
    args = inputs((1, 1, 64, 4, 32, 16), seed=2)
    args[1][:, :, 40:] = 0.0
    y, st = tf32x3(*args)
    xz = args[0].clone()
    xz[:, :, 40:] = 7.0
    y0, st0 = tf32x3(xz, *args[1:])
    assert torch.equal(y, y0) and torch.equal(st, st0)


def test_bfloat16_is_exact_in_tf32():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        4096, np.float32) * 100).to(torch.bfloat16).float()
    hi, lo = split(x)
    assert torch.equal(hi, x)
    assert torch.equal(lo, torch.zeros_like(x))


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                  # TF32's spacing on [1, 2)
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2**-23,
                      1.0 + 3 * ulp / 2, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp, 3.0])
    assert torch.equal(tf32(x), want)
