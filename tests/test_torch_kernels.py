"""The port's attention kernels on the CPU: their plain versions against
the JAX package's Pallas kernels (interpret mode) and jnp layers.

The same numpy inputs go to both packages.  Tolerances are those of
tests/test_kernels.py: 2e-5 in float32, 2e-2 in bfloat16.  The CUDA
kernels themselves run only on a card (``python3 chip_smoke.py``); here
the dispatchers must take the plain versions for CPU tensors and the
launch wrappers must refuse them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as decode_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype: str) -> dict:
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def both(x: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def assert_close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol(dtype))


FLASH_CASES = [
    # (B, H, K, S, D, causal, bq, bk), as in tests/test_kernels.py
    (2, 4, 2, 64, 16, True, 32, 32),
    (1, 8, 8, 128, 32, False, 32, 64),
    (2, 4, 1, 96, 64, True, 32, 32),
    (1, 2, 2, 128, 128, True, 64, 64),
    (1, 16, 4, 64, 80, True, 32, 32),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas(case, dtype):
    B, H, K, S, D, causal, bq, bk = case
    rng = np.random.default_rng(S * D + H)
    qj, qt = both(rng.standard_normal((B, S, H, D), np.float32), dtype)
    kj, kt = both(rng.standard_normal((B, S, K, D), np.float32), dtype)
    vj, vt = both(rng.standard_normal((B, S, K, D), np.float32), dtype)
    want = flash_attention_pallas(qj.transpose(0, 2, 1, 3),
                                  kj.transpose(0, 2, 1, 3),
                                  vj.transpose(0, 2, 1, 3), causal=causal,
                                  bq=bq, bk=bk, interpret=True)
    got = flash_attention_ref(qt, kt, vt, causal=causal)
    assert got.shape == qt.shape and got.dtype == qt.dtype
    assert_close(got, np.asarray(want, np.float32).transpose(0, 2, 1, 3),
                 dtype)


def test_flash_plain_requires_square_causal():
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 6, 2, 16)
    with pytest.raises(ValueError):
        flash_attention_ref(q, k, k, causal=True)
    assert flash_attention_ref(q, k, k, causal=False).shape == q.shape


DECODE_CASES = [
    # (B, H, K, S, D, bk), as in tests/test_kernels.py
    (3, 4, 2, 128, 16, 32),
    (2, 8, 1, 256, 32, 64),
    (1, 16, 16, 64, 64, 32),
    (2, 4, 4, 96, 128, 32),
]


def decode_inputs(B, H, K, S, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, D), np.float32),
            rng.standard_normal((B, S, K, D), np.float32),
            rng.standard_normal((B, S, K, D), np.float32),
            rng.standard_normal((B, K, D), np.float32),
            rng.standard_normal((B, K, D), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_pallas(case, dtype):
    B, H, K, S, D, bk = case
    q, kc, vc, _, _ = decode_inputs(B, H, K, S, D, sum(case))
    lens = np.random.default_rng(B + S).integers(1, S + 1, B).astype(np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dtype) for a in (q, kc, vc))
    want = decode_attention_pallas(qj, kj, vj, jnp.asarray(lens), bk=bk,
                                   interpret=True)
    assert_close(decode_attention_ref(qt, kt, vt, torch.from_numpy(lens)),
                 want, dtype)


@pytest.mark.parametrize("lens", [(0, 96), (1, 0), (0, 0), (37, 96),
                                  (96, 64)])
def test_decode_plain_ragged_lengths_with_zero(lens):
    """kv_len masking, and kv_len = 0 giving zeros, as the Pallas kernel."""
    B, H, K, S, D = 2, 4, 2, 96, 16
    q, kc, vc, _, _ = decode_inputs(B, H, K, S, D, 7)
    kv_len = np.asarray(lens, np.int32)
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(kv_len),
                                   bk=32, interpret=True)
    got = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), torch.from_numpy(kv_len))
    assert_close(got, want, "float32")
    for b in np.flatnonzero(kv_len == 0):
        assert not got[b].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens", [(0, 5, 64), (64, 1, 30)])
def test_decode_plain_with_extra_matches_layers(lens, dtype):
    """With the in-flight entry: the model's deferred-commit attention,
    repro.models.layers.decode_attention(..., extra_kv=...)."""
    B, H, K, S, D = 3, 8, 2, 64, 32
    arrays = decode_inputs(B, H, K, S, D, sum(lens))
    (qj, qt), (kj, kt), (vj, vt), (knj, knt), (vnj, vnt) = (
        both(a, dtype) for a in arrays)
    kv_len = np.asarray(lens, np.int32)
    want = RL.decode_attention(qj[:, None], kj, vj, jnp.asarray(kv_len),
                               extra_kv=(knj[:, None], vnj[:, None]))
    got = decode_attention_ref(qt, kt, vt, torch.from_numpy(kv_len), knt, vnt)
    assert_close(got, np.asarray(want, np.float32)[:, 0], dtype)
    # the port's plain layer (the model's "dense" path) is the same function
    layer = PL.decode_attention(qt[:, None], kt, vt, torch.from_numpy(kv_len),
                                extra_kv=(knt[:, None], vnt[:, None]))
    assert_close(layer[:, 0], np.asarray(want, np.float32)[:, 0], dtype)


def test_dense_attention_matches_reference_layer():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 24, 4, 16), np.float32)
    k = rng.standard_normal((2, 24, 2, 16), np.float32)
    v = rng.standard_normal((2, 24, 2, 16), np.float32)
    ke = RL._expand_kv(jnp.asarray(k), 4)
    ve = RL._expand_kv(jnp.asarray(v), 4)
    want = RL.dense_attention(jnp.asarray(q), ke, ve, causal=True)
    got = PL.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True)
    assert_close(got, want, "float32")
    # and the flash kernel's plain version agrees where Sq == Skv
    assert_close(flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True),
                 want, "float32")


def test_ops_take_plain_version_on_cpu_without_launching():
    flash_kernel.launches = 0
    decode_kernel.launches = 0
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 16, 2, 32), np.float32))
    assert torch.equal(flash_ops.flash_attention(q, k, k, causal=True),
                       flash_attention_ref(q, k, k, causal=True))
    qd = q[:, 0].contiguous()
    lens = torch.tensor([9], dtype=torch.int32)
    assert torch.equal(
        decode_ops.decode_attention(qd, k, k, lens, k[:, 0], k[:, 0]),
        decode_attention_ref(qd, k, k, lens, k[:, 0], k[:, 0]))
    assert flash_kernel.launches == 0 and decode_kernel.launches == 0


def test_launch_wrappers_refuse_cpu_tensors():
    """A wrapper never computes on the CPU in the kernel's place."""
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_cuda(q, k, k, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        decode_kernel.decode_attention_cuda(
            q[:, 0], k, k, torch.zeros(1, dtype=torch.int32))
    assert flash_kernel.launches == 0 and decode_kernel.launches == 0
