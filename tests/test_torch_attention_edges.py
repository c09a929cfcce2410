"""Decode attention's edge cases on the CPU, at the head dims and group
sizes the CUDA kernel's two variants take (tensor cores for bfloat16
with D a multiple of 16, FMA units otherwise): the port's plain version
against the JAX package's Pallas kernel (interpret mode) and, with the
in-flight entry, its model layer.

Every case has an empty, a one-row and a full prefix.  The same numpy
inputs go to both packages.  Tolerances are those of
tests/test_kernels.py: 2e-5 in float32, 2e-2 in bfloat16.  The CUDA
kernels themselves run only on a card (``python3 chip_smoke.py`` holds
them against the plain versions at these shapes); here the launch
wrappers must refuse CPU tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as decode_kernel  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SMAX = 48
K = 2


def tol(dtype: str) -> dict:
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def lengths(B: int, seed: int) -> np.ndarray:
    """kv_len 0, 1 and Smax, then random."""
    rest = np.random.default_rng(seed).integers(0, SMAX + 1, B)
    return np.asarray(([0, 1, SMAX] + list(rest))[:B], np.int32)


def inputs(G: int, D: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    H = G * K
    return (rng.standard_normal((B, H, D), np.float32),
            rng.standard_normal((B, SMAX, K, D), np.float32),
            rng.standard_normal((B, SMAX, K, D), np.float32),
            rng.standard_normal((B, K, D), np.float32),
            rng.standard_normal((B, K, D), np.float32))


def as_torch(arrays, dtype: str):
    return [torch.from_numpy(a).to(DTYPES[dtype][1]) for a in arrays]


def assert_close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [36, 64, 128])
@pytest.mark.parametrize("G", [1, 8])
def test_decode_plain_edges_match_pallas(G, D, dtype):
    B = 5
    arrays = inputs(G, D, B, 100 + D + G)[:3]
    kv_len = lengths(B, D + G)
    jdt = DTYPES[dtype][0]
    want = decode_attention_pallas(*(jnp.asarray(a, jdt) for a in arrays),
                                   jnp.asarray(kv_len), bk=16,
                                   interpret=True)
    got = decode_attention_ref(*as_torch(arrays, dtype),
                               torch.from_numpy(kv_len))
    assert torch.isfinite(got).all()
    assert_close(got, want, dtype)
    assert not got[0].any()      # kv_len = 0 gives zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [36, 64, 128])
@pytest.mark.parametrize("G", [1, 8])
def test_decode_plain_edges_with_extra_match_layers(G, D, dtype):
    """With the in-flight entry: the model's deferred-commit attention,
    repro.models.layers.decode_attention(..., extra_kv=...); at kv_len = 0
    the entry alone is the output."""
    B = 5
    arrays = inputs(G, D, B, 7 + D + G)
    q, kc, vc, kn, vn = (jnp.asarray(a, DTYPES[dtype][0]) for a in arrays)
    kv_len = lengths(B, D * G)
    want = RL.decode_attention(q[:, None], kc, vc, jnp.asarray(kv_len),
                               extra_kv=(kn[:, None], vn[:, None]))[:, 0]
    qt, kt, vt, knt, vnt = as_torch(arrays, dtype)
    got = decode_attention_ref(qt, kt, vt, torch.from_numpy(kv_len), knt,
                               vnt)
    assert_close(got, want, dtype)
    assert torch.equal(got[0].reshape(K, G, D),
                       vnt[0][:, None, :].expand(K, G, D))


def test_wrappers_refuse_cpu_tensors_before_other_checks():
    """A CPU tensor is refused for lying on the CPU, whatever else the
    call asks: bfloat16 (the tensor-core kernels), an in-flight entry."""
    flash_kernel.launches = decode_kernel.launches = 0
    q = torch.zeros(1, 8, 4, 32, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_cuda(q, k, k, causal=True)
    lens = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        decode_kernel.decode_attention_cuda(q[:, 0], k, k, lens, k[:, 0],
                                            k[:, 0])
    assert flash_kernel.launches == 0 and decode_kernel.launches == 0
