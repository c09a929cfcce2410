"""The int8 KV cache and head_dim 256 in the port's attention kernels, on
the CPU: ``quantize_kv`` bit for bit against the reference's, the port's
``layers.decode_attention`` with scales against
``repro.models.layers.decode_attention``, the decode kernel's plain
version (int8 cache, float32 scales, in-flight entry, kv_len = 0 rows)
against the same layer and the flash and decode plain versions against
the Pallas kernels (interpret mode) at D = 256.

Shapes are gemma-7b's decode (D = 256, one query head per kv head) and
chatglm3-6b's (D = 128, 16 query heads per kv head), cut in batch and
cache length.  The same numpy inputs go to both packages; the int8 cache
is the reference's own quantization of float keys and values.
Tolerances are those of tests/test_kernels.py: 2e-5 in float32, 2e-2 in
bfloat16.  The CUDA kernels run only on a card (``python3 chip_smoke.py``
holds them against these plain versions); here the wrappers must refuse
CPU tensors and the dispatchers must take the plain versions.
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
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (G query heads per kv head, K kv heads, D): gemma-7b's and chatglm3-6b's
# decode, cut in heads
SHAPES = [(1, 4, 256), (16, 2, 128)]
SMAX = 40


def tol(dtype: str) -> dict:
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def assert_close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol(dtype))


# ---------------------------------------------------------------------------
# quantize_kv
# ---------------------------------------------------------------------------


def quantize_both(x: np.ndarray, dtype: str = "float32"):
    jdt, tdt = DTYPES[dtype]
    qj, sj = RL.quantize_kv(jnp.asarray(x, jdt))
    qt, st = PL.quantize_kv(torch.from_numpy(x).to(tdt))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    return (np.asarray(qj), np.asarray(sj)), (qt.numpy(), st.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact_random(dtype):
    x = np.random.default_rng(0).standard_normal((3, 7, 4, 256),
                                                 np.float32) * 3
    (qj, sj), (qt, st) = quantize_both(x, dtype)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)
    # every row reaches +-127 at its largest magnitude
    assert np.abs(qt).max(axis=-1).min() == 127


def test_quantize_kv_ties_floor_and_clipping():
    """Exact .5 ties round half to even (amax 127: the scale is exactly
    1); an all-zero row and a row far below 1.27e-6 take the 1e-8 floor;
    +-amax maps to +-127."""
    x = np.zeros((1, 4, 16), np.float32)
    x[0, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[0, 0, 8:] = [-127.0, 3.5, -3.5, 100.5, -100.5, 0.0, 64.5, 63.5]
    # row 1 all zero; row 2 tiny (scale floored at 1e-8: 5e-9 is a tie)
    x[0, 2, :4] = [5e-9, -5e-9, 1.5e-8, 1e-9]
    x[0, 3] = np.linspace(-2.0, 2.0, 16, dtype=np.float32)
    (qj, sj), (qt, st) = quantize_both(x)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)
    assert qt[0, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126,
                                 -127, 4, -4, 100, -100, 0, 64, 64]
    assert st[0, 0] == 1.0
    assert st[0, 1] == np.float32(1e-8) and not qt[0, 1].any()
    assert st[0, 2] == np.float32(1e-8)
    assert qt[0, 3, 0] == -127 and qt[0, 3, -1] == 127


# ---------------------------------------------------------------------------
# decode attention over an int8 cache
# ---------------------------------------------------------------------------


def int8_inputs(G: int, K: int, D: int, B: int, seed: int):
    """q, the reference's int8 cache with its scales, the in-flight
    entry and kv_len (0, 1, Smax, then random), all numpy."""
    rng = np.random.default_rng(seed)
    H = G * K
    q = rng.standard_normal((B, H, D), np.float32)
    kq, ks = (np.array(a) for a in RL.quantize_kv(jnp.asarray(
        rng.standard_normal((B, SMAX, K, D), np.float32))))
    vq, vs = (np.array(a) for a in RL.quantize_kv(jnp.asarray(
        rng.standard_normal((B, SMAX, K, D), np.float32) * 2)))
    k_new = rng.standard_normal((B, K, D), np.float32)
    v_new = rng.standard_normal((B, K, D), np.float32)
    kv_len = np.asarray(([0, 1, SMAX] + list(rng.integers(0, SMAX + 1, B)))
                        [:B], np.int32)
    return q, kq, vq, ks, vs, k_new, v_new, kv_len


def reference_layer(q, kq, vq, ks, vs, kv_len, k_new=None, v_new=None,
                    dtype="float32"):
    jdt = DTYPES[dtype][0]
    extra = None if k_new is None else (jnp.asarray(k_new[:, None], jdt),
                                        jnp.asarray(v_new[:, None], jdt))
    out = RL.decode_attention(jnp.asarray(q[:, None], jdt), jnp.asarray(kq),
                              jnp.asarray(vq), jnp.asarray(kv_len),
                              k_scale=jnp.asarray(ks),
                              v_scale=jnp.asarray(vs), extra_kv=extra)
    return np.asarray(out, np.float32)[:, 0]


@pytest.mark.parametrize("shape", SHAPES)
def test_layer_decode_attention_with_scales_matches_reference(shape):
    """The model layer (attn_impl="dense"): scales folded into scores and
    weights, the in-flight entry not quantized, ragged kv_len."""
    G, K, D = shape
    q, kq, vq, ks, vs, kn, vn, kv_len = int8_inputs(G, K, D, 6, seed=D + G)
    want = reference_layer(q, kq, vq, ks, vs, kv_len, kn, vn)
    t = torch.from_numpy
    got = PL.decode_attention(t(q)[:, None], t(kq), t(vq), t(kv_len),
                              k_scale=t(ks), v_scale=t(vs),
                              extra_kv=(t(kn)[:, None], t(vn)[:, None]))
    assert got.shape == (6, 1, G * K, D) and got.dtype == torch.float32
    assert_close(got[:, 0], want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_decode_int8_matches_reference_layer(shape, dtype):
    """The decode kernel's plain version with the in-flight entry is the
    reference layer's function (q, k_new, v_new and the output in
    ``dtype``; the cache int8, the scales float32)."""
    G, K, D = shape
    q, kq, vq, ks, vs, kn, vn, kv_len = int8_inputs(G, K, D, 5, seed=D)
    tdt = DTYPES[dtype][1]
    want = reference_layer(q, kq, vq, ks, vs, kv_len, kn, vn, dtype)
    t = torch.from_numpy
    got = decode_attention_ref(t(q).to(tdt), t(kq), t(vq), t(kv_len),
                               t(kn).to(tdt), t(vn).to(tdt), k_scale=t(ks),
                               v_scale=t(vs))
    assert got.dtype == tdt
    assert_close(got, want, dtype)
    # kv_len = 0: the output is the in-flight value, for every query head
    assert torch.equal(got[0].reshape(K, G, D),
                       t(vn).to(tdt)[0][:, None, :].expand(K, G, D))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_decode_int8_without_entry_zeros_empty_rows(shape):
    """Without the in-flight entry: the reference layer's function where
    kv_len > 0, and zeros where kv_len = 0 (the TPU kernel's contract)."""
    G, K, D = shape
    q, kq, vq, ks, vs, _, _, kv_len = int8_inputs(G, K, D, 6, seed=3 * D)
    want = reference_layer(q, kq, vq, ks, vs, kv_len)
    t = torch.from_numpy
    got = decode_attention_ref(t(q), t(kq), t(vq), t(kv_len),
                               k_scale=t(ks), v_scale=t(vs))
    live = kv_len > 0
    assert_close(got[live], want[live], "float32")
    assert not got[~live].any()


def test_plain_decode_int8_is_the_dequantized_cache():
    """Folding the scales equals attending over the dequantized cache
    (k * k_scale, v * v_scale) in float32."""
    G, K, D = SHAPES[1]
    q, kq, vq, ks, vs, kn, vn, kv_len = int8_inputs(G, K, D, 4, seed=11)
    t = torch.from_numpy
    got = decode_attention_ref(t(q), t(kq), t(vq), t(kv_len), t(kn), t(vn),
                               k_scale=t(ks), v_scale=t(vs))
    kd = t(kq).float() * t(ks)[..., None]
    vd = t(vq).float() * t(vs)[..., None]
    want = decode_attention_ref(t(q), kd, vd, t(kv_len), t(kn), t(vn))
    assert_close(got, want.numpy(), "float32")


def test_int8_checks_raise():
    G, K, D = SHAPES[1]
    q, kq, vq, ks, vs, kn, vn, kv_len = (torch.from_numpy(a) for a in
                                         int8_inputs(G, K, D, 2, seed=1))
    with pytest.raises(ValueError, match="int8"):
        decode_attention_ref(q, kq, vq, kv_len)                 # no scales
    with pytest.raises(ValueError, match="int8"):
        decode_attention_ref(q, kq, vq, kv_len, k_scale=ks)     # one scale
    with pytest.raises(ValueError, match="int8"):               # float cache
        decode_attention_ref(q, kq.float(), vq.float(), kv_len,
                             k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="k_scale"):
        decode_attention_ref(q, kq, vq, kv_len, k_scale=ks[:, :-1],
                             v_scale=vs)
    with pytest.raises(TypeError, match="v_scale"):
        decode_attention_ref(q, kq, vq, kv_len, k_scale=ks,
                             v_scale=vs.to(torch.bfloat16))
    with pytest.raises(TypeError, match="caches differ"):
        decode_attention_ref(q, kq, vq.float(), kv_len, k_scale=ks,
                             v_scale=vs)


def test_int8_wrapper_refuses_cpu_and_ops_take_plain_version():
    decode_kernel.launches = 0
    decode_kernel.variant_launches.update(
        dict.fromkeys(decode_kernel.VARIANTS, 0))
    G, K, D = SHAPES[0]
    q, kq, vq, ks, vs, kn, vn, kv_len = (torch.from_numpy(a) for a in
                                         int8_inputs(G, K, D, 3, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        decode_kernel.decode_attention_cuda(q, kq, vq, kv_len, kn, vn,
                                            k_scale=ks, v_scale=vs)
    got = decode_ops.decode_attention(q, kq, vq, kv_len, kn, vn,
                                      k_scale=ks, v_scale=vs)
    want = decode_attention_ref(q, kq, vq, kv_len, kn, vn, k_scale=ks,
                                v_scale=vs)
    assert torch.equal(got, want)
    assert decode_kernel.launches == 0
    assert not any(decode_kernel.variant_launches.values())


# ---------------------------------------------------------------------------
# head_dim 256 against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    # (B, H, K, S, D, causal, bq, bk)
    (1, 2, 2, 64, 256, True, 32, 32),     # gemma-7b: one head per kv head
    (2, 4, 1, 32, 256, False, 32, 16),
])
def test_flash_plain_matches_pallas_d256(case, dtype):
    B, H, K, S, D, causal, bq, bk = case
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(S + H)
    arrs = [rng.standard_normal((B, S, n, D), np.float32)
            for n in (H, K, K)]
    qj, kj, vj = (jnp.asarray(a, jdt).transpose(0, 2, 1, 3) for a in arrs)
    want = flash_attention_pallas(qj, kj, vj, causal=causal, bq=bq, bk=bk,
                                  interpret=True)
    got = flash_attention_ref(*(torch.from_numpy(a).to(tdt) for a in arrs),
                              causal=causal)
    assert_close(got, np.asarray(want, np.float32).transpose(0, 2, 1, 3),
                 dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_decode_plain_matches_pallas_new_shapes(shape, dtype):
    """D = 256 with G = 1 and D = 128 with G = 16, a bfloat16 or float32
    cache, kv_len 0 in one row."""
    G, K, D = shape
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(G * D)
    B, H = 4, G * K
    q = rng.standard_normal((B, H, D), np.float32)
    kc = rng.standard_normal((B, SMAX, K, D), np.float32)
    vc = rng.standard_normal((B, SMAX, K, D), np.float32)
    kv_len = np.array([0, SMAX, 1, 17], np.int32)
    want = decode_attention_pallas(*(jnp.asarray(a, jdt) for a in
                                     (q, kc, vc)),
                                   jnp.asarray(kv_len), bk=20,
                                   interpret=True)
    got = decode_attention_ref(*(torch.from_numpy(a).to(tdt) for a in
                                 (q, kc, vc)), torch.from_numpy(kv_len))
    assert_close(got, want, dtype)
    assert not got[0].any()
