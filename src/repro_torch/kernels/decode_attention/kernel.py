"""Launch wrapper of the decode-attention CUDA kernel
(``csrc/decode_attention.cu``), which replaces the TPU kernel
``repro.kernels.decode_attention.kernel.decode_attention_pallas`` and
adds the in-flight entry the model's decode needs and an int8 cache with
per-token-head scales: bfloat16 q with a head dim in {16, 32, 64, 80,
128, 256} runs on the tensor cores (``decode_mma_kernel``), anything else
on the FMA units (``decode_fma_kernel``), one block per (kv head,
sequence) and one launch either way.  An int8 cache is converted tile by
tile in shared memory by either kernel."""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import check_shapes

MAX_GROUP = 16      # query heads per kv head
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# what the C entry point reports it launched
VARIANTS = ("mma", "fma", "mma_int8", "fma_int8")

# kernel launches since the last reset (set to 0 to reset), and the same
# by variant (set its values to 0 to reset)
launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor,
                          k_new: Optional[torch.Tensor] = None,
                          v_new: Optional[torch.Tensor] = None, *,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q: [B,H,D]; k,v: [B,Smax,K,D] in q's dtype, or int8 with float32
    k_scale, v_scale [B,Smax,K]; kv_len: [B] int32; k_new,v_new: [B,K,D]
    in q's dtype, or None; all on one CUDA device -> [B,H,D]."""
    global launches
    _build.check_no_grad("decode_attention", q, k, v, kv_len, k_new, v_new,
                         k_scale, v_scale)
    check_shapes(q, k, v, kv_len, k_new, v_new, k_scale, v_scale)
    int8 = k.dtype == torch.int8
    named = [("q", q, q.dtype), ("kv_len", kv_len, torch.int32)]
    named += ([("k", k, torch.int8), ("v", v, torch.int8),
               ("k_scale", k_scale, torch.float32),
               ("v_scale", v_scale, torch.float32)] if int8
              else [("k", k, q.dtype), ("v", v, q.dtype)])
    if k_new is not None:
        named += [("k_new", k_new, q.dtype), ("v_new", v_new, q.dtype)]
    for name, t, want in named:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != want:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {want}")
    if q.dtype not in DTYPES:
        raise TypeError(f"dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    B, H, D = q.shape
    Smax, K = k.shape[1], k.shape[2]
    if H // K > MAX_GROUP or D > MAX_HEAD_DIM:
        raise ValueError(f"H/K={H // K} > {MAX_GROUP} or head_dim={D} > "
                         f"{MAX_HEAD_DIM}")
    # an int8 cache is read 16 bytes (16 elements) a copy
    if int8 and (D % 16 or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("an int8 cache needs head_dim % 16 == 0 and "
                         "16-byte aligned k, v")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    variant = ctypes.c_int(-1)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       ptr(k_scale), ptr(v_scale), kv_len.data_ptr(),
                       ptr(k_new), ptr(v_new), o.data_ptr(), B, Smax, H, K,
                       D, 1.0 / math.sqrt(D), DTYPES[q.dtype], int(int8),
                       ctypes.byref(variant),
                       torch.cuda.current_stream().cuda_stream)
    launches += 1
    _build.check(err, "decode_attention")
    variant_launches[VARIANTS[variant.value]] += 1
    return o
