"""Launch wrapper of the decode-attention CUDA kernel
(``csrc/decode_attention.cu``), which replaces the TPU kernel
``repro.kernels.decode_attention.kernel.decode_attention_pallas`` and
adds the in-flight entry the model's decode needs: bfloat16 with a head
dim in {16, 32, 64, 80, 128} runs on the tensor cores
(``decode_mma_kernel``), anything else on the FMA units
(``decode_fma_kernel``), one block per (kv head, sequence) and one launch
either way."""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import check_shapes

MAX_GROUP = 16      # query heads per kv head
MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (set to 0 to reset)
launches = 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor,
                          k_new: Optional[torch.Tensor] = None,
                          v_new: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q: [B,H,D]; k,v: [B,Smax,K,D]; kv_len: [B] int32; k_new,v_new:
    [B,K,D] or None; all on one CUDA device -> [B,H,D]."""
    global launches
    check_shapes(q, k, v, kv_len, k_new, v_new)
    named = [("q", q), ("k", k), ("v", v), ("kv_len", kv_len)]
    if k_new is not None:
        named += [("k_new", k_new), ("v_new", v_new)]
    for name, t in named:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.int32 if name == "kv_len" else q.dtype
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
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       kv_len.data_ptr(),
                       None if k_new is None else k_new.data_ptr(),
                       None if v_new is None else v_new.data_ptr(),
                       o.data_ptr(), B, Smax, H, K, D, 1.0 / math.sqrt(D),
                       DTYPES[q.dtype],
                       torch.cuda.current_stream().cuda_stream)
    launches += 1
    _build.check(err, "decode_attention")
    return o
