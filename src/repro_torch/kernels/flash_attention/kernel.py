"""Launch wrapper of the flash-attention CUDA kernel
(``csrc/flash_attention.cu``), which replaces the TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_pallas``: bfloat16
runs on the tensor cores (``flash_mma_kernel``), float32 on the FMA units
(``flash_fwd_kernel``), one launch either way."""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import check_shapes

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (set to 0 to reset)
launches = 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q: [B,Sq,H,D]; k,v: [B,Skv,K,D] on one CUDA device -> [B,Sq,H,D]."""
    global launches
    _build.check_inputs("flash_attention", q, k, v)
    check_shapes(q, k, v, causal)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, "
                             f"got {t.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes "
                            "float32 or bfloat16, the same for q, k, v")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    # the bfloat16 kernel (tensor cores) copies rows in 16-byte pieces
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("bfloat16 q, k, v must start on 16-byte "
                         "boundaries")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), B, Sq, Skv, H, K, D,
                       1.0 / math.sqrt(D), int(causal), DTYPES[q.dtype],
                       torch.cuda.current_stream().cuda_stream)
    launches += 1
    _build.check(err, "flash_attention")
    return o
