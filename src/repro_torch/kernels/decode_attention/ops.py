"""Decode attention against a KV cache, on the tensor's device.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
takes the plain PyTorch version.  There is no fallback between the two.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor,
                     k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B,H,D]; caches [B,Smax,K,D] (int8 with k_scale, v_scale
    [B,Smax,K]); kv_len [B]; optional in-flight k_new, v_new [B,K,D]
    -> [B,H,D]."""
    kw = dict(k_scale=k_scale, v_scale=v_scale)
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, kv_len, k_new,
                                     v_new, **kw)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len, k_new,
                                    v_new, **kw)
    raise ValueError(f"decode_attention: no implementation on {q.device}")
