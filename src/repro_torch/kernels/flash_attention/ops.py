"""Flash attention in the model's layout, on the tensor's device.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
takes the plain PyTorch version.  There is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: [B,Sq,H,D]; k,v: [B,Skv,K,D] -> [B,Sq,H,D]."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    raise ValueError(f"flash_attention: no implementation on {q.device}")
