"""Plain PyTorch version of the flash-attention kernel.

The same function as ``csrc/flash_attention.cu`` and as the TPU kernel it
replaces (``repro.kernels.flash_attention.kernel.flash_attention_pallas``):
q is scaled by 1/sqrt(D) before the product, the causal mask is aligned
top-left (query i sees keys 0..i, so ``causal`` requires Sq == Skv), and
a fully masked row gives zeros.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Sq,H,D] and k, v [B,Skv,K,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2] != 0:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: batch and head_dim must match "
                         "and K must divide H")
    if causal and k.shape[1] != Sq:
        raise ValueError(f"causal attention needs Sq == Skv, got {Sq} and "
                         f"{k.shape[1]}")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q: [B,Sq,H,D]; k,v: [B,Skv,K,D] -> [B,Sq,H,D] (model layout)."""
    check_shapes(q, k, v, causal)
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2) * (1.0 / math.sqrt(D))     # [B,H,Sq,D]
    kf = k.float().transpose(1, 2).repeat_interleave(H // K, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(H // K, dim=1)
    s = qf @ kf.transpose(-1, -2)                             # [B,H,Sq,Skv]
    if causal:
        pos = torch.arange(Sq, device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    o = (p @ vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.transpose(1, 2).to(q.dtype).contiguous()
