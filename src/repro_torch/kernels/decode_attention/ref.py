"""Plain PyTorch version of the decode-attention kernel.

The same function as ``csrc/decode_attention.cu``.  Without an in-flight
entry it is the contract of the TPU kernel it replaces
(``repro.kernels.decode_attention.kernel.decode_attention_pallas``):
cache positions >= kv_len are masked and a sequence with kv_len = 0 gets
a zero output.  With ``k_new``/``v_new`` it is the deferred-commit
attention the model's decode runs
(``repro.models.layers.decode_attention(..., extra_kv=...)``): the new
entry joins the softmax beside the kv_len cache entries.  An int8 cache
comes with float32 per-token-head ``k_scale``/``v_scale`` [B,Smax,K],
folded as that layer folds them: into the scores before the mask, and
into the softmax weights after the row sum is taken (the in-flight entry
is not quantized).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def check_shapes(q, k, v, kv_len, k_new, v_new, k_scale=None,
                 v_scale=None) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,H,D] and caches [B,Smax,K,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, D = q.shape
    Smax, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % K != 0:
        raise ValueError(f"caches {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: batch and head_dim must match "
                         "and K must divide H")
    if tuple(kv_len.shape) != (B,):
        raise ValueError(f"kv_len must be [B]={B}, got {tuple(kv_len.shape)}")
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new come together")
    if k_new is not None and (tuple(k_new.shape) != (B, K, D)
                              or k_new.shape != v_new.shape):
        raise ValueError(f"k_new, v_new must be [B,K,D]={(B, K, D)}, got "
                         f"{tuple(k_new.shape)}, {tuple(v_new.shape)}")
    int8 = k.dtype == torch.int8
    if int8 != (v.dtype == torch.int8):
        raise TypeError(f"k and v caches differ: {k.dtype}, {v.dtype}")
    if int8 != (k_scale is not None) or int8 != (v_scale is not None):
        raise ValueError("an int8 cache comes with both k_scale and "
                         "v_scale, and only an int8 cache does")
    if int8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != (B, Smax, K):
                raise ValueError(f"{name} must be [B,Smax,K]="
                                 f"{(B, Smax, K)}, got {tuple(t.shape)}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: dtype {t.dtype}, expected "
                                "torch.float32")


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor,
                         k_new: Optional[torch.Tensor] = None,
                         v_new: Optional[torch.Tensor] = None, *,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q: [B,H,D]; k,v: [B,Smax,K,D]; kv_len: [B]; k_new,v_new: [B,K,D];
    k_scale,v_scale: [B,Smax,K] with an int8 k, v -> [B,H,D]."""
    check_shapes(q, k, v, kv_len, k_new, v_new, k_scale, v_scale)
    B, H, D = q.shape
    Smax, K = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, K, H // K, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    if k_scale is not None:
        s = s * k_scale.transpose(1, 2)[:, :, None, :]
    valid = torch.arange(Smax, device=q.device) < kv_len.reshape(B, 1)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    if k_new is not None:
        s_x = torch.einsum("bkgd,bkd->bkg", qg, k_new.float())
        s = torch.cat([s, s_x[..., None]], dim=-1)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pc = p[..., :Smax]
    if v_scale is not None:
        pc = pc * v_scale.transpose(1, 2)[:, :, None, :]
    o = torch.einsum("bkgs,bskd->bkgd", pc, v.float())
    if k_new is not None:
        o = o + p[..., Smax:] * v_new.float()[:, :, None, :]
    return (o / l).reshape(B, H, D).to(q.dtype)
