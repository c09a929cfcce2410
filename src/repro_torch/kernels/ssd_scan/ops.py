"""The SSD intra-chunk step on the tensor's device.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
takes the plain PyTorch version.  There is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref


def ssd_intra_chunk(xc: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
                    tot: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor):
    """xc [b,nc,Q,H,P], dtc/cum [b,nc,Q,H], tot [b,nc,H], Bc/Cc
    [b,nc,Q,G,N] -> (y_intra [b,nc,Q,H,P], states [b,nc,H,P,N]), f32."""
    if xc.is_cuda:
        return ssd_intra_chunk_cuda(xc, dtc, cum, tot, Bc, Cc)
    if xc.device.type == "cpu":
        return ssd_intra_chunk_ref(xc, dtc, cum, tot, Bc, Cc)
    raise ValueError(f"ssd_intra_chunk: no implementation on {xc.device}")
