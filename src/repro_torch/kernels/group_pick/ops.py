"""Per-group fair-share pick, on the tensor's device.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor
takes the plain PyTorch version.  There is no fallback between the two.
The cluster's tick body (``serving/torch_cluster.py``) calls this.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.group_pick.kernel import pick_order_cuda
from repro_torch.kernels.group_pick.ref import pick_order_ref


def pick_order(vr: torch.Tensor, rid: torch.Tensor,
               kmax: int) -> torch.Tensor:
    """``[G, CAP]`` int32 ``(vruntime, rid)`` keys (INT32_MAX sentinels
    for empty slots) -> ``[G, kmax]`` int32 pool positions, best first."""
    if vr.is_cuda:
        return pick_order_cuda(vr, rid, kmax)
    if vr.device.type == "cpu":
        return pick_order_ref(vr, rid, kmax)
    raise ValueError(f"pick_order: no implementation on {vr.device}")
