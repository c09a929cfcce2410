"""Launch wrapper of the group-pick CUDA kernel (``csrc/group_pick.cu``),
which replaces the TPU kernel
``repro.kernels.group_pick.kernel.pick_order_pallas``."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.group_pick.ref import check_shapes

# kernel launches since the last reset (set to 0 to reset)
launches = 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("group_pick").group_pick_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pick_order_cuda(vr: torch.Tensor, rid: torch.Tensor,
                    kmax: int) -> torch.Tensor:
    """vr, rid: [G, CAP] int32, contiguous, on one CUDA device ->
    [G, kmax] int32 pool positions."""
    global launches
    _build.check_inputs("group_pick", vr, rid)
    check_shapes(vr, rid, kmax)
    for name, t in (("vr", vr), ("rid", rid)):
        if not t.is_cuda or t.device != vr.device:
            raise ValueError(f"{name} must lie on vr's CUDA device, "
                             f"got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected int32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    G, cap = vr.shape
    out = torch.empty(G, kmax, dtype=torch.int32, device=vr.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(vr.device):
        err = _entry()(vr.data_ptr(), rid.data_ptr(), out.data_ptr(), G,
                       cap, kmax, torch.cuda.current_stream().cuda_stream)
    launches += 1
    _build.check(err, "group_pick")
    return out
