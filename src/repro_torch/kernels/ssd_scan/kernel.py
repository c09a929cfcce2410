"""Launch wrapper of the SSD intra-chunk CUDA kernel
(``csrc/ssd_scan.cu``), which replaces the TPU kernel
``repro.kernels.ssd_scan.kernel.ssd_intra_chunk_pallas``."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import check_shapes

MAX_P = 128
MAX_N = 128
MAX_CHUNKS = 65535          # b * nc, as the C entry point checks
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (set to 0 to reset)
launches = 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("ssd_scan").ssd_intra_chunk_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd_intra_chunk_cuda(xc: torch.Tensor, dtc: torch.Tensor,
                         cum: torch.Tensor, tot: torch.Tensor,
                         Bc: torch.Tensor, Cc: torch.Tensor):
    """xc [b,nc,Q,H,P] float32 or bfloat16; dtc/cum [b,nc,Q,H], tot
    [b,nc,H], Bc/Cc [b,nc,Q,1,N] float32; all contiguous on one CUDA
    device -> (y_intra [b,nc,Q,H,P], states [b,nc,H,P,N]), float32."""
    global launches
    _build.check_inputs("ssd_scan", xc, dtc, cum, tot, Bc, Cc)
    check_shapes(xc, dtc, cum, tot, Bc, Cc)
    named = (("xc", xc), ("dtc", dtc), ("cum", cum), ("tot", tot),
             ("Bc", Bc), ("Cc", Cc))
    for name, t in named:
        if not t.is_cuda or t.device != xc.device:
            raise ValueError(f"{name} must lie on xc's CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "xc" and t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32")
    if xc.dtype not in X_DTYPES:
        raise TypeError(f"xc: dtype {xc.dtype}; the kernel takes float32 "
                        "or bfloat16")
    b, nc, Q, H, P = xc.shape
    N = Bc.shape[-1]
    if Bc.shape[3] != 1:
        raise ValueError(f"the kernel takes n_groups = 1, got {Bc.shape[3]}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"head_dim P = {P} and d_state N = {N} must be at "
                         f"most {MAX_P} and {MAX_N}")
    if b * nc > MAX_CHUNKS:
        raise ValueError(f"b * nc = {b * nc} chunks exceed {MAX_CHUNKS}")
    y = torch.empty(b, nc, Q, H, P, dtype=torch.float32, device=xc.device)
    st = torch.empty(b, nc, H, P, N, dtype=torch.float32, device=xc.device)
    if y.numel() == 0:         # no steps (Q = 0), heads or chunks
        return y, st.zero_()
    with torch.cuda.device(xc.device):
        err = _entry()(xc.data_ptr(), dtc.data_ptr(), cum.data_ptr(),
                       tot.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                       y.data_ptr(), st.data_ptr(), b, nc, Q, H, P, N,
                       X_DTYPES[xc.dtype],
                       torch.cuda.current_stream().cuda_stream)
    launches += 1
    _build.check(err, "ssd_scan")
    return y, st
