"""Plain PyTorch version of the SSD intra-chunk kernel.

The same function as ``csrc/ssd_scan.cu`` and as the TPU kernel it
replaces (``repro.kernels.ssd_scan.kernel.ssd_intra_chunk_pallas``), a
copy of ``repro.kernels.ssd_scan.ref.ssd_intra_chunk_ref``: per (batch,
chunk, head)

  y[l]  = sum_{m <= l} (C[l] . B[m]) * exp(cum[l] - cum[m]) * dt[m] * x[m]
  S     = sum_m exp(tot - cum[m]) * dt[m] * B[m] (x) x[m]

in float32, with the decay masked to -inf above the diagonal before the
exponential.  It is also the plain intra-chunk step of
``repro_torch.models.mamba2.ssd_chunked``.
"""
from __future__ import annotations

import torch


def check_shapes(xc: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
                 tot: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor
                 ) -> None:
    if xc.dim() != 5 or Bc.dim() != 5:
        raise ValueError(f"expected xc [b,nc,Q,H,P] and Bc, Cc "
                         f"[b,nc,Q,G,N], got {tuple(xc.shape)}, "
                         f"{tuple(Bc.shape)}")
    b, nc, Q, H, P = xc.shape
    G = Bc.shape[3]
    if (tuple(dtc.shape) != (b, nc, Q, H) or cum.shape != dtc.shape
            or tuple(tot.shape) != (b, nc, H) or Cc.shape != Bc.shape
            or tuple(Bc.shape[:3]) != (b, nc, Q) or G < 1 or H % G):
        raise ValueError(
            f"shapes do not fit xc {tuple(xc.shape)}: dtc "
            f"{tuple(dtc.shape)}, cum {tuple(cum.shape)}, tot "
            f"{tuple(tot.shape)}, Bc {tuple(Bc.shape)}, Cc "
            f"{tuple(Cc.shape)} (G must divide H)")


def ssd_intra_chunk_ref(xc: torch.Tensor, dtc: torch.Tensor,
                        cum: torch.Tensor, tot: torch.Tensor,
                        Bc: torch.Tensor, Cc: torch.Tensor):
    """xc [b,nc,Q,H,P], dtc/cum [b,nc,Q,H], tot [b,nc,H], Bc/Cc
    [b,nc,Q,G,N] -> (y_intra [b,nc,Q,H,P], states [b,nc,H,P,N]), f32."""
    check_shapes(xc, dtc, cum, tot, Bc, Cc)
    b, nc, Q, H, P = xc.shape
    R = H // Bc.shape[3]
    xf, dtf, cumf = xc.float(), dtc.float(), cum.float()
    dec = cumf[:, :, :, None, :] - cumf[:, :, None, :, :]     # [b,nc,Q,Q,H]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=xc.device).tril()
    dec = dec.masked_fill(~mask[None, None, :, :, None], float("-inf"))
    s = torch.einsum("bclgn,bcmgn->bclmg", Cc.float(), Bc.float())
    s = s.repeat_interleave(R, dim=-1)                        # [b,nc,Q,Q,H]
    w = s * torch.exp(dec) * dtf[:, :, None, :, :]
    y = torch.einsum("bclmh,bcmhp->bclhp", w, xf)
    decay_to_end = torch.exp(tot.float()[:, :, None, :] - cumf)
    wB = Bc.float().repeat_interleave(R, dim=3)               # [b,nc,Q,H,N]
    states = torch.einsum("bcqh,bcqh,bcqhn,bcqhp->bchpn",
                          decay_to_end, dtf, wB, xf)
    return y, states
