"""Plain PyTorch version of the per-group fair-share pick.

The same function as ``csrc/group_pick.cu``: a copy of
``pick_order_argmin`` (``repro.kernels.group_pick.ref`` in the JAX
package), which equals the TPU kernel it stands beside
(``pick_order_pallas``).  Per engine group, the pool positions of the
``kmax`` smallest ``(vruntime, rid)`` keys, best first; empty slots come
in as ``(INT32_MAX, INT32_MAX)`` sentinels.

The columns past ``min(kmax, valid keys)`` are not the stable-argsort
order: a taken slot gets ``vr = INT32_MAX`` and ``avail = CAP`` but keeps
its ``rid``, so once the valid keys run out a taken slot wins the rid tie
at ``avail = CAP`` and every later column is ``CAP``.  The cluster's tick
body masks those columns (it takes ``min(free lanes, pool size)`` of
them), and this version keeps them as the reference computes them.
"""
from __future__ import annotations

import torch

IMAX = 2 ** 31 - 1


def check_shapes(vr: torch.Tensor, rid: torch.Tensor, kmax: int) -> None:
    if vr.dim() != 2 or vr.shape != rid.shape:
        raise ValueError(f"expected vr and rid of one shape [G, CAP], got "
                         f"{tuple(vr.shape)} and {tuple(rid.shape)}")
    if vr.shape[1] < 1:
        raise ValueError("CAP must be at least 1")
    if kmax < 0:
        raise ValueError(f"kmax must be >= 0, got {kmax}")


def pick_order_ref(vr: torch.Tensor, rid: torch.Tensor,
                   kmax: int) -> torch.Tensor:
    """``[G, CAP]`` int32 keys -> ``[G, kmax]`` int32 pool positions.

    ``kmax`` rounds of the three-step argmin: min vruntime, min rid among
    its ties, then the least position still available among the winners
    (``CAP`` when only taken slots remain)."""
    check_shapes(vr, rid, kmax)
    G, cap = vr.shape
    pos = torch.arange(cap, dtype=torch.int32,
                       device=vr.device).expand(G, cap)
    avail = pos
    imax = torch.full_like(vr, IMAX)
    capt = torch.full_like(vr, cap)
    cols = []
    for _ in range(kmax):
        m1 = vr.min(dim=1, keepdim=True).values
        tie_rid = torch.where(vr == m1, rid, imax)
        m2 = tie_rid.min(dim=1, keepdim=True).values
        win = (vr == m1) & (tie_rid == m2)
        p = torch.where(win, avail, capt).min(dim=1).values
        cols.append(p)
        taken = pos == p[:, None]
        vr = torch.where(taken, imax, vr)
        avail = torch.where(taken, capt, avail)
    if not cols:
        return torch.empty(G, 0, dtype=torch.int32, device=vr.device)
    return torch.stack(cols, dim=1).to(torch.int32)
