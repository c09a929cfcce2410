"""Mixture-of-Experts layer: top-k router with capacity-based dispatch.

The port of ``repro.models.moe``.  Each expert processes at most
``capacity`` (token, k) assignments per sequence (one group per row of
the batch); the rest are dropped and fall back to the residual stream.
The same rules as the reference:

* capacity ``max(1, int(capacity_factor * S * K / E))``, in Python floats;
* top-k of the softmax probabilities, ties to the lowest expert index
  (``lax.top_k``'s order: a stable descending sort here), renormalised
  over the k before the drop;
* an expert's queue in sequence-major order of the (token, k) pairs, so
  earlier tokens win slots;
* the dense one-hot dispatch and combine ``[B, S, E, C]`` in the
  activation dtype (a position past the capacity gives a zero row, as
  ``jax.nn.one_hot`` does);
* the Switch load-balance loss and the router z-loss.

The expert weights are stacked ``w_gate``/``w_up [E, d, F]`` and
``w_down [E, F, d]`` in the reference's ``[in, out]`` layout, and the
expert products are ``torch.bmm`` over ``E`` on those tensors as they
lie: a step reads each expert's weights once and copies none of them.
``w_router [d, E]`` stays float32 in a bfloat16 model, as the norm
scales do.  Covers qwen3-moe-30b-a3b (128 experts, top-8, d_ff 768) and
dbrx-132b (16 experts, top-4, d_ff 10752).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import MoEConfig


def capacity_for(cfg: MoEConfig, S: int) -> int:
    """Slots per expert and sequence for an S-token call."""
    return max(1, int(cfg.capacity_factor * S * cfg.top_k / cfg.n_experts))


class Route(NamedTuple):
    """What the router decided for x [B, S, d]."""
    logits: torch.Tensor     # [B,S,E] float32
    probs: torch.Tensor      # [B,S,E] float32 softmax
    gate_idx: torch.Tensor   # [B,S,K] int64, experts by falling probability
    gate_vals: torch.Tensor  # [B,S,K] float32, renormalised, 0 where dropped
    pos: torch.Tensor        # [B,S,K] int64, place in the expert's queue
    keep: torch.Tensor       # [B,S,K] bool, pos < capacity
    margin: torch.Tensor     # [B,S] float32, k-th minus (k+1)-th probability
    capacity: int


def route(w_router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig,
          capacity: Optional[int] = None) -> Route:
    """Top-k routing with the capacity rule (the reference's lines up to
    the token-drop mask)."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity_for(cfg, S) if capacity is None else capacity
    logits = x.float() @ w_router                              # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts equal probabilities in index order
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :K], idx[..., :K]
    margin = (vals[..., K - 1] - vals[..., K] if K < E
              else torch.full_like(vals[..., 0], math.inf))
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # place of each (token, k) in its expert's queue, in sequence-major
    # order of the flattened (token, k) pairs
    flat = F.one_hot(gate_idx.reshape(B, S * K), E)            # [B,SK,E]
    before = torch.cumsum(flat, dim=1) - flat
    pos = before.gather(2, gate_idx.reshape(B, S * K, 1)).reshape(B, S, K)
    keep = pos < C
    return Route(logits, probs, gate_idx, gate_vals * keep, pos, keep,
                 margin, C)


def moe(params: dict, x: torch.Tensor, cfg: MoEConfig,
        capacity: Optional[int] = None, with_aux: bool = True
        ) -> tuple[torch.Tensor, dict]:
    """Apply the MoE layer.  x: [B,S,d] -> (y [B,S,d], aux losses).

    ``params`` holds ``w_router``, ``w_gate``, ``w_up`` and ``w_down``.
    The aux dict has ``moe_aux`` (load balance), ``moe_z`` (router z)
    and ``moe_drop_frac``, float32 scalars; it is empty unless
    ``with_aux`` (the serving path drops the losses, as XLA drops the
    reference's unused ones).
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    r = route(params["w_router"], x, cfg, capacity)
    C = r.capacity
    dt = x.dtype
    # dispatch / combine [B,S,E,C], one nonzero term per entry (the k
    # experts of a token are distinct), so exact in any dtype
    assign = F.one_hot(r.gate_idx, E).to(dt)                   # [B,S,K,E]
    pos_oh = (r.pos[..., None] == torch.arange(C, device=x.device)
              ).to(dt)                                         # [B,S,K,C]
    disp = torch.einsum("bske,bskc->bsec", assign,
                        pos_oh * r.keep[..., None].to(dt))
    comb = torch.einsum("bske,bskc->bsec", assign,
                        pos_oh * r.gate_vals.to(dt)[..., None])

    # expert products: [E, B*C, d] against the stacked weights
    xe = torch.einsum("bsec,bsd->ebcd", disp, x).reshape(E, B * C, d)
    g = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    ye = torch.bmm(F.silu(g) * u, params["w_down"])            # [E,BC,d]
    y = torch.einsum("bsec,ebcd->bsd", comb, ye.reshape(E, B, C, d))
    if not with_aux:
        return y, {}

    # load balance (Switch): E * sum_e f_e * p_e; router z-loss
    me = r.probs.mean(dim=(0, 1))
    fe = assign.float().sum(dim=2).mean(dim=(0, 1))
    aux = cfg.aux_loss * E * torch.sum(me * fe)
    z = cfg.router_z_loss * torch.logsumexp(r.logits, dim=-1).square().mean()
    return y, {"moe_aux": aux, "moe_z": z,
               "moe_drop_frac": 1.0 - r.keep.float().mean()}


class MoE(nn.Module):
    """The MoE feed-forward of one block (``init_moe``'s parameters)."""

    def __init__(self, d: int, cfg: MoEConfig, device, dtype):
        super().__init__()
        E, Fe = cfg.n_experts, cfg.d_ff_expert
        self.cfg = cfg
        self.w_router = nn.Parameter(torch.empty(d, E, dtype=torch.float32,
                                                 device=device))
        self.w_gate = nn.Parameter(torch.empty(E, d, Fe, dtype=dtype,
                                               device=device))
        self.w_up = nn.Parameter(torch.empty(E, d, Fe, dtype=dtype,
                                             device=device))
        self.w_down = nn.Parameter(torch.empty(E, Fe, d, dtype=dtype,
                                               device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # fan-in d for the router and gate/up, F for down
        L.dense_init_(self.w_router, generator,
                      fan_in=self.w_router.shape[0])
        for w in (self.w_gate, self.w_up, self.w_down):
            L.dense_init_(w, generator)

    def forward(self, x: torch.Tensor, with_aux: bool = True
                ) -> tuple[torch.Tensor, dict]:
        return moe({"w_router": self.w_router, "w_gate": self.w_gate,
                    "w_up": self.w_up, "w_down": self.w_down}, x, self.cfg,
                   with_aux=with_aux)
