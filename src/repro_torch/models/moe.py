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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import layers as L
from repro_torch.models.config import MoEConfig
from repro_torch.sharding.plan import (contiguous_stride, local_offset,
                                       to_placements)


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
    if isinstance(x, DTensor):
        return moe_sharded(params, x, cfg, capacity, with_aux)
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


def moe_sharded(params: dict, x: DTensor, cfg: MoEConfig,
                capacity: Optional[int] = None, with_aux: bool = True
                ) -> tuple[torch.Tensor, dict]:
    """``moe`` under a sharding plan: expert parallelism over the mesh
    dims that split the experts, each rank computing on its own tokens.

    Routing is per sequence, so each rank routes its batch rows (whole
    sequences: a sequence-sharded x is gathered), with the router
    gathered whole.  Each rank runs the experts it holds (gathered over
    the FSDP dims) on those rows, and its combine is a partial sum over
    the expert-sharding mesh dims, which the caller's placement
    reduces.  Where the batch is split over an expert-sharding dim the
    tokens are gathered over it first.  Gradients: the router's
    computation is the same on every expert shard, so the gate values'
    gradient (a partial sum over the experts each rank holds) is summed
    over the expert dims before it reaches the router; the tokens'
    gradient is the router's (whole) plus the experts' (partial).  The
    losses are means over all rows: sums of each rank's rows, summed
    over the batch-sharding dims.
    """
    mesh = x.device_mesh
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    wg = params["w_gate"]
    edims = [i for i, p in enumerate(wg.placements) if p.is_shard(0)]
    rep = Replicate()
    xpl = [p if p.is_shard(0) and i not in edims else rep
           for i, p in enumerate(x.placements)]
    bdims = [i for i, p in enumerate(xpl) if p.is_shard(0)]

    def partial_on(dims, pl):
        return [Partial() if i in dims else p for i, p in enumerate(pl)]

    x = to_placements(x, mesh, xpl)
    x_router = x.to_local()
    x_experts = x.to_local(grad_placements=partial_on(edims, xpl))
    whole = [rep] * mesh.ndim
    w_router = to_placements(params["w_router"], mesh, whole).to_local(
        grad_placements=partial_on(bdims, whole))
    r = route(w_router, x_router, cfg, capacity)
    C = r.capacity
    # the gate values' gradient from this rank's experts, summed over
    # the expert dims on the way back to the (replicated) router
    gate_vals = DTensor.from_local(r.gate_vals, mesh, whole).to_local(
        grad_placements=partial_on(edims, whole))

    epl = [Shard(0) if i in edims else rep for i in range(mesh.ndim)]
    egrad = partial_on(bdims, epl)
    w = {k: to_placements(params[k], mesh, epl).to_local(
            grad_placements=egrad) for k in ("w_gate", "w_up", "w_down")}
    lo, n = local_offset(wg, 0), w["w_gate"].shape[0]
    b = x_router.shape[0]
    dt = x_router.dtype
    assign = F.one_hot(r.gate_idx, E).to(dt)[..., lo:lo + n]   # [b,S,K,El]
    pos_oh = (r.pos[..., None] == torch.arange(C, device=x_router.device)
              ).to(dt)
    disp = torch.einsum("bske,bskc->bsec", assign,
                        pos_oh * r.keep[..., None].to(dt))
    comb = torch.einsum("bske,bskc->bsec", assign,
                        pos_oh * gate_vals.to(dt)[..., None])
    xe = torch.einsum("bsec,bsd->ebcd", disp, x_experts).reshape(n, b * C,
                                                                 d)
    g = torch.bmm(xe, w["w_gate"])
    u = torch.bmm(xe, w["w_up"])
    ye = torch.bmm(F.silu(g) * u, w["w_down"])
    y = torch.einsum("bsec,ebcd->bsd", comb, ye.reshape(n, b, C, d))
    y = DTensor.from_local(y.contiguous(), mesh, partial_on(edims, xpl),
                           shape=x.shape,
                           stride=contiguous_stride(x.shape))
    if not with_aux:
        return y, {}

    def row_mean(t: torch.Tensor) -> DTensor:
        """The mean over all B*S rows of a per-row quantity summed over
        this rank's rows."""
        return DTensor.from_local(t, mesh, partial_on(bdims, whole),
                                  shape=t.shape,
                                  stride=contiguous_stride(t.shape)) / (B * S)

    me = row_mean(r.probs.sum(dim=(0, 1)))
    fe = row_mean(F.one_hot(r.gate_idx, E).float().sum(dim=(0, 1, 2)))
    aux = cfg.aux_loss * E * torch.sum(me * fe)
    z = cfg.router_z_loss * row_mean(
        torch.logsumexp(r.logits, dim=-1).square().sum())
    drop = 1.0 - row_mean(r.keep.float().sum() / K)
    return y, {"moe_aux": aux, "moe_z": z, "moe_drop_frac": drop}


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
