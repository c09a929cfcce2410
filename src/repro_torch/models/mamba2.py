"""Mamba2 (SSD, state-space duality) blocks in PyTorch.

The port of ``repro.models.mamba2``.  Prefill and the full-sequence
forward split the sequence into chunks of length ``Q``: within a chunk the
quadratic (attention-dual) form runs in the ``ssd_scan`` kernel
(``impl="kernel"``; its plain version on CPU tensors) or as the plain
einsums (``impl="plain"``); across chunks a loop carries the ``[H,P,N]``
state.  Decode is the O(1) recurrent form ``h = a*h + dt * B (x) x``; its
state is the SSM state plus the depthwise-conv tail.

The reference sends only its full-sequence forward through the Pallas
kernel (its serving prefill always takes the jnp intra-chunk); the two
compute the same function, and the port sends both forward and prefill
through the kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
from repro_torch.models import layers as L
from repro_torch.models.config import SSMConfig
from repro_torch.sharding.plan import contiguous_stride, shard, to_placements


def ssm_dims(d_model: int, cfg: SSMConfig) -> tuple[int, int]:
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    return d_inner, n_heads


# ---------------------------------------------------------------------------
# Chunked SSD (forward / prefill)
# ---------------------------------------------------------------------------


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, Q: int,
                h0: Optional[torch.Tensor] = None, impl: str = "kernel"):
    """Chunk-parallel SSD.

    x:  [b, S, H, P]   inputs per head
    dt: [b, S, H]      positive step sizes
    A:  [H]            negative decay rates (a = exp(A*dt))
    B:  [b, S, G, N]   input projections (G groups, heads share within group)
    C:  [b, S, G, N]   output projections
    returns (y: [b,S,H,P] in x's dtype, h_final: [b,H,P,N] float32)

    DTensor inputs (under a sharding plan) run ``ssd_sharded``.
    """
    if isinstance(x, DTensor):
        return ssd_sharded(x, dt, A, B, C, Q, h0, impl)
    b, S_real, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R = H // G
    # pad a ragged tail with dt=0 steps (decay 1, zero contribution: the
    # final state and the real outputs are unaffected)
    rem = S_real % Q
    if rem:
        pad = Q - rem
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    S = x.shape[1]
    nc = S // Q

    xc = x.float().reshape(b, nc, Q, H, P)
    dtc = dt.float().reshape(b, nc, Q, H)
    Bc = B.float().reshape(b, nc, Q, G, N)
    Cc = C.float().reshape(b, nc, Q, G, N)
    la = A[None, None, None, :] * dtc                          # log a_t
    cum = torch.cumsum(la, dim=2)                              # [b,nc,Q,H]
    tot = cum[:, :, -1, :]                                     # [b,nc,H]

    if impl == "kernel":
        y_intra, states = ssd_ops.ssd_intra_chunk(
            xc.contiguous(), dtc.contiguous(), cum, tot.contiguous(),
            Bc.contiguous(), Cc.contiguous())
    elif impl == "plain":
        y_intra, states = ssd_intra_chunk_ref(xc, dtc, cum, tot, Bc, Cc)
    else:
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")

    # inter-chunk recurrence: the state entering each chunk
    h = (torch.zeros(b, H, P, N, dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(tot[:, c])[:, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                        # [b,nc,H,P,N]

    # inter-chunk contribution: C_l . (exp(cum[l]) * h_prev)
    Ch = Cc.repeat_interleave(R, dim=3)                        # [b,nc,Q,H,N]
    y_inter = torch.einsum("bcqhn,bcqh,bchpn->bcqhp", Ch, torch.exp(cum),
                           h_prev)
    y = (y_intra + y_inter).reshape(b, S, H, P)
    return y[:, :S_real].to(x.dtype), h


def ssd_sharded(x: DTensor, dt, A, B, C, Q: int, h0=None, impl="kernel"):
    """``ssd_chunked`` on DTensors, run on each rank's own shard.

    The scan is independent per sequence and per head, so each rank
    runs it on its batch rows and heads: x and dt keep their batch and
    head placements (the sequence and the head dim are gathered: the
    chunk recurrence runs along the whole sequence), A takes the same
    heads, and B and C (shared by the heads of a group) are whole over
    the head-sharding mesh dims, where their gradient is a partial sum.
    DTensor's own propagation of the chunked einsums over a 3-D mesh
    costs seconds an op; here it sees none of them.
    """
    if h0 is not None:
        raise NotImplementedError("a sharded SSD starts from zero state")
    mesh = x.device_mesh
    pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
          for p in x.placements]
    heads = [p.is_shard(2) for p in pl]
    G, H = B.shape[2], x.shape[2]
    if G > 1 and any(heads):
        raise NotImplementedError(f"{G} B/C groups with the heads sharded")
    x = to_placements(x, mesh, pl)
    dt = to_placements(dt, mesh, pl)
    A = to_placements(A, mesh, [Shard(0) if h else Replicate()
                                for h in heads])
    bpl = [p if p.is_shard(0) else Replicate() for p in pl]
    bgrad = [Partial() if h else p for h, p in zip(heads, bpl)]
    B, C = (to_placements(t, mesh, bpl).to_local(grad_placements=bgrad)
            for t in (B, C))
    y, h = ssd_chunked(x.to_local(), dt.to_local(), A.to_local(), B, C, Q,
                       impl=impl)
    b, S, _, P = x.shape
    N = B.shape[-1]
    hpl = [Shard(1) if hh else p for hh, p in zip(heads, bpl)]
    return (DTensor.from_local(y.contiguous(), mesh, pl, shape=x.shape,
                               stride=contiguous_stride(x.shape)),
            DTensor.from_local(h.contiguous(), mesh, hpl,
                               shape=torch.Size((b, H, P, N)),
                               stride=contiguous_stride((b, H, P, N))))


def ssd_reference(x, dt, A, B, C, h0: Optional[torch.Tensor] = None):
    """O(S) sequential oracle (tests only): the plain recurrence."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R = H // G
    h = (torch.zeros(b, H, P, N, dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    Bh = B.float().repeat_interleave(R, dim=2)
    Ch = C.float().repeat_interleave(R, dim=2)
    dtf = dt.float()
    a = torch.exp(A[None, None, :] * dtf)                      # [b,S,H]
    xf = x.float()
    ys = []
    for t in range(S):
        h = (h * a[:, t, :, None, None]
             + (dtf[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


# ---------------------------------------------------------------------------
# The Mamba2 block (forward / prefill + decode step)
# ---------------------------------------------------------------------------


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  seq: [B,S,ch], w: [W,ch] -> [B,S,ch].

    ``tail`` ([B,W-1,ch]) supplies state from previous tokens (decode).
    ``out[t] = sum_i padded[t+i] * w[i]``, summed in the input's dtype as
    the reference does (no cuDNN, whose float32 convolutions run in TF32
    by default).
    """
    W, S = w.shape[0], seq.shape[1]
    if tail is None:
        tail = seq.new_zeros(seq.shape[0], W - 1, seq.shape[2])
    padded = torch.cat([tail, seq], dim=1)
    out = padded[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + padded[:, i:i + S] * w[i]
    return F.silu(out + b)


def _split_proj(proj: torch.Tensor, d_inner: int, G: int, N: int):
    """in_proj's output -> (z, x, B, C, dt) along the last axis."""
    return torch.split(proj, [d_inner, d_inner, G * N, G * N,
                              proj.shape[-1] - 2 * d_inner - 2 * G * N],
                       dim=-1)


class MambaBlock(nn.Module):
    """One Mamba2 mixer: ``forward`` is the reference's ``mamba_block``
    (returning the decode state as its ``_mamba_prefill_states`` does),
    ``step`` its ``mamba_block_step``."""

    def __init__(self, d_model: int, cfg: SSMConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        d_inner, H = ssm_dims(d_model, cfg)
        G, N, W = cfg.n_groups, cfg.d_state, cfg.conv_width
        self.d_inner, self.n_heads = d_inner, H
        conv_ch = d_inner + 2 * G * N               # conv over x, B, C
        self.in_proj = L.linear(d_model, 2 * d_inner + 2 * G * N + H, False,
                                device, dtype)      # z, x, B, C, dt
        self.conv_w = nn.Parameter(torch.empty(W, conv_ch, device=device,
                                               dtype=dtype))
        self.conv_b = nn.Parameter(torch.empty(conv_ch, device=device,
                                               dtype=dtype))
        f32 = dict(device=device, dtype=torch.float32)
        self.A_log = nn.Parameter(torch.empty(H, **f32))
        self.dt_bias = nn.Parameter(torch.empty(H, **f32))
        self.D = nn.Parameter(torch.empty(H, **f32))
        # rms_norm's default eps, as the reference (not cfg.norm_eps)
        self.gate_norm = L.RMSNorm(d_inner, 1e-6, device)
        self.out_proj = L.linear(d_inner, d_model, False, device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg, H = self.cfg, self.n_heads
        L.dense_init_(self.in_proj.weight, generator)
        w = torch.empty(self.conv_w.shape, dtype=torch.float32,
                        device=self.conv_w.device)
        w.normal_(generator=generator)
        self.conv_w.copy_(w / math.sqrt(cfg.conv_width))
        self.conv_b.zero_()
        # dt bias: softplus^-1 of log-uniform[dt_min, dt_max] (Mamba init)
        u = torch.empty(H, dtype=torch.float32, device=self.dt_bias.device)
        u.uniform_(generator=generator)
        lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
        dt0 = torch.exp(u * (hi - lo) + lo)
        self.dt_bias.copy_(dt0 + torch.log(-torch.expm1(-dt0)))
        self.A_log.copy_(torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                                device=self.A_log.device)))
        self.D.fill_(1.0)
        self.gate_norm.scale.fill_(1.0)
        L.dense_init_(self.out_proj.weight, generator)

    def _conv_in(self, x: torch.Tensor):
        """x [B,S,d] -> (z, conv_in [B,S,ch], dt) from in_proj."""
        c = self.cfg
        # the fused z/x/B/C/dt dim stays whole (its pieces lie at
        # unaligned offsets; heads shard after the split), and so does
        # the sequence (the causal conv runs along it)
        proj = shard(self.in_proj(x), "batch", None, None)
        z, xs, Bv, Cv, dt = _split_proj(proj, self.d_inner, c.n_groups,
                                        c.d_state)
        return z, torch.cat([xs, Bv, Cv], dim=-1), dt

    def _split_conv(self, conv_out: torch.Tensor):
        GN = self.cfg.n_groups * self.cfg.d_state
        di = self.d_inner
        return (conv_out[..., :di], conv_out[..., di:di + GN],
                conv_out[..., di + GN:])

    def forward(self, x: torch.Tensor, impl: str = "kernel"):
        """Full sequence: x [B,S,d] -> (y [B,S,d], {"h": [B,H,P,N] f32,
        "conv_tail": [B,W-1,ch]})."""
        c = self.cfg
        Bsz, S, _ = x.shape
        H, P, G, N, W = (self.n_heads, c.head_dim, c.n_groups, c.d_state,
                         c.conv_width)
        z, conv_in, dt = self._conv_in(x)
        # the last W-1 conv inputs, left-padded with zeros when S < W-1
        conv_tail = (conv_in[:, S - (W - 1):] if S >= W - 1
                     else F.pad(conv_in, (0, 0, W - 1 - S, 0)))
        xs, Bv, Cv = self._split_conv(
            _causal_conv(conv_in, self.conv_w, self.conv_b))
        xs = shard(xs.reshape(Bsz, S, H, P), "batch", "seq", "heads",
                   "head_dim")
        dt = shard(F.softplus(dt.float() + self.dt_bias), "batch", "seq",
                   "heads")
        A = -torch.exp(self.A_log)
        y, h = ssd_chunked(xs, dt, A, Bv.reshape(Bsz, S, G, N),
                           Cv.reshape(Bsz, S, G, N), Q=min(c.chunk, S),
                           impl=impl)
        y = shard(y, "batch", "seq", "heads", "head_dim")
        # D is float32: y becomes float32 here, as in the reference
        y = y + xs * self.D[None, None, :, None]
        y = self.gate_norm(y.reshape(Bsz, S, self.d_inner) * F.silu(z))
        # the reference's einsum promotes the weight to y's float32
        y = F.linear(y, self.out_proj.weight.to(y.dtype))
        return y, {"h": h, "conv_tail": conv_tail.contiguous()}

    def step(self, x: torch.Tensor, h: torch.Tensor, tail: torch.Tensor):
        """One token: x [B,1,d], h [B,H,P,N] f32, tail [B,W-1,ch] ->
        (y [B,1,d], new h, new tail).  Under a plan (a DTensor state)
        the recurrence runs on each rank's rows and heads
        (``_recur_sharded``)."""
        Bsz = x.shape[0]
        z, conv_in, dt = self._conv_in(x)
        conv_out = _causal_conv(conv_in, self.conv_w, self.conv_b, tail=tail)
        new_tail = torch.cat([tail[:, 1:], conv_in.to(tail.dtype)], dim=1)
        xs, Bv, Cv = self._split_conv(conv_out)
        dt = dt.reshape(Bsz, self.n_heads)
        if isinstance(h, DTensor):
            y, h = self._recur_sharded(
                xs.reshape(Bsz, self.n_heads, self.cfg.head_dim),
                Bv.reshape(Bsz, -1), Cv.reshape(Bsz, -1), dt, h)
        else:
            y, h = self._recur(xs, Bv, Cv, dt, h, self.A_log, self.D,
                               self.dt_bias)
        # cast back BEFORE the gate norm, as the reference's step does
        y = y.reshape(Bsz, 1, self.d_inner).to(x.dtype)
        y = self.out_proj(self.gate_norm(y * F.silu(z)))
        return y, h, new_tail

    def _recur(self, xs, Bv, Cv, dt, h, A_log, D, dt_bias):
        """The recurrence on plain tensors of H' heads: xs [B, ..., H'*P],
        Bv/Cv [B, G'*N], dt [B,H'] (before softplus), h [B,H',P,N]."""
        c = self.cfg
        Bsz, H = dt.shape
        P, N = c.head_dim, c.d_state
        G = Bv.shape[-1] // N
        xs = xs.reshape(Bsz, H, P).float()
        R = H // G
        Bh = Bv.reshape(Bsz, G, N).float().repeat_interleave(R, dim=1)
        Ch = Cv.reshape(Bsz, G, N).float().repeat_interleave(R, dim=1)
        dt = F.softplus(dt.float() + dt_bias)
        a = torch.exp(-torch.exp(A_log)[None, :] * dt)         # [B,H]
        h = (h * a[:, :, None, None]
             + (dt[:, :, None] * xs)[..., None] * Bh[:, :, None, :])
        y = torch.einsum("bhn,bhpn->bhp", Ch, h)
        return y + xs * D[None, :, None], h

    def _recur_sharded(self, xs, Bv, Cv, dt, h: DTensor):
        """``_recur`` on each rank's batch rows and heads (h's
        placements), B and C whole (one group); serving only."""
        if self.cfg.n_groups > 1 and any(p.is_shard(1)
                                         for p in h.placements):
            raise NotImplementedError("B/C groups with the heads sharded")
        mesh = h.device_mesh
        Bsz, H = dt.shape
        hpl = [p if p.is_shard(0) or p.is_shard(1) else Replicate()
               for p in h.placements]
        bpl = [p if p.is_shard(0) else Replicate() for p in hpl]
        wpl = [Shard(0) if p.is_shard(1) else Replicate() for p in hpl]

        def local(t, pl):
            return to_placements(t, mesh, pl).to_local()
        y, h = self._recur(local(xs, hpl), local(Bv, bpl), local(Cv, bpl),
                           local(dt, hpl), local(h, hpl),
                           *(local(w, wpl) for w in (self.A_log, self.D,
                                                     self.dt_bias)))
        P = self.cfg.head_dim
        shape = (Bsz, H, P)
        hshape = (Bsz, H, P, self.cfg.d_state)
        return (DTensor.from_local(y.contiguous(), mesh, hpl,
                                   shape=torch.Size(shape),
                                   stride=contiguous_stride(shape)),
                DTensor.from_local(h.contiguous(), mesh, hpl,
                                   shape=torch.Size(hshape),
                                   stride=contiguous_stride(hshape)))
