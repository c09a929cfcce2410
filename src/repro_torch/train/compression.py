"""Gradient compression: int8 block-scaled quantization with error feedback.

The port of ``repro.train.compression``.  Mechanics
(1-bit-Adam-family error feedback):

  e_t  = g_t + e_{t-1}         (carry the residual)
  q_t  = Q(e_t)                (int8, one scale per block of 256)
  e_t <- e_t - deQ(q_t)        (store what quantization lost)

The blocks run over each reference leaf flattened in the reference's
layout (``repro_torch.train.leaves``: stacked layers, weights ``[in,
out]``), and ``ef`` is kept per reference leaf in that layout, so the
blocks, the scales and the residuals are the reference's.  In a
sharded state ``ef`` takes its leaf's placements, and a sharded leaf's
blocks are formed on the leaf gathered whole (they cross shard
boundaries): one all-gather of each leaf a step, and a float32 copy of
the whole leaf on every rank meanwhile.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding.plan import to_placements, zeros_like_placed
from repro_torch.train import leaves as LV

BLOCK = 256


def quantize(x: torch.Tensor, block: int = BLOCK):
    """Per-block symmetric int8 quantization.  Returns (q [n_blocks,
    block] int8, scales [n_blocks, 1] float32)."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype=torch.float32) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def roundtrip(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    q, s = quantize(x, block)
    return dequantize(q, s, x.shape, x.dtype)


# ---------------------------------------------------------------------------
# Error feedback carried in the train state
# ---------------------------------------------------------------------------


def init_error_feedback(model) -> dict:
    """Zero residuals, one float32 tensor per reference leaf (keyed by
    the leaf's flat name) in the reference's layout."""
    params = dict(model.named_parameters())
    out = {}
    for leaf in LV.param_leaves(model.cfg):
        p = params[leaf.names[0]]
        pl = (LV.ref_placements(leaf, p.placements, p.dim())
              if isinstance(p, DTensor) else None)
        out[leaf.key] = zeros_like_placed(LV.ref_shape(leaf, p.shape), p,
                                          pl)
    return out


def apply_error_feedback(grads: dict, state: dict):
    """Quantize ``grads`` (the model's parameter names -> gradients) with
    residual carrying.  Returns (float32 gradients, state); ``state``
    gains an ``ef`` entry, changed in place on later calls."""
    model = state["model"]
    ef = state.get("ef")
    if ef is None:
        ef = state["ef"] = init_error_feedback(model)
    out = {}
    for leaf in LV.param_leaves(model.cfg):
        tot = LV.to_ref(leaf, [grads[n] for n in leaf.names]).float()
        tot = tot + ef[leaf.key]
        if isinstance(tot, DTensor):
            # the blocks run over the whole flattened leaf, across shard
            # boundaries: gathered, quantized alike on every rank, and
            # each rank keeps its chunk
            qg = to_placements(roundtrip(tot.full_tensor()),
                               tot.device_mesh, tot.placements)
        else:
            qg = roundtrip(tot)
        ef[leaf.key] = tot - qg
        for name, piece in zip(leaf.names, LV.from_ref(leaf, qg)):
            out[name] = piece.contiguous()
    return out, state


# ---------------------------------------------------------------------------
# Cross-pod compressed reduction
# ---------------------------------------------------------------------------


def compressed_psum(x: torch.Tensor, mesh, mesh_dim) -> torch.Tensor:
    """All-reduce each rank's ``x`` over one dim of ``mesh`` (a name or
    an index) with int8 block quantization: the reference's
    ``compressed_psum`` under ``shard_map``.

    Each rank quantizes locally; a MAX all-reduce gives the shared
    per-block scales, each rank re-expresses its payload in them, and
    the integer payloads are summed in int32 (as the reference's
    ``psum`` of its rescaled int32 payload; no overflow up to 2^24
    ranks), then rescaled.  An approximation of the sum of the
    dequantized values; neither train step calls it.
    """
    group = mesh.get_group(mesh_dim)
    q, s = quantize(x)
    s_max = s.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    total = torch.round(q.float() * (s / s_max)).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    flat = (total.float() * s_max).reshape(-1)
    return flat[:x.numel()].reshape(x.shape).to(x.dtype)
