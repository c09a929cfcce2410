"""Gradient compression: int8 block-scaled quantization with error feedback.

The port of ``repro.train.compression`` (one process; the cross-pod
``compressed_psum`` waits for the sharded port).  Mechanics
(1-bit-Adam-family error feedback):

  e_t  = g_t + e_{t-1}         (carry the residual)
  q_t  = Q(e_t)                (int8, one scale per block of 256)
  e_t <- e_t - deQ(q_t)        (store what quantization lost)

The blocks run over each reference leaf flattened in the reference's
layout (``repro_torch.train.leaves``: stacked layers, weights ``[in,
out]``), and ``ef`` is kept per reference leaf in that layout, so the
blocks, the scales and the residuals are the reference's.
"""
from __future__ import annotations

import torch

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
        out[leaf.key] = torch.zeros(LV.ref_shape(leaf, p.shape),
                                    dtype=torch.float32, device=p.device)
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
        qg = roundtrip(tot)
        ef[leaf.key] = tot - qg
        for name, piece in zip(leaf.names, LV.from_ref(leaf, qg)):
            out[name] = piece.contiguous()
    return out, state
