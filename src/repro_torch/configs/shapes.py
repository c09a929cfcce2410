"""Assigned input shapes and per-cell input specs (meta tensors only).

A copy of ``repro.configs.shapes``.  The four LM shapes (seq_len x
global_batch):

  train_4k     4,096 x 256   -> the train step
  prefill_32k  32,768 x 32   -> prefill (the forward for audio)
  decode_32k   32,768 x 128  -> the decode step (1 token, full cache)
  long_500k    524,288 x 1   -> the decode step; SSM/hybrid only

Skips:
  * encoder-only (hubert) has no decode step -> decode_32k/long_500k
  * pure full-attention archs skip long_500k (quadratic prefill)

``input_specs`` returns tensors on the ``meta`` device where the
reference returns ``ShapeDtypeStruct``: shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    sh = SHAPES[shape_name]
    if sh.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape_name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("pure full-attention arch; 500k decode needs "
                       "sub-quadratic state")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str,
                batch_override: int | None = None,
                seq_override: int | None = None) -> dict:
    """Meta-tensor stand-ins for every model input of this cell (no
    allocation)."""
    sh = SHAPES[shape_name]
    B = batch_override or sh.global_batch
    S = seq_override or sh.seq_len
    tok = torch.int32

    if sh.kind in ("train", "prefill"):
        if cfg.family == "audio":
            batch = {"frames": _meta((B, S, cfg.d_model), torch.bfloat16)}
        else:
            batch = {"tokens": _meta((B, S), tok)}
            if cfg.family == "vlm":
                batch["vision_embeds"] = _meta((B, cfg.n_prefix,
                                                cfg.d_model), torch.bfloat16)
        if sh.kind == "train":
            batch["labels"] = _meta((B, S), tok)
        return batch

    # decode: a cache filled to S plus one new token per sequence
    from repro_torch.models.transformer import init_cache
    return {"cache": init_cache(cfg, B, S, device="meta"),
            "tokens": _meta((B,), tok)}


def plan_rule_overrides(cfg: ModelConfig, shape_name: str) -> dict:
    """Per-cell logical-axis rule tweaks (see repro_torch.sharding.plan)."""
    sh = SHAPES[shape_name]
    rules: dict = {}
    if sh.global_batch == 1:
        # long_500k: batch of 1 cannot shard over data -- replicate batch,
        # the decode state shards over heads ("model") instead.
        rules["batch"] = None
    if sh.kind in ("train", "prefill"):
        # sequence parallelism: the residual stream shards its seq dim over
        # the model axis (Megatron-SP); attention/MLP re-gather per block.
        rules["seq"] = "model"
    return rules
