"""Modality frontends: stubs, as in the reference.

The port of ``repro.models.frontends``.  The vlm and audio architectures
specify the transformer backbone only; these helpers make deterministic
synthetic patch and frame embeddings of the right shapes from an explicit
``torch.Generator`` (their values cannot match ``jax.random``'s; tests
pass the reference's arrays in).  A real deployment would put a ViT tower
or a conv feature extractor here.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def _normal(cfg: ModelConfig, generator: torch.Generator, shape
            ) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.to(getattr(torch, cfg.dtype)) * 0.02


def synth_vision_embeds(cfg: ModelConfig, generator: torch.Generator,
                        batch: int) -> torch.Tensor:
    """[B, n_prefix, d_model] patch embeddings (llava anyres tiling stub),
    on the generator's device."""
    if cfg.family != "vlm":
        raise ValueError(f"{cfg.name} is {cfg.family}, not vlm")
    return _normal(cfg, generator, (batch, cfg.n_prefix, cfg.d_model))


def synth_audio_frames(cfg: ModelConfig, generator: torch.Generator,
                       batch: int, n_frames: int) -> torch.Tensor:
    """[B, S, d_model] frame embeddings (wav2vec2-style conv frontend
    stub), on the generator's device."""
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name} is {cfg.family}, not audio")
    return _normal(cfg, generator, (batch, n_frames, cfg.d_model))
