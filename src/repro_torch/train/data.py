"""Deterministic, resumable synthetic LM data.

The port of ``repro.train.data``.  Every batch is a pure function of
``(seed, step)``: restart at step k and batch k comes back exactly.  The
reference draws with JAX's threefry, whose bits torch cannot give; the
port draws from an explicit numpy ``Generator`` seeded with ``(seed,
step)`` on the host, so a run on the CPU and one on the card see the
same batch, and keeps the reference's distribution and properties:

* tokens are a Zipf-like marginal over the vocab (u^4 warping of
  uniform samples);
* every even position past the first repeats its predecessor through
  ``(t * 31 + 7) mod max(V // 2, 2)``, so the LM loss can fall;
* labels are the tokens shifted by one;
* vlm: ``vision_embeds [B, n_prefix, d]`` in bfloat16 (standard normal
  times 0.02), and the prefix's labels are -1 (masked);
* audio: ``frames [B, S, d]`` in bfloat16 (the same law) and Zipf labels.

Batches are CPU tensors (tokens and labels int64); the train step moves
them to the model's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "lm"          # lm | audio | vlm
    d_model: int = 0          # audio/vlm embedding dim
    n_prefix: int = 0         # vlm


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-like marginal via u^4 warping of uniform samples (float32,
    as the reference)."""
    u = rng.random(shape, dtype=np.float32)
    r = np.floor((u ** np.float32(4.0)) * np.float32(vocab)).astype(np.int64)
    return np.clip(r, 0, vocab - 1)


def _embeds(rng: np.random.Generator, shape) -> torch.Tensor:
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return x.to(torch.bfloat16) * 0.02


def make_batch(cfg: DataConfig, step: int) -> dict:
    rng = np.random.default_rng([cfg.seed, int(step)])
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    if cfg.kind == "audio":
        frames = _embeds(rng, (B, S, cfg.d_model))
        labels = _zipf_tokens(rng, (B, S), V)
        return {"frames": frames, "labels": torch.from_numpy(labels)}

    tokens = _zipf_tokens(rng, (B, S + 1), V)
    # light Markov structure: every even position repeats its predecessor
    # mod vocab//2, giving the model something learnable
    pos = np.arange(S + 1)[None, :]
    tokens = np.where((pos % 2 == 0) & (pos > 0),
                      (np.roll(tokens, 1, axis=1) * 31 + 7) % max(V // 2, 2),
                      tokens)
    batch = {"tokens": torch.from_numpy(tokens[:, :S].copy()),
             "labels": torch.from_numpy(tokens[:, 1:S + 1].copy())}
    if cfg.kind == "vlm":
        batch["vision_embeds"] = _embeds(rng, (B, cfg.n_prefix, cfg.d_model))
        batch["labels"][:, :cfg.n_prefix] = -1
    return batch


class DataIterator:
    """Stateful wrapper with exact checkpoint/resume (state = step index)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = make_batch(self.cfg, self.step)
        self.step += 1
        return b

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, st: dict):
        if st["seed"] != self.cfg.seed:
            raise ValueError(f"seed mismatch on resume: checkpoint "
                             f"{st['seed']}, data {self.cfg.seed}")
        self.step = int(st["step"])
