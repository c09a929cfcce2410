"""Optimizers over the port's model, updating in place.

The port of ``repro.train.optimizer``:

* ``adamw``     — AdamW with decoupled weight decay; ``m`` and ``v`` are
                  float32 and shaped like each parameter.
* ``adafactor`` — factored second moment (row and column statistics for
                  leaves of two or more axes), beta1 = 0.

The reference is a pure function of (grads, state, params) whose output
XLA writes over its input; here ``update(grads, state, model)`` changes
the optimizer state and the parameters in place, one tensor (AdamW) or
one reference leaf (Adafactor) at a time, so that at full width only
that tensor's float32 temporaries are live.  ``grads`` maps the model's
parameter names to gradients in any float dtype.

The reference's arithmetic is kept, quirks included:

* AdamW's warmup counts the step twice: ``c = count + 1`` and the
  schedule takes ``(c + 1) / warmup``, so step 1 runs at ``2 lr /
  warmup``;
* weight decay covers every parameter, norm scales and biases too;
* the update is rounded to the parameter's dtype and then added in it;
* Adafactor's statistics, its update clip and its parameter-RMS scale
  are taken over the reference's leaves (``repro_torch.train.leaves``):
  a stacked ``[L, ...]`` leaf spans every layer, weights are ``[in,
  out]``, and a stacked norm scale ``[L, d]`` is factored.

On a sharded model (DTensor parameters) AdamW's moments take their
parameter's placements; Adafactor's statistics are replicated, as the
reference's rules leave them, and its means over a sharded leaf are
all-reduced by DTensor.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.sharding.plan import zeros_like_placed
from repro_torch.train import leaves as LV


class Optimizer(NamedTuple):
    init: Callable          # model -> opt_state
    update: Callable        # (grads, opt_state, model) -> None, in place


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact)."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          warmup_steps: int = 100) -> Optimizer:
    def init(model) -> dict:
        def zeros():
            # a sharded parameter's moments take its placements
            return {n: torch.zeros_like(
                        p, dtype=torch.float32,
                        memory_format=torch.contiguous_format)
                    for n, p in model.named_parameters()}
        return {"m": zeros(), "v": zeros(), "count": 0}

    def scalars(c: int) -> tuple:
        """lr_t and the two bias corrections of step ``c``, in float32
        as the reference computes them."""
        f = np.float32
        warm = min(f(1.0), f(c + 1) / f(max(warmup_steps, 1)))
        lr_t = f(lr) * warm
        bc1 = f(1.0) - f(b1) ** f(c)
        bc2 = f(1.0) - f(b2) ** f(c)
        return float(lr_t), float(bc1), float(bc2)

    @torch.no_grad()
    def update(grads: dict, state: dict, model) -> None:
        c = state["count"] + 1
        lr_t, bc1, bc2 = scalars(c)
        for name, p in model.named_parameters():
            g = grads[name].float()
            m, v = state["m"][name], state["v"][name]
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(torch.square(g) * (1 - b2))
            del g
            u = (m / bc1) / ((v / bc2).sqrt_().add_(eps))
            u.add_(p.float() * weight_decay).mul_(-lr_t)
            p.add_(u.to(p.dtype))
        state["count"] = c

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018) — beta1=0, factored second moments
# ---------------------------------------------------------------------------


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps1: float = 1e-30,
              eps2: float = 1e-3, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, warmup_steps: int = 100
              ) -> Optimizer:
    def init(model) -> dict:
        params = dict(model.named_parameters())
        f = {}
        for leaf in LV.param_leaves(model.cfg):
            p = params[leaf.names[0]]
            shape = LV.ref_shape(leaf, p.shape)
            # replicated on a sharded model's mesh, as the reference's
            # rules leave them
            if len(shape) >= 2:
                f[leaf.key] = {"vr": zeros_like_placed(shape[:-1], p),
                               "vc": zeros_like_placed(shape[:-2]
                                                       + shape[-1:], p)}
            else:
                f[leaf.key] = {"v": zeros_like_placed(shape, p)}
        return {"f": f, "count": 0}

    @torch.no_grad()
    def update(grads: dict, state: dict, model) -> None:
        c = state["count"] + 1
        cf = np.float32(c)
        beta2 = _f32(np.float32(1.0) - cf ** np.float32(-decay))
        one_m = _f32(np.float32(1.0) - np.float32(beta2))
        warm = min(np.float32(1.0), cf / np.float32(max(warmup_steps, 1)))
        lr_t = _f32(np.float32(lr) * warm)
        params = dict(model.named_parameters())
        for leaf in LV.param_leaves(model.cfg):
            ps = [params[n] for n in leaf.names]
            g = LV.to_ref(leaf, [grads[n] for n in leaf.names]).float()
            s = state["f"][leaf.key]
            g2 = g.square().add_(eps1)
            if "vr" in s:
                vr = s["vr"].mul_(beta2).add_(g2.mean(dim=-1) * one_m)
                vc = s["vc"].mul_(beta2).add_(g2.mean(dim=-2) * one_m)
                r = vr / vr.mean(dim=-1, keepdim=True).clamp_min(eps1)
                u = g / (r.sqrt()[..., None] * vc.sqrt()[..., None, :]
                         + eps1)
            else:
                v = s["v"].mul_(beta2).add_(g2 * one_m)
                u = g / (v.sqrt() + eps1)
            del g, g2
            # update clipping (RMS of update <= clip_threshold)
            rms = torch.sqrt(u.square().mean() + eps1)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            p32 = LV.to_ref(leaf, ps).float()
            scale = torch.clamp_min(torch.sqrt(p32.square().mean()), eps2)
            upd = (scale * -lr_t) * u
            if weight_decay:
                upd = upd - lr_t * weight_decay * p32
            upd = upd.to(ps[0].dtype)
            for p, piece in zip(ps, LV.from_ref(leaf, upd)):
                p.add_(piece)
        state["count"] = c

    return Optimizer(init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
