"""The training step: microbatched forward and backward, gradient
accumulation, optional int8 error feedback, then the optimizer update.

The port of ``repro.train.step``.  The train state is a dict:

* ``model``: the ``Transformer`` (its parameters are the reference's
  ``params``), built with ``attn_impl="dense"``: training runs the plain
  attention and the plain SSD step, as the reference trains on its jnp
  paths, and differentiates no hand-written kernel;
* ``opt``: the optimizer's state (``repro_torch.train.optimizer``);
* ``step``: the number of steps taken (an int);
* ``ef``: the error-feedback residuals, once ``grad_compression`` has
  run (``repro_torch.train.compression``).

``train_step(state, batch)`` changes the state in place and returns it
with ``{"loss", "grad_norm"}`` (float32 scalars on the model's device),
where the reference returns a new state and XLA reuses the old one's
buffers.  The three accumulation modes keep the reference's arithmetic:

* ``microbatch == 1``: one backward; the gradients are in the
  parameters' dtype;
* ``scan`` and ``unroll``: each microbatch's gradient, scaled as
  ``(g.float() / n).to(grad_accum_dtype)``, is added to a buffer in
  ``grad_accum_dtype``, and the optimizer receives that dtype;
* ``fused``: ``(l_i / n).backward()`` per microbatch accumulates in
  ``.grad``, in the parameters' dtype.  The microbatches run last to
  first, the order in which JAX's backward scan adds them, so a
  bfloat16 sum rounds as the reference's does.  Each microbatch's
  backward runs right after its forward, so one microbatch's
  activations are live at a time, which is what the reference's
  checkpoint of the scan body buys it.

The reported loss includes the aux losses; ``grad_norm`` is taken after
the error feedback, in float32.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, loss_fn
from repro_torch.train import compression as comp
from repro_torch.train.optimizer import Optimizer, get_optimizer


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, *,
                     device="cuda",
                     generator: Optional[torch.Generator] = None) -> dict:
    """A fresh train state: the model (seeded weights on ``device``, the
    plain attention), its optimizer state and step 0."""
    model = Transformer(cfg.replace(attn_impl="dense"), device=device,
                        generator=generator)
    return {"model": model, "opt": optimizer.init(model), "step": 0}


def _split_microbatches(batch: dict, n: int) -> list:
    """[B, ...] -> n dicts of [B//n, ...] (views)."""
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    b = B // n
    return [{k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg: ModelConfig, optimizer: Optional[Optimizer] = None,
                    grad_compression: Optional[str] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    grad_compression: None | "int8_pod" — int8 error-feedback
    compression of the gradients (``repro_torch.train.compression``).
    """
    if optimizer is None:
        optimizer = get_optimizer(cfg.optimizer)
    if grad_compression not in (None, "int8_pod"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    nmb = cfg.microbatch
    accum_dt = getattr(torch, cfg.grad_accum_dtype)

    def grads_of(model: Transformer, batch: dict):
        names, params = zip(*model.named_parameters())

        def grad(loss):
            return torch.autograd.grad(loss, params, allow_unused=True,
                                       materialize_grads=True)

        if nmb == 1:
            l, _ = loss_fn(model, batch)
            return dict(zip(names, grad(l))), l.detach()
        mbs = _split_microbatches(batch, nmb)
        losses = [None] * nmb
        if cfg.grad_accum == "fused":
            for p in params:
                p.grad = None
            for i in reversed(range(nmb)):
                l, _ = loss_fn(model, mbs[i])
                (l / nmb).backward()
                losses[i] = l.detach()
            grads = {}
            for n, p in zip(names, params):
                grads[n] = (p.grad if p.grad is not None
                            else torch.zeros_like(p))
                p.grad = None
        else:
            grads = {n: torch.zeros(p.shape, dtype=accum_dt,
                                    device=p.device)
                     for n, p in zip(names, params)}
            for i, mb in enumerate(mbs):
                l, _ = loss_fn(model, mb)
                for n, g in zip(names, grad(l)):
                    grads[n].add_((g.float() / nmb).to(accum_dt))
                losses[i] = l.detach()
        total = losses[0]
        for l in losses[1:]:
            total = total + l
        return grads, total / nmb

    def train_step(state: dict, batch: dict):
        model = state["model"]
        if model.cfg.attn_impl != "dense":
            raise ValueError("training runs the plain attention: build the "
                             "model with attn_impl='dense' "
                             "(init_train_state does)")
        dev = model.device
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        grads, loss = grads_of(model, batch)
        if grad_compression == "int8_pod":
            grads, state = comp.apply_error_feedback(grads, state)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads.values()))
        optimizer.update(grads, state["opt"], model)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step
