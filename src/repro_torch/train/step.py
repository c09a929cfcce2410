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

A sharded state (``init_train_state(..., plan=)`` or ``place_state``)
holds DTensors; ``train_step`` then runs under that plan
(``use_plan``): each batch tensor is placed by ``batch_placements``,
each gradient reduced onto its parameter's placements, and the
returned ``loss`` and ``grad_norm`` are whole values.

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

import dataclasses
import math
from typing import Callable, Optional

import torch

from torch.distributed.tensor import DTensor

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, loss_fn
from repro_torch.sharding.plan import (Plan, current_plan, full_value,
                                       plan_scope, shard_model, to_placements,
                                       use_plan)
from repro_torch.train import compression as comp
from repro_torch.train import leaves as LV
from repro_torch.train.optimizer import Optimizer, get_optimizer


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, *,
                     device="cuda",
                     generator: Optional[torch.Generator] = None,
                     plan: Optional[Plan] = None) -> dict:
    """A fresh train state: the model (seeded weights on ``device``, the
    plain attention), its optimizer state and step 0; with ``plan``,
    sharded by it (``place_state``; every rank draws the same weights
    and keeps its chunk)."""
    model = Transformer(cfg.replace(attn_impl="dense"), device=device,
                        generator=generator)
    if plan is not None:
        shard_model(model, plan)
    return {"model": model, "opt": optimizer.init(model), "step": 0}


@torch.no_grad()
def place_state(state: dict, plan: Plan) -> dict:
    """Move a train state (plain, or sharded on any mesh) onto ``plan``,
    in place: each parameter by ``param_specs``, AdamW's moments with
    their parameter, Adafactor's statistics replicated, the error
    feedback by its leaf's parameters.  Each leaf is gathered whole on
    the mesh it lies on (a collective there) and each rank of the new
    mesh keeps its chunk.  Returns the state."""
    model = shard_model(state["model"], plan)
    params = dict(model.named_parameters())
    replicated = plan.placements(())
    opt = state["opt"]
    for key in ("m", "v"):
        for name, t in opt.get(key, {}).items():
            opt[key][name] = to_placements(full_value(t), plan.mesh,
                                           params[name].placements)
    for stats in opt.get("f", {}).values():
        for k, t in stats.items():
            stats[k] = to_placements(full_value(t), plan.mesh, replicated)
    if "ef" in state:
        for leaf in LV.param_leaves(model.cfg):
            p = params[leaf.names[0]]
            state["ef"][leaf.key] = to_placements(
                full_value(state["ef"][leaf.key]), plan.mesh,
                LV.ref_placements(leaf, p.placements, p.dim()))
    return state


def batch_placements(plan: Plan, x: torch.Tensor) -> tuple:
    """Where a batch tensor lies under ``plan`` (the reference's
    ``_batch_shardings``): batch, then sequence, then whole.  Raises
    where the rows do not split evenly over the batch's mesh axes
    (``rows_plan`` makes a plan under which they do)."""
    logical = ("batch", "seq", None)[:x.dim()]
    pl = plan.placements_of(*logical, *(None,) * (x.dim() - 3))
    n = math.prod(size for size, p in zip(plan.mesh.shape, pl)
                  if p.is_shard(0))
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over the {n} "
                         "ranks of the batch axes")
    return pl


def rows_plan(plan: Plan, rows: int) -> Plan:
    """``plan``, or where ``rows`` do not split evenly over the batch's
    mesh axes, a copy whose batch rule drops its leading axes until they
    do: the rows are then replicated over those axes, the per-device
    work GSPMD's padding gives the reference (DTensor's linear layers
    fail on an uneven batch).  llama3-405b's ``train_4k`` microbatches
    (16 rows) on 2x16x16 take ``data`` alone."""
    ax = plan.spec("batch")[0]
    axes = [ax] if isinstance(ax, str) else list(ax or ())
    names = list(plan.mesh.mesh_dim_names)
    kept = list(axes)
    while kept and rows % math.prod(plan.mesh.size(names.index(a))
                                    for a in kept):
        kept.pop(0)
    if kept == axes:
        return plan
    return dataclasses.replace(plan, rules={**plan.rules,
                                            "batch": tuple(kept) or None})


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

    def grads_of(model: Transformer, batch: dict, place):
        names, params = zip(*model.named_parameters())

        def grad(loss):
            gs = torch.autograd.grad(loss, params, allow_unused=True,
                                     materialize_grads=True)
            # a sharded parameter's gradient, reduced over the ranks that
            # hold its replicas (data parallelism) onto its placements
            return [g.redistribute(p.device_mesh, p.placements)
                    if isinstance(g, DTensor) else g
                    for g, p in zip(gs, params)]

        if nmb == 1:
            l, _ = loss_fn(model, place(batch))
            return dict(zip(names, grad(l))), l.detach()
        mbs = [place(mb) for mb in _split_microbatches(batch, nmb)]
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
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if isinstance(g, DTensor):
                    g = g.redistribute(p.device_mesh, p.placements)
                grads[n] = g
                p.grad = None
        else:
            grads = {n: torch.zeros_like(
                         p, dtype=accum_dt,
                         memory_format=torch.contiguous_format)
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
        plan = current_plan()
        sharded = isinstance(model.final_norm.scale, DTensor)
        if sharded != (plan is not None):
            raise ValueError("a sharded train state steps under its plan "
                             "(use_plan), an unsharded one under none")
        if plan is not None:
            rows = next(iter(batch.values())).shape[0] // nmb
            plan = rows_plan(plan, rows)

        def place(b: dict) -> dict:
            if plan is None:
                return b
            return {k: to_placements(v, plan.mesh, batch_placements(plan, v))
                    for k, v in b.items()}

        with use_plan(plan), plan_scope():
            grads, loss = grads_of(model, batch, place)
            if grad_compression == "int8_pod":
                grads, state = comp.apply_error_feedback(grads, state)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads.values()))
            optimizer.update(grads, state["opt"], model)
        state["step"] += 1
        return state, {"loss": full_value(loss),
                       "grad_norm": full_value(gnorm)}

    return train_step
