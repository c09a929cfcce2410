"""Carry the JAX package's parameters and train state into the port, and
back.

``params_from_jax(cfg, np_params)`` takes the reference's parameter tree
already turned into numpy (``jax.tree.map(np.asarray, params)``), so the
port never imports JAX.  The reference stacks layer params on a leading
``L`` axis and keeps weights as ``[in, out]``; ``nn.Linear`` keeps
``[out, in]``.  ``repro_torch.train.leaves`` lists, for each reference
leaf, the port's parameters and whether they are transposed; everything
else carries over as it is: the padded vocabulary, the separate
``lm_head``, the fp32 norm scales, the Mamba mixers' ``conv_w [W, ch]``,
``A_log``, ``dt_bias`` and ``D``, and a MoE block's router ``w_router
[d, E]`` (float32) and stacked experts ``w_gate``/``w_up [E, d, F]`` and
``w_down [E, F, d]``, which keep the reference's ``[E, in, out]``
layout.  The hybrid's shared block keeps the dense block's names under
``shared.``; the audio family has no ``embed``.

The train state goes the same way: ``flat_train_state(state)`` lists a
port train state (``repro_torch.train.step``) as the reference's
flattened train state, one ``(name, tensor)`` per leaf in the
reference's layout and under its checkpoint names (``params.<leaf>``,
``opt.m.<leaf>``, ``opt.v.<leaf>`` or ``opt.f.<leaf>.vr|vc|v``,
``opt.count``, ``ef.<leaf>``, ``step``); ``load_flat_train_state`` is
its inverse.  ``train_state_to_jax`` and ``train_state_from_jax`` build
on them for nested numpy trees.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.sharding.plan import Plan, copy_full_, full_value
from repro_torch.train import leaves as LV
from repro_torch.train.compression import init_error_feedback


def _tensor(a) -> torch.Tensor:
    a = np.array(a, order="C")           # a writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16, from JAX
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def state_dict_from_jax(cfg: ModelConfig, np_params: dict) -> dict:
    """The ``Transformer.state_dict()`` equivalent of a reference tree
    (of parameters, or of anything shaped like them: gradients, AdamW's
    moments)."""
    sd = {}
    for leaf in LV.param_leaves(cfg):
        pieces = LV.from_ref(leaf, np.asarray(LV.get_path(np_params,
                                                         leaf.path)))
        sd.update((n, _tensor(a)) for n, a in zip(leaf.names, pieces))
    return sd


def params_from_jax(cfg: ModelConfig, np_params: dict, *,
                    device="cuda") -> Transformer:
    """A ``Transformer`` on ``device`` holding the reference's weights."""
    model = Transformer(cfg, device=device)
    model.load_state_dict(state_dict_from_jax(cfg, np_params), strict=True)
    return model


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------


def _state_entries(state: dict) -> list:
    """(reference path, shape, get, put) for every leaf of a port train
    state: ``shape`` is the leaf's shape in the reference's layout,
    ``get()`` gives the leaf in that layout, ``put(arr)`` writes an array
    in that layout into the state."""
    model = state["model"]
    params = dict(model.named_parameters())
    leaves = LV.param_leaves(model.cfg)
    opt = state["opt"]
    out = []

    def stacked(leaf, src: dict):
        shape = LV.ref_shape(leaf, src[leaf.names[0]].shape)

        def get():
            return LV.to_ref(leaf, [src[n] for n in leaf.names])

        @torch.no_grad()
        def put(arr):
            # one contiguous copy to the state's device, then the split
            # and the transposes there (a sharded tensor keeps its chunk)
            arr = torch.as_tensor(arr).to(src[leaf.names[0]].device)
            for n, piece in zip(leaf.names, LV.from_ref(leaf, arr)):
                copy_full_(src[n], piece)
        return shape, get, put

    def whole(src: dict, key):
        def put(arr):
            copy_full_(src[key], torch.as_tensor(arr))
        return tuple(src[key].shape), (lambda: src[key]), put

    def scalar(src: dict, key):
        def put(arr):
            src[key] = int(np.asarray(arr))
        return (), (lambda: torch.tensor(src[key], dtype=torch.int32)), put

    for leaf in leaves:
        out.append((("params",) + leaf.path, *stacked(leaf, params)))
        if "m" in opt:
            for k in ("m", "v"):
                out.append((("opt", k) + leaf.path,
                            *stacked(leaf, opt[k])))
        else:
            for k in sorted(opt["f"][leaf.key]):
                out.append((("opt", "f") + leaf.path + (k,),
                            *whole(opt["f"][leaf.key], k)))
        if "ef" in state:
            out.append((("ef",) + leaf.path, *whole(state["ef"], leaf.key)))
    out.append((("opt", "count"), *scalar(opt, "count")))
    out.append((("step",), *scalar(state, "step")))
    return sorted(out, key=lambda e: e[0])


def flat_train_state(state: dict) -> Iterator[tuple]:
    """``(flat name, tensor)`` for every leaf of the reference's train
    state, in ``jax.tree.leaves`` order, each built when it is reached
    (one stacked leaf at a time on the model's device)."""
    for path, _, get, _ in _state_entries(state):
        yield ".".join(path), get()


def load_flat_train_state(state: dict, get: Callable) -> None:
    """Write every leaf into ``state`` in place; ``get(name)`` gives the
    leaf named as ``flat_train_state`` names it (a numpy array or a
    tensor in the reference's layout).  A state without ``ef`` takes
    none; one with ``ef`` needs it.  Raises on a leaf whose shape is not
    the state's."""
    for path, shape, _, put in _state_entries(state):
        name = ".".join(path)
        arr = get(name)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != the "
                             f"state's {shape}")
        put(arr)


def _np(t: torch.Tensor) -> np.ndarray:
    """A CPU numpy copy (of the whole value: a DTensor is gathered);
    bfloat16 comes as its raw ``uint16`` bits (numpy has no bfloat16:
    view them as ``ml_dtypes.bfloat16``)."""
    t = full_value(t.detach()).cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def train_state_to_jax(state: dict) -> dict:
    """The reference's train state as a nested dict of numpy arrays."""
    tree: dict = {}
    for name, t in flat_train_state(state):
        LV.set_path(tree, name.split("."), _np(t))
    return tree


def train_state_from_jax(state: dict, np_state: dict,
                         plan: Optional[Plan] = None) -> dict:
    """Load a reference train state (``jax.tree.map(np.asarray,
    state)``: params, the ``adamw`` or ``adafactor`` state, ``step`` and,
    where present, ``ef``) into a port train state of the same config
    and optimizer (``init_train_state``), in place; returns it.  With
    ``plan``, the state is first placed by it (``place_state``), so the
    reference's leaves land sharded, each rank keeping its chunk."""
    if "ef" in np_state and "ef" not in state:
        state["ef"] = init_error_feedback(state["model"])
    if plan is not None:
        from repro_torch.train.step import place_state
        place_state(state, plan)

    def get(name):
        a = np.asarray(LV.get_path(np_state, name.split(".")))
        return _tensor(a) if a.ndim else a
    load_flat_train_state(state, get)
    return state
