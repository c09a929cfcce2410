"""Load the JAX package's parameters into the port's modules.

``params_from_jax(cfg, np_params)`` takes the reference's parameter tree
already turned into numpy (``jax.tree.map(np.asarray, params)``), so the
port never imports JAX.  The reference stacks layer params on a leading
``L`` axis and keeps weights as ``[in, out]``; ``nn.Linear`` keeps
``[out, in]``.  The padded vocabulary, the separate ``lm_head`` and the
fp32 norm scales carry over as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer


def _tensor(a) -> torch.Tensor:
    a = np.array(a, order="C")           # a writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16, from JAX
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def state_dict_from_jax(cfg: ModelConfig, np_params: dict) -> dict:
    """The ``Transformer.state_dict()`` equivalent of a reference tree."""
    sd = {"embed.weight": np_params["embed"],
          "final_norm.scale": np_params["final_norm"]["scale"]}
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = np.asarray(np_params["lm_head"]).T
    layers = np_params["layers"]
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        sd[p + "ln1.scale"] = layers["ln1"]["scale"][i]
        sd[p + "ln2.scale"] = layers["ln2"]["scale"][i]
        attn = layers["attn"]
        for name in ("wq", "wk", "wv", "wo"):
            sd[p + f"attn.{name}.weight"] = attn[name][i].T
        if cfg.qkv_bias:
            for name in ("q", "k", "v"):
                sd[p + f"attn.w{name}.bias"] = attn["b" + name][i]
        for name in ("w_gate", "w_up", "w_down"):
            sd[p + f"mlp.{name}.weight"] = layers["mlp"][name][i].T
    return {k: _tensor(v) for k, v in sd.items()}


def params_from_jax(cfg: ModelConfig, np_params: dict, *,
                    device="cuda") -> Transformer:
    """A ``Transformer`` on ``device`` holding the reference's weights."""
    model = Transformer(cfg, device=device)
    model.load_state_dict(state_dict_from_jax(cfg, np_params), strict=True)
    return model
