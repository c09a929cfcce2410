"""Load the JAX package's parameters into the port's modules.

``params_from_jax(cfg, np_params)`` takes the reference's parameter tree
already turned into numpy (``jax.tree.map(np.asarray, params)``), so the
port never imports JAX.  The reference stacks layer params on a leading
``L`` axis and keeps weights as ``[in, out]``; ``nn.Linear`` keeps
``[out, in]``.  The padded vocabulary, the separate ``lm_head``, the
fp32 norm scales and the Mamba mixers' ``conv_w [W, ch]`` (the port's
``_causal_conv`` reads it as the reference does), ``A_log``, ``dt_bias``
and ``D`` carry over as they are.  So do a MoE block's weights: the
router ``w_router [d, E]`` (float32) and the stacked experts
``w_gate``/``w_up [E, d, F]`` and ``w_down [E, F, d]`` keep the
reference's ``[E, in, out]`` layout, with no transpose (the port's
``torch.bmm`` reads them so).  The hybrid's shared block keeps the
dense block's names under ``shared.``; the audio family has no
``embed``.
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


def _attn_block(sd: dict, prefix: str, p: dict, take, cfg: ModelConfig
                ) -> None:
    """One ``DecoderBlock``'s entries; ``take`` picks its slice of a
    stacked leaf."""
    sd[prefix + "ln1.scale"] = take(p["ln1"]["scale"])
    sd[prefix + "ln2.scale"] = take(p["ln2"]["scale"])
    attn = p["attn"]
    for name in ("wq", "wk", "wv", "wo"):
        sd[prefix + f"attn.{name}.weight"] = take(attn[name]).T
    if cfg.qkv_bias:
        for name in ("q", "k", "v"):
            sd[prefix + f"attn.w{name}.bias"] = take(attn["b" + name])
    if cfg.family == "moe":
        for name in ("w_router", "w_gate", "w_up", "w_down"):
            sd[prefix + f"moe.{name}"] = take(p["moe"][name])
        return
    for name in ("w_gate", "w_up", "w_down"):
        sd[prefix + f"mlp.{name}.weight"] = take(p["mlp"][name]).T


def _mamba_layer(sd: dict, prefix: str, p: dict, i: int) -> None:
    """One ``MambaLayer``'s entries from layer ``i`` of the stack."""
    m = p["mamba"]
    sd[prefix + "ln.scale"] = p["ln"]["scale"][i]
    sd[prefix + "mamba.in_proj.weight"] = m["in_proj"][i].T
    sd[prefix + "mamba.out_proj.weight"] = m["out_proj"][i].T
    for name in ("conv_w", "conv_b", "A_log", "dt_bias", "D"):
        sd[prefix + f"mamba.{name}"] = m[name][i]
    sd[prefix + "mamba.gate_norm.scale"] = m["gate_norm"]["scale"][i]


def state_dict_from_jax(cfg: ModelConfig, np_params: dict) -> dict:
    """The ``Transformer.state_dict()`` equivalent of a reference tree."""
    sd = {"final_norm.scale": np_params["final_norm"]["scale"]}
    if cfg.family != "audio":
        sd["embed.weight"] = np_params["embed"]
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = np.asarray(np_params["lm_head"]).T
    layers = np_params["layers"]
    for i in range(cfg.n_layers):
        if cfg.family in ("ssm", "hybrid"):
            _mamba_layer(sd, f"layers.{i}.", layers, i)
        else:
            _attn_block(sd, f"layers.{i}.", layers, lambda a: a[i], cfg)
    if cfg.family == "hybrid":
        _attn_block(sd, "shared.", np_params["shared"], lambda a: a, cfg)
    return {k: _tensor(v) for k, v in sd.items()}


def params_from_jax(cfg: ModelConfig, np_params: dict, *,
                    device="cuda") -> Transformer:
    """A ``Transformer`` on ``device`` holding the reference's weights."""
    model = Transformer(cfg, device=device)
    model.load_state_dict(state_dict_from_jax(cfg, np_params), strict=True)
    return model
