"""The reference's parameter leaves, in terms of the port's parameters.

The JAX package keeps its parameters as a tree whose layer leaves are
stacked on a leading ``L`` axis, with weights as ``[in, out]``; the port
keeps one module per layer, with ``nn.Linear`` weights as ``[out, in]``.
Training needs the reference's layout where a computation spans a whole
leaf: Adafactor's factored statistics and its two RMS terms, the int8
error feedback's 256-element blocks, and the checkpoint files.

``param_leaves(cfg)`` lists the reference's leaves in the order JAX
flattens them (sorted keys), each with the port's parameter names in
stack order and whether the port holds each slice transposed; it is the
inverse of ``repro_torch.models.convert.state_dict_from_jax``, which is
built on it.  ``to_ref`` stacks the port's tensors into a leaf and
``from_ref`` splits a leaf back.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch.distributed.tensor import Shard

# names of the dense block's weights: (reference key, port module)
_ATTN = (("wq", "wq"), ("wk", "wk"), ("wv", "wv"), ("wo", "wo"))
_BIAS = (("bq", "wq"), ("bk", "wk"), ("bv", "wv"))
_MAMBA_PLAIN = ("A_log", "D", "conv_b", "conv_w", "dt_bias")


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's parameter tree."""
    path: tuple            # keys under the parameter tree
    names: tuple           # the port's parameter names, in stack order
    stacked: bool          # the leaf has a leading layer axis
    transposed: bool       # the port holds each slice as its transpose

    @property
    def key(self) -> str:
        """The leaf's flat name, as the reference's checkpoint writes it
        under ``params.``."""
        return ".".join(self.path)


def _block(path: tuple, prefixes: Sequence[str], stacked: bool, cfg
           ) -> list[Leaf]:
    """The leaves of a dense block (attention + MLP or MoE)."""
    def leaf(sub, name, transposed):
        return Leaf(path + sub, tuple(p + name for p in prefixes), stacked,
                    transposed)
    out = [leaf(("ln1", "scale"), "ln1.scale", False),
           leaf(("ln2", "scale"), "ln2.scale", False)]
    out += [leaf(("attn", k), f"attn.{m}.weight", True) for k, m in _ATTN]
    if cfg.qkv_bias:
        out += [leaf(("attn", k), f"attn.{m}.bias", False) for k, m in _BIAS]
    if cfg.family == "moe":
        out += [leaf(("moe", k), f"moe.{k}", False)
                for k in ("w_router", "w_gate", "w_up", "w_down")]
    else:
        out += [leaf(("mlp", k), f"mlp.{k}.weight", True)
                for k in ("w_gate", "w_up", "w_down")]
    return out


def _mamba(prefixes: Sequence[str]) -> list[Leaf]:
    """The leaves of the stacked Mamba layers."""
    def leaf(sub, name, transposed):
        return Leaf(("layers",) + sub, tuple(p + name for p in prefixes),
                    True, transposed)
    out = [leaf(("ln", "scale"), "ln.scale", False),
           leaf(("mamba", "in_proj"), "mamba.in_proj.weight", True),
           leaf(("mamba", "out_proj"), "mamba.out_proj.weight", True),
           leaf(("mamba", "gate_norm", "scale"), "mamba.gate_norm.scale",
                False)]
    out += [leaf(("mamba", k), f"mamba.{k}", False) for k in _MAMBA_PLAIN]
    return out


def param_leaves(cfg) -> list[Leaf]:
    """Every leaf of the reference's parameters for ``cfg``, sorted by
    path (the order of ``jax.tree.leaves``)."""
    out = [Leaf(("final_norm", "scale"), ("final_norm.scale",), False,
                False)]
    if cfg.family != "audio":
        out.append(Leaf(("embed",), ("embed.weight",), False, False))
    if not cfg.tie_embeddings:
        out.append(Leaf(("lm_head",), ("lm_head.weight",), False, True))
    prefixes = [f"layers.{i}." for i in range(cfg.n_layers)]
    if cfg.family in ("ssm", "hybrid"):
        out += _mamba(prefixes)
    else:
        out += _block(("layers",), prefixes, True, cfg)
    if cfg.family == "hybrid":
        out += _block(("shared",), ["shared."], False, cfg)
    return sorted(out, key=lambda leaf: leaf.path)


def to_ref(leaf: Leaf, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The port's tensors of ``leaf`` (in ``leaf.names`` order) as the
    reference's leaf: transposed back where the port transposes, and
    stacked on a new first axis where the leaf is stacked."""
    parts = [t.t() if leaf.transposed else t for t in tensors]
    return torch.stack(parts) if leaf.stacked else parts[0].contiguous()


def from_ref(leaf: Leaf, arr) -> list:
    """A leaf in the reference's layout (a tensor or a numpy array) as
    the port's pieces, in ``leaf.names`` order (views where possible)."""
    parts = [arr[i] for i in range(arr.shape[0])] if leaf.stacked else [arr]
    return [p.T if leaf.transposed else p for p in parts]


def ref_shape(leaf: Leaf, shape: Sequence[int]) -> tuple:
    """The leaf's shape from the shape of one of its port tensors."""
    s = tuple(shape)
    if leaf.transposed:
        s = s[::-1]
    return ((len(leaf.names),) if leaf.stacked else ()) + s


def ref_placements(leaf: Leaf, placements: Sequence, port_ndim: int
                   ) -> tuple:
    """DTensor placements of a port parameter of ``leaf`` (``port_ndim``
    dims) as the placements of the reference's leaf: a sharded dim is
    mirrored where the port transposes, and moved past the stacked
    layer dim."""
    out = []
    for pl in placements:
        if pl.is_shard():
            d = pl.dim % port_ndim
            if leaf.transposed:
                d = port_ndim - 1 - d
            out.append(Shard(d + 1 if leaf.stacked else d))
        else:
            out.append(pl)
    return tuple(out)


def get_path(tree: dict, path: Sequence[str]):
    """``tree[path[0]][path[1]]...``."""
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree: dict, path: Sequence[str], value) -> None:
    """Set ``tree[path[0]]...[path[-1]] = value``, making dicts."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
