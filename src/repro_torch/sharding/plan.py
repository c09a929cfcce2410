"""Logical-axis sharding plan over the mesh ("pod", "data", "model"),
on ``DeviceMesh`` and ``DTensor``.

The port of ``repro.sharding.plan``.  Models name the axes of an
activation with *logical* names through ``shard(x, ...)``; parameters
get their specs from path rules in ``param_specs``.  The plan maps
logical names to the mesh axes that exist, so the same model code runs
unsharded (no plan), on a one-rank mesh, on the single-pod ``(data,
model)`` mesh and on the multi-pod ``(pod, data, model)`` mesh.

Rules (defaults; per-arch overrides through ``Plan(rules={...})``):

  batch   -> ("pod", "data")      activations' batch dim
  heads   -> "model"              attention heads / q features
  kv_seq  -> "model"              decode-time KV-cache sequence dim
  ff      -> "model"              MLP hidden
  experts -> "model"              MoE expert dim
  vocab   -> "model"              embedding/logits vocab dim
  fsdp    -> "data"               ZeRO-3 weight sharding (if cfg.fsdp)

A spec is a tuple with one entry per tensor dim: ``None``, a mesh axis
name, or a tuple of names (the dim split over several mesh axes, major
first), the form of the reference's ``PartitionSpec``.  ``placements``
turns it into DTensor placements, one per mesh dim.  Where the
reference lets GSPMD pad an uneven dim, DTensor gives the last ranks
smaller (or empty) shards; the first rank's shard has GSPMD's padded
size.

Without a plan, ``shard(x, ...)`` returns ``x`` itself after one
context-variable read, so the serving path pays nothing.  With one, it
redistributes a DTensor to the plan's placements (a plain tensor is
taken as replicated).  Model code under a plan runs inside
``plan_scope()``, which turns on DTensor's implicit replication: the
plain tensors the forward makes (positions, masks, ``arange`` indices,
the aux-loss zero) count as replicated on every rank.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import re
from typing import Optional, Union

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

Axes = Union[None, str, tuple]

DEFAULT_RULES: dict[str, Axes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "kv_seq": "model",
    "head_dim": None,
    "ff": "model",
    "experts": "model",
    "capacity": None,
    "vocab": "model",
    "layers": None,
    "state": None,
    "fsdp": "data",
}


def mesh_axis_names(mesh) -> tuple:
    """The mesh's axis names (``DeviceMesh.mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("the plan's mesh needs named dims "
                         "(init_device_mesh(..., mesh_dim_names=...))")
    return tuple(names)


@dataclasses.dataclass
class Plan:
    mesh: object                 # a DeviceMesh (or anything with names)
    fsdp: bool = False
    rules: dict = dataclasses.field(default_factory=dict)

    def _resolve(self, logical: str) -> Axes:
        rules = {**DEFAULT_RULES, **self.rules}
        ax = rules.get(logical, None)
        if ax is None:
            return None
        if isinstance(ax, str):
            ax = (ax,)
        names = mesh_axis_names(self.mesh)
        present = tuple(a for a in ax if a in names)
        if not present:
            return None
        return present if len(present) > 1 else present[0]

    def spec(self, *logical: Optional[str]) -> tuple:
        """Resolve logical axes; a mesh axis may appear only once per
        spec: the *last* dims (features, vocab, heads) win, and earlier
        dims that want a used axis replicate (the reference's rule)."""
        used: set = set()
        out = []
        resolved = [self._resolve(l) if l else None for l in logical]
        for ax in reversed(resolved):
            axes = (ax,) if isinstance(ax, str) else (ax or ())
            if any(a in used for a in axes):
                out.append(None)
            else:
                used.update(axes)
                out.append(ax)
        return tuple(reversed(out))

    def placements(self, spec: tuple) -> tuple:
        """DTensor placements of ``spec``, one per mesh dim: ``Shard(i)``
        on each mesh axis that tensor dim ``i`` is split over,
        ``Replicate()`` elsewhere."""
        names = mesh_axis_names(self.mesh)
        out: list[Placement] = [Replicate()] * len(names)
        for dim, ax in enumerate(spec):
            axes = (ax,) if isinstance(ax, str) else (ax or ())
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec {spec}: dim {dim} splits over "
                                 f"{axes} against the mesh's order {names}")
            for i in idx:
                out[i] = Shard(dim)
        return tuple(out)

    def placements_of(self, *logical: Optional[str]) -> tuple:
        return self.placements(self.spec(*logical))

    def constrain(self, x: torch.Tensor, logical: tuple,
                  grad_placed: bool = True) -> torch.Tensor:
        """``x`` placed by ``logical``; its gradient takes the same
        placements on the way back (XLA's transpose of a sharding
        constraint constrains the cotangent alike) unless not
        ``grad_placed``."""
        if len(logical) != x.dim():
            raise ValueError(f"{logical} rank != tensor rank "
                             f"{tuple(x.shape)}")
        y = to_placements(x, self.mesh, self.placements_of(*logical))
        if grad_placed and y.requires_grad:
            return _GradPlaced.apply(y)
        return y


class _GradPlaced(torch.autograd.Function):
    """The identity on a DTensor, whose gradient is redistributed to the
    DTensor's own placements (else DTensor's backward rules pick their
    own, on a 3-D mesh sometimes strided ones that cost minutes of
    sharding propagation)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def to_placements(x: torch.Tensor, mesh, placements: tuple) -> DTensor:
    """``x`` as a DTensor on ``mesh`` with ``placements``: a DTensor is
    redistributed (differentiably); a plain tensor is taken as the same
    full value on every rank, and each rank keeps its chunk (no
    communication)."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == tuple(placements):
        return x
    y = x.redistribute(mesh, placements)
    if not y.to_local().is_contiguous():
        # a shard off a leading dim is a strided view of its whole; DTensor
        # runs later views (F.linear's flatten) on the local tensor as is
        y = y.clone(memory_format=torch.contiguous_format)
    return y


_ACTIVE: contextvars.ContextVar[Optional[Plan]] = contextvars.ContextVar(
    "repro_torch_sharding_plan", default=None)


@contextlib.contextmanager
def use_plan(plan: Optional[Plan]):
    tok = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(tok)


def current_plan() -> Optional[Plan]:
    return _ACTIVE.get()


def shard(x: torch.Tensor, *logical: Optional[str],
          grad_placed: bool = True) -> torch.Tensor:
    """Place activation ``x`` by logical axes; ``x`` itself without a
    plan.  ``grad_placed=False`` leaves the gradient where DTensor's
    backward puts it (a gather's gradient then arrives as a partial sum
    and is reduce-scattered in one step, not all-reduced first)."""
    plan = _ACTIVE.get()
    if plan is None:
        return x
    return plan.constrain(x, logical, grad_placed)


def _implicit_on() -> bool:
    return getattr(DTensor._op_dispatcher, "_allow_implicit_replication",
                   False)


def splits_evenly(n: int, logical: str) -> bool:
    """Whether ``n`` divides the ranks a logical axis is split over
    (True without a plan)."""
    plan = _ACTIVE.get()
    if plan is None:
        return True
    ax = plan._resolve(logical)
    k = 1
    for a in ((ax,) if isinstance(ax, str) else (ax or ())):
        k *= plan.mesh.size(mesh_axis_names(plan.mesh).index(a))
    return n % k == 0


def plan_scope():
    """The context model code runs in: DTensor's implicit replication
    under a plan (plain tensors mixed with DTensors count as
    replicated), nothing without one.  A sharded backward runs in it
    too (its saved masks and indices are plain tensors).  DTensor's flag
    is global and its context manager clears it on exit, so only the
    outermost scope enters it (the autograd engine's device threads see
    the flag the caller set)."""
    if _ACTIVE.get() is None or _implicit_on():
        return contextlib.nullcontext()
    return implicit_replication()


def with_plan(plan: Optional[Plan], fn):
    """``fn`` run under ``plan`` wherever it is called: the recompute of
    a checkpointed layer runs on the autograd engine's thread (a CUDA
    device thread), where the caller's context variables are unset."""
    if plan is None:
        return fn

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with use_plan(plan):
            return fn(*args, **kwargs)
    return wrapper


def scoped(fn):
    """Decorate model code: ``fn`` runs inside ``plan_scope()``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _ACTIVE.get() is None:
            return fn(*args, **kwargs)
        with plan_scope():
            return fn(*args, **kwargs)
    return wrapper


def zeros(shape, *logical: Optional[str], dtype, device) -> torch.Tensor:
    """``torch.zeros(shape)``; under a plan a DTensor placed by
    ``logical``, each rank allocating only its own shard."""
    plan = _ACTIVE.get()
    if plan is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    import torch.distributed.tensor as dtensor
    return dtensor.zeros(shape, dtype=dtype, device_mesh=plan.mesh,
                         placements=plan.placements_of(*logical))


# ---------------------------------------------------------------------------
# Parameter specs: path-based rules
# ---------------------------------------------------------------------------

# (path regex, logical axes per dim -- innermost dims; leading stacked-layer
#  dims are padded with None automatically)
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("vocab", "embed")),
    (r"lm_head$", ("embed", "vocab")),
    (r"(wq|wk|wv)$", ("fsdp", "heads")),
    (r"wo$", ("heads", "fsdp")),
    (r"(w_gate|w_up)$", ("fsdp", "ff")),
    (r"w_down$", ("ff", "fsdp")),
    (r"w_router$", ("fsdp", None)),
    (r"(bq|bk|bv)$", ("heads",)),
    # mamba in_proj output mixes z/x/B/C/dt at unaligned offsets -- keep the
    # fused dim replicated; head sharding is applied post-split (see models).
    (r"in_proj$", ("fsdp", None)),
    (r"out_proj$", ("heads", "fsdp")),
    (r"conv_w$", (None, None)),             # fused x/B/C channel dim
    (r"conv_b$", (None,)),
    (r"(A_log|dt_bias|D)$", (None,)),
    (r"gate_norm/scale$", ("heads",)),
    (r"scale$", (None,)),                   # norms
    (r"frontend_proj$", ("fsdp", None)),
]

# MoE expert-stacked weights carry a leading expert dim.
_MOE_RULES: list[tuple[str, tuple]] = [
    (r"moe/(w_gate|w_up)$", ("experts", "fsdp", None)),
    (r"moe/w_down$", ("experts", None, "fsdp")),
    (r"moe/w_router$", ("fsdp", None)),
]


def leaf_spec(plan: Plan, path: str, ndim: int) -> tuple:
    """The spec of the reference's leaf at ``path`` ("layers/attn/wq")
    with ``ndim`` dims; ``()`` (replicated) for a leaf no rule names."""
    for pat, axes in _MOE_RULES + _PARAM_RULES:
        if re.search(pat, path):
            if not plan.fsdp:
                axes = tuple(None if a == "fsdp" else a for a in axes)
            pad = (None,) * (ndim - len(axes))
            return plan.spec(*(pad + tuple(axes)))
    return ()


def _full(spec: tuple, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def port_spec(leaf, ref_spec: tuple) -> tuple:
    """A reference leaf's spec as the spec of each of its port
    parameters: the stacked layer dim dropped, the dims reversed where
    the port holds the transpose."""
    s = ref_spec[1:] if leaf.stacked else ref_spec
    return tuple(reversed(s)) if leaf.transposed else tuple(s)


def param_specs(plan: Plan, model) -> dict:
    """The spec of every parameter of ``model`` (a ``Transformer``), by
    name: the reference's rule for the leaf the parameter belongs to
    (``repro_torch.train.leaves``), in the port's layout."""
    from repro_torch.train import leaves as LV
    params = dict(model.named_parameters())
    out = {}
    for leaf in LV.param_leaves(model.cfg):
        shape = LV.ref_shape(leaf, params[leaf.names[0]].shape)
        spec = port_spec(leaf, _full(leaf_spec(plan, "/".join(leaf.path),
                                               len(shape)), len(shape)))
        out.update((n, spec) for n in leaf.names)
    return out


@torch.no_grad()
def shard_model(model, plan: Plan):
    """Place ``model``'s parameters by ``param_specs`` on ``plan``'s
    mesh, in place: each is taken whole (gathered, if it is already a
    DTensor on another mesh) and each rank keeps its chunk (a plain
    tensor must hold the same value on every rank).  Returns the
    model."""
    specs = param_specs(plan, model)
    for name, p in list(model.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        placed = to_placements(full_value(p.detach()), plan.mesh,
                               plan.placements(specs[name]))
        setattr(model.get_submodule(mod_name), attr,
                torch.nn.Parameter(placed, requires_grad=p.requires_grad))
    return model


def full_value(t: torch.Tensor) -> torch.Tensor:
    """The whole value of ``t``: a DTensor gathered on every rank (a
    collective over its mesh), a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def zeros_like_placed(shape, like: torch.Tensor, placements=None,
                      dtype=torch.float32) -> torch.Tensor:
    """Zeros of ``shape``: a DTensor on ``like``'s mesh (with
    ``placements``, replicated if None) when ``like`` is a DTensor, a
    plain tensor on ``like``'s device otherwise."""
    if not isinstance(like, DTensor):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    import torch.distributed.tensor as dtensor
    mesh = like.device_mesh
    return dtensor.zeros(shape, dtype=dtype, device_mesh=mesh,
                         placements=placements or [Replicate()] * mesh.ndim)


@torch.no_grad()
def copy_full_(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write the whole value ``src`` (a plain tensor, the same on every
    rank) into ``dst``; a DTensor ``dst`` takes its own chunk."""
    if isinstance(dst, DTensor):
        src = to_placements(src.to(dst.device), dst.device_mesh,
                            dst.placements)
    dst.copy_(src)


def local_offset(x: DTensor, dim: int) -> int:
    """Where this rank's shard of ``x`` starts along ``dim``: DTensor's
    even chunks (``ceil(n / k)``; the last ones shorter or empty), mesh
    dim by mesh dim.  Plain integers from the mesh coordinate, so that
    it runs under ``FakeTensorMode`` (DTensor's own helper computes on
    the mesh tensor)."""
    mesh, dim = x.device_mesh, dim % x.dim()
    coord = mesh.get_coordinate()
    size, off = x.shape[dim], 0
    for i, p in enumerate(x.placements):
        if p.is_shard() and p.dim % x.dim() == dim:
            cs = -(-size // mesh.size(i))
            start = min(coord[i] * cs, size)
            size, off = max(0, min(size - start, cs)), off + start
    return off


def local_slices(x: DTensor) -> tuple:
    """This rank's shard of ``x`` as one slice of each dim of the whole
    tensor (``local_offset`` and the local length; an empty uneven shard
    gives an empty slice).  A partial sum has no shard: reduce it
    first."""
    if any(p.is_partial() for p in x.placements):
        raise ValueError(f"{x.placements}: a partial sum has no shard to "
                         "slice; reduce it first")
    n = x.to_local().shape
    return tuple(slice(o, o + n[d]) for d, o in
                 enumerate(local_offset(x, d) for d in range(x.dim())))


def global_mean(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """``x.mean(dim)`` (every dim if None).  For a DTensor, replicated on
    its mesh: each rank sums its own shard, the partial sums are
    all-reduced and divided by the whole count (DTensor's ``mean`` over
    an unevenly split dim gathers the whole input on every rank first)."""
    if not isinstance(x, DTensor):
        return x.mean() if dim is None else x.mean(dim=dim)
    s = x.sum() if dim is None else x.sum(dim=dim)
    s = s.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    return s / (x.numel() if dim is None else x.shape[dim])


def local_index(idx: torch.Tensor, n: int, offset: int) -> tuple:
    """Global indices ``idx`` into a dim of which this rank holds ``n``
    entries from ``offset``: (local indices clamped into range, whether
    each falls inside).  ``n`` may be 0 (an empty uneven shard): the
    clamped index is then 0 and the caller must not read with it."""
    loc = idx.long() - offset
    inside = (loc >= 0) & (loc < n)
    return loc.clamp(0, max(n - 1, 0)), inside


def contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))
