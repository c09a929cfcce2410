"""Device meshes: the production meshes and a small one over what exists.

The port of ``repro.launch.mesh`` on ``torch.distributed``'s
``DeviceMesh``.  Functions, not module constants: importing this module
starts no process group.

* ``make_mesh(shape, axes, device_type=)``: ``init_device_mesh``.
* ``make_production_mesh(multi_pod=)``: ``(16, 16)`` ``("data",
  "model")`` or ``(2, 16, 16)`` ``("pod", "data", "model")``; it needs a
  world of 256 or 512 ranks, or a fake process group of that size (the
  dry run), and raises otherwise.
* ``make_host_mesh(data, model)``: shrinks to the world as the
  reference shrinks to ``jax.devices()``: one H100 gives a one-rank
  ``(1, 1)`` mesh.
* ``ensure_process_group(device_type)``: a one-rank group (NCCL on
  ``cuda``, gloo on ``cpu``) when none has been started; under
  ``torchrun`` (``WORLD_SIZE`` set) the group of the launched ranks.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_process_group(device_type: str = "cuda") -> None:
    """Start the default process group if none exists: the ranks of
    ``torchrun`` (its environment), else one rank on this host."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)


def make_mesh(shape, axes, *, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the world's
    first ranks (starting a one-rank group if there is none); every rank
    of the world calls it."""
    ensure_process_group(device_type)
    n = 1
    for s in shape:
        n *= s
    if n == dist.get_world_size():
        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(axes))
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"the {'x'.join(map(str, shape))} production "
                           f"mesh needs a world of {n} ranks (or a fake "
                           f"process group of that size), not {have}")
    return make_mesh(shape, axes, device_type=device_type)


def make_host_mesh(data: int = 2, model: int = 2, *,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small ``(data, model)`` mesh over the ranks that exist: where
    ``data * model`` exceeds the world, ``(1, min(model, world))``."""
    ensure_process_group(device_type)
    n = dist.get_world_size()
    if data * model > n:
        data, model = 1, min(model, n)
    return make_mesh((data, model), ("data", "model"),
                     device_type=device_type)
