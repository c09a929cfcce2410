"""Elastic scaling and fault tolerance for the training loop.

The port of ``repro.train.elastic`` on ``DeviceMesh``:

* ``survivors_mesh``  -- the largest mesh of surviving ranks after a
                         failure: every ``data`` row that holds a failed
                         rank is dropped, the model axis stays whole (the
                         batch shrinks);
* ``remesh_state``    -- move a train state onto a new plan (each leaf
                         gathered on the old mesh, each rank of the new
                         one keeping its chunk); with
                         ``checkpoint.restore(..., placements=)`` this is
                         the node-failure recovery path;
* ``StepWatchdog``    -- straggler detection: alarm when a step exceeds
                         ``timeout_s`` (the action, re-dispatching the
                         step, is the caller's callback).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.sharding.plan import Plan
from repro_torch.train.step import place_state


def survivors_mesh(mesh: DeviceMesh, failed_ranks: Sequence[int],
                   data_axis: str = "data") -> DeviceMesh:
    """Largest mesh of surviving ranks with the model axis intact.

    Failure granularity is a full ``data`` row: any row holding a failed
    rank is dropped.  Every rank of the world calls this (building a
    ``DeviceMesh`` creates its process groups collectively); on a rank
    outside the new mesh, DTensor operations on it do nothing."""
    ranks = mesh.mesh
    axis = mesh.mesh_dim_names.index(data_axis)
    failed = set(int(r) for r in failed_ranks)
    keep = [i for i in range(ranks.shape[axis])
            if not set(ranks.select(axis, i).flatten().tolist()) & failed]
    if not keep:
        raise RuntimeError("no surviving data rows")
    new = ranks.index_select(axis, torch.tensor(keep))
    return DeviceMesh(mesh.device_type, new,
                      mesh_dim_names=mesh.mesh_dim_names)


def remesh_state(state: dict, old_plan: Plan, new_plan: Plan) -> dict:
    """Move a train state's params and optimizer state from
    ``old_plan``'s mesh onto ``new_plan``'s, in place (every rank of the
    old mesh takes part in the gathers).  Returns the state."""
    del old_plan          # the leaves carry their own mesh and placements
    return place_state(state, new_plan)


class StepWatchdog:
    """Detect straggling steps: fire ``on_timeout`` if a step takes too long.

    Usage::

        wd = StepWatchdog(timeout_s=300, on_timeout=redispatch)
        with wd.step(i):
            state, metrics = train_step(state, batch)
    """

    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable[[int, float], None]] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout or (lambda step, dt: None)
        self.timeouts: list[int] = []

    class _Ctx:
        def __init__(self, wd: "StepWatchdog", step: int):
            self.wd, self.step_idx = wd, step
            self._done = threading.Event()

        def __enter__(self):
            self.t0 = time.monotonic()

            def watch():
                if not self._done.wait(self.wd.timeout_s):
                    dt = time.monotonic() - self.t0
                    self.wd.timeouts.append(self.step_idx)
                    self.wd.on_timeout(self.step_idx, dt)

            self._thread = threading.Thread(target=watch, daemon=True)
            self._thread.start()
            return self

        def __exit__(self, *exc):
            self._done.set()
            return False

    def step(self, i: int) -> "StepWatchdog._Ctx":
        return self._Ctx(self, i)
