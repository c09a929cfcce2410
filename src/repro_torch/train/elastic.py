"""Straggler detection for the training loop.

The port of ``repro.train.elastic``'s ``StepWatchdog``, which is host
threading.  ``survivors_mesh`` and ``remesh_state`` move a state between
device meshes and wait for the sharded port.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


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
