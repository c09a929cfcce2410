"""Lane schedulers for the serving engine — the paper's policies.

A copy of ``repro.serving.schedulers`` (the JAX package's module), rewired
onto this package's own ``core.spec`` and ``core.dispatch`` so that nothing
here imports the JAX package.

The hardware adaptation (DESIGN.md §2): a "CPU core" becomes a **lane** of
the continuously-batched decode step; "context switch" becomes a lane
reassignment (batch re-formation / cache-slot swap); the time slice is
measured in engine ticks (≙ decode tokens).  Policies:

  sfs  — the paper: FILTER lanes (run-to-completion up to an adaptive slice
         S = mean-IAT x lanes, recomputed every N arrivals), demotion to a
         fair-share (CFS-like) pool, transient-overload bypass (delay >=
         O x S), stall-aware parking (the I/O handling of §V-D).
  cfs  — fair share: every runnable request accrues vruntime; each tick the
         ``lanes`` smallest-vruntime requests run.
  fifo — non-preemptive: a lane keeps its request to completion.
  srtf — oracle: smallest remaining demand first (preemptive).

Every scheduler exposes: on_arrival / select / on_tick_end / on_stall /
on_wake.  ``select(t)`` returns the rids to run this tick (<= lanes).
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.dispatch import BoundedTimeline
from repro_torch.core.spec import (SCHEDULER_REGISTRY, TICK_SCHED_FIELDS,
                                  SchedulerSpec)
from repro_torch.serving.request import Request


def pick_active_batched(eng: np.ndarray, key: np.ndarray, rid: np.ndarray,
                        k: np.ndarray, n_engines: int):
    """Batched ``select`` over struct-of-arrays candidates — the array
    analogue of the sorted-order pick every preemptive scheduler here
    performs, across a whole engine group at once (vector backend,
    ``repro.serving.vector_cluster`` in the JAX package).

    ``eng``/``key``/``rid`` are parallel arrays over all runnable
    candidates of all engines in a group; ``k[g]`` is how many lanes
    engine ``g`` has to offer.  Returns ``(order, chosen)``: ``order``
    sorts candidates by ``(eng, key, rid)`` — exactly each engine's
    ``sorted(runnable, key=(key, rid))`` concatenated in engine order —
    and ``chosen`` marks, in that sorted frame, the first ``k[eng]``
    candidates of each engine.
    """
    order = np.lexsort((rid, key, eng))
    eng_s = eng[order]
    counts = np.bincount(eng_s, minlength=n_engines)
    starts = np.concatenate(([0], np.cumsum(counts[:-1])))
    rank = np.arange(eng_s.size) - starts[eng_s]
    return order, rank < k[eng_s]


class Scheduler:
    name = "base"

    def __init__(self, lanes: int):
        self.lanes = lanes
        self.reqs: dict[int, Request] = {}
        # opt-in lifecycle tracing (core/telemetry.py): None by default,
        # every emission site is guarded so the disabled path costs one
        # attribute read
        self.trace = None
        self.trace_idx = -1

    def bind_trace(self, trace, idx: int):
        """Attach a TraceRecorder; ``idx`` is this server's cluster
        index, stamped on every emitted event."""
        self.trace = trace
        self.trace_idx = idx

    def on_arrival(self, req: Request, t: int):
        raise NotImplementedError

    def select(self, t: int) -> list[int]:
        raise NotImplementedError

    def on_tick_end(self, rid: int, t: int, finished: bool):
        raise NotImplementedError

    def on_stall(self, rid: int, t: int):
        pass

    def on_wake(self, rid: int, t: int):
        pass

    def discard(self, rid: int):
        """Forget ``rid`` entirely — the chaos eviction seam (timeout /
        hedge relocation, core/chaos.py).  Must leave no phantom
        preempt behind on the next ``select``."""
        raise NotImplementedError

    # -- shared helpers ------------------------------------------------------
    def _charge(self, rid: int):
        self.reqs[rid].served_ticks += 1

    # -- dispatch-visible state (cluster layer, core.dispatch) ---------
    def queue_len(self) -> int:
        """Length of the scheduler's global FIFO queue (0 if none)."""
        return len(getattr(self, "queue", ()))

    def filter_free(self) -> int:
        """Lanes with no run-to-completion work bound to them — queued
        work counts as bound, or a burst routed within one tick would
        keep looking free."""
        return max(0, self.lanes - self.active_count() - self.queue_len())

    def active_count(self) -> int:
        """Requests that would occupy a lane this tick."""
        raise NotImplementedError

    def fair_load(self) -> int:
        """Size of the fair-share pool (demoted/long work)."""
        return 0


@SCHEDULER_REGISTRY.register("fifo")
class FIFOScheduler(Scheduler):
    name = "fifo"

    def __init__(self, lanes: int):
        super().__init__(lanes)
        self.queue: deque[int] = deque()
        self.running: list[int] = []

    def on_arrival(self, req: Request, t: int):
        self.reqs[req.rid] = req
        req.queue_enter = t
        self.queue.append(req.rid)

    def select(self, t: int) -> list[int]:
        while len(self.running) < self.lanes and self.queue:
            rid = self.queue.popleft()
            r = self.reqs[rid]
            r.queue_delay += t - r.queue_enter
            if r.first_start is None:
                r.first_start = t
            self.running.append(rid)
            if self.trace is not None:
                self.trace.emit(t, "admit", rid, self.trace_idx)
        return list(self.running)

    def on_tick_end(self, rid: int, t: int, finished: bool):
        self._charge(rid)
        if finished:
            self.running.remove(rid)

    def on_stall(self, rid: int, t: int):
        if rid in self.running:
            self.running.remove(rid)
            self.reqs[rid].n_ctx += 1
            if self.trace is not None:
                self.trace.emit(t, "preempt", rid, self.trace_idx)

    def on_wake(self, rid: int, t: int):
        self.reqs[rid].queue_enter = t
        self.queue.append(rid)

    def discard(self, rid: int):
        if rid in self.queue:
            self.queue.remove(rid)
        if rid in self.running:
            self.running.remove(rid)
        self.reqs.pop(rid, None)

    def active_count(self) -> int:
        return len(self.running)


@SCHEDULER_REGISTRY.register("cfs")
class CFSScheduler(Scheduler):
    """Fair share: run the ``lanes`` runnable requests with min vruntime."""
    name = "cfs"

    def __init__(self, lanes: int):
        super().__init__(lanes)
        self.runnable: set[int] = set()
        self.min_vruntime = 0.0
        self._last: list[int] = []

    def on_arrival(self, req: Request, t: int):
        self.reqs[req.rid] = req
        req.queue_enter = t
        req.vruntime = self.min_vruntime
        self.runnable.add(req.rid)

    def select(self, t: int) -> list[int]:
        order = sorted(self.runnable,
                       key=lambda rid: (self.reqs[rid].vruntime, rid))
        chosen = order[:self.lanes]
        for rid in chosen:
            r = self.reqs[rid]
            if r.first_start is None:
                r.first_start = t
                r.queue_delay += t - r.queue_enter
        # context switch accounting: a request that ran last tick but was
        # displaced this tick was preempted (lane re-formation)
        displaced = sorted(set(self._last) - set(chosen))
        for rid in displaced:
            if rid in self.runnable:
                self.reqs[rid].n_ctx += 1
                if self.trace is not None:
                    self.trace.emit(t, "preempt", rid, self.trace_idx)
        self._last = chosen
        return chosen

    def on_tick_end(self, rid: int, t: int, finished: bool):
        self._charge(rid)
        r = self.reqs[rid]
        r.vruntime += 1.0
        self.min_vruntime = max(self.min_vruntime,
                                min((self.reqs[x].vruntime
                                     for x in self.runnable), default=0.0))
        if finished:
            self.runnable.discard(rid)

    def on_stall(self, rid: int, t: int):
        self.runnable.discard(rid)
        self.reqs[rid].n_ctx += 1
        if self.trace is not None:
            self.trace.emit(t, "preempt", rid, self.trace_idx)

    def on_wake(self, rid: int, t: int):
        r = self.reqs[rid]
        r.vruntime = max(r.vruntime, self.min_vruntime)
        self.runnable.add(rid)

    def discard(self, rid: int):
        self.runnable.discard(rid)
        if rid in self._last:
            self._last = [x for x in self._last if x != rid]
        self.reqs.pop(rid, None)

    def active_count(self) -> int:
        return min(self.lanes, len(self.runnable))

    def fair_load(self) -> int:
        return len(self.runnable)

    # -- batched form (vector backend) ---------------------------------------
    # fair share picks the k smallest (vruntime, rid) per engine; over
    # arrays the key IS the vruntime column
    pick_active = staticmethod(pick_active_batched)


@SCHEDULER_REGISTRY.register("srtf")
class SRTFScheduler(Scheduler):
    """Offline oracle: preemptive shortest-remaining-demand-first."""
    name = "srtf"

    def __init__(self, lanes: int):
        super().__init__(lanes)
        self.runnable: set[int] = set()
        self._last: list[int] = []

    def on_arrival(self, req: Request, t: int):
        self.reqs[req.rid] = req
        req.queue_enter = t
        self.runnable.add(req.rid)

    def select(self, t: int) -> list[int]:
        order = sorted(self.runnable,
                       key=lambda rid: (self.reqs[rid].remaining(), rid))
        chosen = order[:self.lanes]
        for rid in chosen:
            r = self.reqs[rid]
            if r.first_start is None:
                r.first_start = t
                r.queue_delay += t - r.queue_enter
        for rid in sorted(set(self._last) - set(chosen)):
            if rid in self.runnable:
                self.reqs[rid].n_ctx += 1
                if self.trace is not None:
                    self.trace.emit(t, "preempt", rid, self.trace_idx)
        self._last = chosen
        return chosen

    def on_tick_end(self, rid: int, t: int, finished: bool):
        self._charge(rid)
        if finished:
            self.runnable.discard(rid)

    def on_stall(self, rid: int, t: int):
        self.runnable.discard(rid)
        self.reqs[rid].n_ctx += 1
        if self.trace is not None:
            self.trace.emit(t, "preempt", rid, self.trace_idx)

    def on_wake(self, rid: int, t: int):
        self.runnable.add(rid)

    def discard(self, rid: int):
        self.runnable.discard(rid)
        if rid in self._last:
            self._last = [x for x in self._last if x != rid]
        self.reqs.pop(rid, None)

    def active_count(self) -> int:
        return min(self.lanes, len(self.runnable))

    # batched form: same pick, keyed on remaining demand instead
    pick_active = staticmethod(pick_active_batched)


@SCHEDULER_REGISTRY.register("sfs")
class SFSScheduler(Scheduler):
    """The paper's scheduler, adapted to decode lanes (DESIGN.md §2).

    Two levels: a FILTER pool of ``lanes`` worker lanes consuming a global
    FIFO queue with a per-request slice of S ticks (S = mean-IAT * lanes
    over the last N arrivals), and a CFS pool (fair share) for demoted
    requests, which soaks up any lanes the FILTER pool leaves idle —
    work conservation exactly as in the paper.
    """
    name = "sfs"

    def __init__(self, lanes: int, *, slice_ticks: Optional[int] = None,
                 adaptive_window: int = 100, slice_init: int = 32,
                 overload_factor: Optional[float] = 3.0,
                 stall_aware: bool = True, hinted_demotion: bool = False):
        super().__init__(lanes)
        self.queue: deque[int] = deque()        # global FILTER queue
        self.filter_running: list[int] = []
        self.cfs = CFSScheduler(lanes)          # nested fair-share pool
        self.cfs.reqs = self.reqs
        self.fixed_slice = slice_ticks
        self.S = slice_ticks if slice_ticks is not None else slice_init
        self.window = adaptive_window
        self.overload_factor = overload_factor
        self.stall_aware = stall_aware
        self.hinted_demotion = hinted_demotion
        self._iats: deque[int] = deque(maxlen=adaptive_window)
        self._last_arrival: Optional[int] = None
        self._since_update = 0
        self.slice_timeline = BoundedTimeline((0, self.S))
        self.overload_bypasses = 0

    def bind_trace(self, trace, idx: int):
        super().bind_trace(trace, idx)
        self.cfs.bind_trace(trace, idx)     # shared reqs, same server

    # -- adaptive S (paper §V-C) --------------------------------------------
    def _observe(self, t: int):
        if self.fixed_slice is not None:
            return
        if self._last_arrival is not None:
            self._iats.append(t - self._last_arrival)
        self._last_arrival = t
        self._since_update += 1
        if (self._since_update >= self.window
                and len(self._iats) == self.window):
            mean_iat = sum(self._iats) / len(self._iats)
            self.S = max(1, int(round(mean_iat * self.lanes)))
            self._since_update = 0
            self.slice_timeline.append((t, self.S))

    def on_arrival(self, req: Request, t: int):
        self.reqs[req.rid] = req
        self._observe(t)
        if (self.hinted_demotion and req.eta_hint is not None
                and req.eta_hint > self.S):
            # predicted-long: skip FILTER straight to the fair-share
            # pool — saves the wasted slice S and the demotion switch
            req.demoted = True
            self.cfs.on_arrival(req, t)
            if self.trace is not None:
                self.trace.emit(t, "demote", req.rid, self.trace_idx)
            return
        req.queue_enter = t
        self.queue.append(req.rid)

    def select(self, t: int) -> list[int]:
        # 1) fill FILTER lanes from the global queue
        while len(self.filter_running) < self.lanes and self.queue:
            rid = self.queue.popleft()
            r = self.reqs[rid]
            delay = t - r.queue_enter
            r.queue_delay += delay
            if r.first_start is None:
                r.first_start = t
            # §V-E transient overload: bypass FILTER, go straight to CFS
            if (self.overload_factor is not None
                    and delay >= self.overload_factor * self.S):
                self.overload_bypasses += 1
                r.demoted = True
                self.cfs.runnable.add(rid)
                r.vruntime = self.cfs.min_vruntime
                if self.trace is not None:
                    self.trace.emit(t, "bypass", rid, self.trace_idx)
                continue
            if r.slice_left is None or r.slice_left <= 0:
                r.slice_left = self.S
            self.filter_running.append(rid)
            if self.trace is not None:
                self.trace.emit(t, "admit", rid, self.trace_idx)
        # 2) leftover lanes run the CFS pool (work conservation)
        free = self.lanes - len(self.filter_running)
        self.cfs.lanes = free
        cfs_chosen = self.cfs.select(t) if free > 0 else []
        return list(self.filter_running) + cfs_chosen

    def on_tick_end(self, rid: int, t: int, finished: bool):
        r = self.reqs[rid]
        if rid in self.filter_running:
            self._charge(rid)
            r.slice_left -= 1
            if finished:
                self.filter_running.remove(rid)
            elif r.slice_left <= 0:              # 4.2: demote to CFS
                self.filter_running.remove(rid)
                r.n_ctx += 1
                r.demoted = True
                r.vruntime = self.cfs.min_vruntime
                self.cfs.runnable.add(rid)
                if self.trace is not None:
                    self.trace.emit(t, "demote", rid, self.trace_idx)
        else:
            self.cfs.on_tick_end(rid, t, finished)

    def on_stall(self, rid: int, t: int):
        r = self.reqs[rid]
        if rid in self.filter_running:
            # §V-D: park it, keep the unused slice, re-enqueue on wake
            self.filter_running.remove(rid)
            r.n_ctx += 1
            if self.trace is not None:
                self.trace.emit(t, "preempt", rid, self.trace_idx)
            if not self.stall_aware:
                # ablation: slice keeps burning while stalled
                r.slice_left = 0
        else:
            self.cfs.on_stall(rid, t)

    def on_wake(self, rid: int, t: int):
        r = self.reqs[rid]
        if r.demoted:
            self.cfs.on_wake(rid, t)
        else:
            r.queue_enter = t
            self.queue.append(rid)

    def discard(self, rid: int):
        if rid in self.queue:
            self.queue.remove(rid)
        if rid in self.filter_running:
            self.filter_running.remove(rid)
        self.cfs.discard(rid)             # shared reqs dict: one pop

    def active_count(self) -> int:
        return len(self.filter_running)

    def fair_load(self) -> int:
        return len(self.cfs.runnable)


def make_scheduler(policy, lanes: int, **kw) -> Scheduler:
    """Build a lane scheduler from a name, a ``"name:k=v"`` string with
    canonical knob names (``slice``, ``slice_init``, ``adaptive_window``,
    ``overload_factor``, …), or a
    :class:`~repro_torch.core.spec.SchedulerSpec` (registry-backed).  ``kw``
    carries tick-native kwargs (``slice_ticks`` etc.) and overrides
    spec args."""
    spec = SchedulerSpec.parse(policy)
    cls = SCHEDULER_REGISTRY.get(spec.name)
    mapped = {}
    for k, v in spec.args:
        if k not in TICK_SCHED_FIELDS:
            raise ValueError(f"unknown scheduler knob {k!r} for the tick "
                             f"engine; expected one of "
                             f"{tuple(TICK_SCHED_FIELDS)}")
        mapped[TICK_SCHED_FIELDS[k]] = v
    return cls(lanes, **{**mapped, **kw})
