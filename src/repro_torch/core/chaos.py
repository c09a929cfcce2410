"""Chaos subsystem: correlated failure episodes with recovery, and
request-level robustness (timeouts, retries with backoff, hedging,
admission-control shedding) — docs/CLUSTER.md "Chaos and graceful
degradation".

A copy of ``repro.core.chaos`` (the JAX package's module).

Two runtime state machines, both deterministic and engine-agnostic, so
the tick-family backends (which share ``ClusterFrontend``) and the DES
(``core/simulator.py``, seconds) make bit-identical decisions from the
same specs:

* :class:`FaultTimeline` — precomputes the whole failure/recovery
  schedule from a :class:`~repro_torch.core.spec.FaultSpec` at construction
  (episode gaps ~ Exp(mttf), repair durations ~ Exp(mttr), correlated
  blast groups of consecutive servers), so every backend replays the
  identical event list instead of sampling online.  This replaces
  the one-shot ``fail_at``: servers now die repeatedly and COME
  BACK, re-entering dispatch cold (their ``WarmSet`` entries were
  dropped at failure).
* :class:`RetryWatchdog` — per-dispatch deadlines (``timeout``), retry
  accounting with an exponential-backoff hold (``backoff``/``factor``)
  and a retry budget (``retries``; exhaustion sheds the request),
  optional hedged relocation of predicted-short stragglers (``hedge``:
  a request that has run ``hedge x`` its predicted ETA is relocated
  once, without burning budget), and the admission watermark
  (``shed``: fresh arrivals are dropped when outstanding work per
  active lane crosses it).

Both expose a ``next_*`` horizon so ``lifecycle_horizon()`` can clamp
the jax gap/scan fast paths: no fault, recovery, timeout, or retry
release is ever skipped by a multi-tick batch.
"""
from __future__ import annotations

import heapq
import math
from typing import Optional

import numpy as np


class FaultTimeline:
    """Deterministic fail/recover schedule for one fleet.

    Built once from ``(spec, n_servers)``; every backend constructing
    the same pair sees the same event list.  Events are
    ``(time, kind, server)`` with ``kind in ("fail", "recover")``,
    sorted by ``(time, recover-before-fail, server)`` — a repair
    completing at ``t`` lands before a new episode starting at ``t``.

    Episodes are sequential: gap ~ Exp(mttf) after the previous
    episode's repair completes (or after 0 for the first; ``first``
    pins the first failure time exactly), each hitting a blast group
    of ``blast`` consecutive servers starting at
    ``(episode * blast) % n_servers``.  ``mttr=None`` makes failures
    permanent (no recover events).  ``integral=True`` (tick domain)
    rounds times to ints >= 1 and keeps recovery strictly after its
    failure; the DES passes ``integral=False`` for float seconds.
    """

    def __init__(self, spec, n_servers: int, *, integral: bool = True):
        self.spec = spec
        self.n_servers = n_servers
        rng = np.random.default_rng(spec.seed)
        events = []
        t = 0.0
        for ep in range(spec.episodes):
            if ep == 0 and spec.first is not None:
                t = float(spec.first)
            else:
                t += max(float(rng.exponential(spec.mttf)), 1e-9)
            ft = self._q(t, integral)
            base = (ep * spec.blast) % n_servers
            group = sorted({(base + i) % n_servers
                            for i in range(min(spec.blast, n_servers))})
            for s in group:
                events.append((ft, "fail", s))
            if spec.mttr is not None:
                rep = max(float(rng.exponential(spec.mttr)), 1e-9)
                rt = self._q(t + rep, integral)
                if integral and rt <= ft:
                    rt = ft + 1
                for s in group:
                    events.append((rt, "recover", s))
                t += rep
        # recover-before-fail within a time point: a server repaired at
        # t is routable again before a new episode starting at t
        events.sort(key=lambda e: (e[0], e[1] != "recover", e[2]))
        self.events = events
        self._i = 0

    @staticmethod
    def _q(x: float, integral: bool):
        return max(1, int(round(x))) if integral else x

    def due(self, t):
        """Pop and return every event with ``time <= t`` (in order)."""
        out = []
        while self._i < len(self.events) and self.events[self._i][0] <= t:
            out.append(self.events[self._i])
            self._i += 1
        return out

    def next_time(self):
        """Time of the next pending event, or None when exhausted."""
        if self._i < len(self.events):
            return self.events[self._i][0]
        return None


class RetryWatchdog:
    """Per-request robustness bookkeeping shared by every backend.

    The frontend (or DES) calls :meth:`on_dispatch` at each delivery,
    :meth:`complete` at each completion, drains :meth:`expired` /
    :meth:`released` at its lifecycle boundary, and consults
    :attr:`shed` for the admission watermark.  All internal orders are
    ``(time, rid)``-sorted, so the drain order is deterministic and
    identical across backends.
    """

    def __init__(self, spec, *, integral: bool = True):
        self.spec = spec
        self.integral = integral
        self._heap: list = []           # (deadline, rid, gen)
        self._live: dict = {}           # rid -> (gen, server, kind)
        self._gen: dict = {}            # rid -> latest armed generation
        self._attempts: dict = {}       # rid -> timeouts so far
        self._hedged: set = set()       # rids that already relocated once
        self._holds: list = []          # (release, rid)
        self._held: dict = {}           # rid -> request object

    # -- arming --------------------------------------------------------
    def on_dispatch(self, rid: int, server: int, t, eta) -> None:
        """Arm the deadline for this dispatch.  ``eta`` is the routing
        ETA hint (None when the predictor abstained); a hedge deadline
        (``hedge x eta``) is used when it undercuts the hard timeout
        and the request has not hedged yet."""
        spec = self.spec
        deadline, kind = None, None
        if spec.timeout is not None:
            deadline, kind = t + spec.timeout, "timeout"
        if (spec.hedge is not None and eta is not None
                and rid not in self._hedged):
            hd = t + self._up(spec.hedge * eta)
            if deadline is None or hd < deadline:
                deadline, kind = hd, "hedge"
        if deadline is None:
            return
        gen = self._gen.get(rid, 0) + 1
        self._gen[rid] = gen
        self._live[rid] = (gen, server, kind)
        heapq.heappush(self._heap, (deadline, rid, gen))

    def complete(self, rid: int) -> None:
        """The request finished: cancel any armed deadline and drop
        its retry bookkeeping (heap entries die lazily)."""
        self._live.pop(rid, None)
        self._gen.pop(rid, None)
        self._attempts.pop(rid, None)
        self._hedged.discard(rid)

    def disarm(self, rid: int) -> None:
        """Cancel the armed deadline but keep retry state — for a
        request leaving its server through a path that is not a
        completion (e.g. a server-failure requeue); the next dispatch
        re-arms it."""
        self._live.pop(rid, None)

    # -- expiry / holds -------------------------------------------------
    def expired(self, t):
        """Pop every armed deadline ``<= t`` in (deadline, rid) order;
        yields ``(rid, server, kind)`` with kind "timeout" | "hedge"."""
        out = []
        while self._heap and self._heap[0][0] <= t:
            deadline, rid, gen = heapq.heappop(self._heap)
            live = self._live.get(rid)
            if live is None or live[0] != gen:
                continue                 # stale: re-armed or completed
            del self._live[rid]
            out.append((rid, live[1], live[2]))
        return out

    def record_timeout(self, rid: int) -> int:
        """Count one timeout against the budget; returns the attempt
        number (1-based)."""
        n = self._attempts.get(rid, 0) + 1
        self._attempts[rid] = n
        return n

    def exhausted(self, rid: int) -> bool:
        return self._attempts.get(rid, 0) > self.spec.retries

    def backoff_until(self, t, attempt: int):
        """Release time for retry ``attempt`` (1-based): exponential
        backoff ``backoff * factor^(attempt-1)`` after ``t``."""
        spec = self.spec
        if not spec.backoff:
            return t
        return t + self._up(spec.backoff * spec.factor ** (attempt - 1))

    def hold(self, rid: int, req, release) -> None:
        heapq.heappush(self._holds, (release, rid))
        self._held[rid] = req

    def released(self, t):
        """Pop every backoff hold with ``release <= t`` in
        (release, rid) order; yields ``(rid, request)``."""
        out = []
        while self._holds and self._holds[0][0] <= t:
            _, rid = heapq.heappop(self._holds)
            out.append((rid, self._held.pop(rid)))
        return out

    def mark_hedged(self, rid: int) -> None:
        self._hedged.add(rid)

    def forget(self, rid: int) -> None:
        """Drop a shed request entirely."""
        self.complete(rid)
        self._held.pop(rid, None)

    # -- horizons / watermark -------------------------------------------
    @property
    def shed(self) -> Optional[float]:
        return self.spec.shed

    def pending(self) -> int:
        """Requests currently parked in a backoff hold."""
        return len(self._held)

    def next_boundary(self):
        """Earliest armed deadline or hold release, or None — feeds
        ``lifecycle_horizon()`` so fast paths never skip an expiry."""
        best = None
        while self._heap:
            deadline, rid, gen = self._heap[0]
            live = self._live.get(rid)
            if live is None or live[0] != gen:
                heapq.heappop(self._heap)       # stale entry
                continue
            best = deadline
            break
        if self._holds and (best is None or self._holds[0][0] < best):
            best = self._holds[0][0]
        return best

    def _up(self, x):
        """Round a derived duration up to the engine's grain: ceil to
        int ticks in the tick domain (min 1), raw float seconds in
        the DES."""
        return max(1, math.ceil(x)) if self.integral else x
