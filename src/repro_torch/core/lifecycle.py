"""Fleet lifecycle runtime: warm sets, autoscaling decisions.

A copy of ``repro.core.lifecycle`` (the JAX package's module).

The declarative knobs live in :class:`repro_torch.core.spec.LifecycleSpec` /
:class:`~repro_torch.core.spec.ScalingSpec`; this module holds the small
deterministic state machines both cluster owners share — the tick-family
:class:`~repro_torch.serving.cluster.ClusterFrontend` and the DES
:class:`~repro.core.simulator.ClusterSimulator` — so cold-start,
keep-alive, autoscale and failure decisions are made by *one* code path
regardless of stepping backend (the property the cross-engine trace
equality tests lean on, docs/CLUSTER.md).

Time is engine-native (integer ticks or float seconds); nothing here
cares which, only that it is monotone.
"""
from __future__ import annotations

from typing import Optional


class WarmSet:
    """Per-server warm-container sets keyed by ``func_id``.

    A dispatch is *cold* when the function is absent from the target
    server's warm set or its last dispatch is older than ``keep_alive``.
    ``touch`` refreshes the function's last-use time and, beyond
    ``cap`` distinct warm functions, evicts the least-recently-used
    (ties break on the smaller func_id — deterministic across runs).
    """

    __slots__ = ("keep_alive", "cap", "_warm")

    def __init__(self, n_servers: int, keep_alive=None, cap: int = 0):
        self.keep_alive = keep_alive
        self.cap = int(cap or 0)
        self._warm: list = [dict() for _ in range(n_servers)]

    def is_cold(self, idx: int, func: int, t) -> bool:
        last = self._warm[idx].get(func)
        if last is None:
            return True
        return self.keep_alive is not None and t - last > self.keep_alive

    def touch(self, idx: int, func: int, t):
        w = self._warm[idx]
        w[func] = t
        if self.cap and len(w) > self.cap:
            victim = min(w.items(), key=lambda kv: (kv[1], kv[0]))[0]
            del w[victim]

    def fail(self, idx: int):
        """A dead server loses every warm container."""
        self._warm[idx].clear()

    def warm_count(self, idx: int) -> int:
        return len(self._warm[idx])


class Autoscaler:
    """Deterministic load-signal scaling decisions over a fleet.

    Membership itself is owned by the caller (active list + dead set);
    :meth:`decide` just returns the toggles for one evaluation:
    utilization ``load / active lanes`` above ``up`` activates up to
    ``step`` drained servers (lowest index first, capped at ``max``);
    below ``down`` it drains up to ``step`` active servers (highest
    index first, floored at ``min``).  Dead servers never reactivate
    through scaling — a server killed by a :class:`FaultTimeline`
    episode only returns when its scheduled recovery removes it from
    ``dead`` (``core/chaos.py``), after which scale-up may re-admit it.
    """

    __slots__ = ("n", "lanes", "min", "max", "period", "up", "down",
                 "step")

    def __init__(self, spec, n_servers: int, lanes):
        self.n = int(n_servers)
        self.lanes = list(lanes)
        self.min = max(1, int(spec.min_servers))
        mx = spec.max_servers
        self.max = self.n if mx is None else min(int(mx), self.n)
        if self.min > self.n:
            raise ValueError(f"scaling min={self.min} exceeds fleet "
                             f"size {self.n}")
        self.period = int(spec.period)
        self.up = float(spec.up)
        self.down = float(spec.down)
        self.step = max(1, int(spec.step))

    def initial_active(self) -> list:
        return list(range(self.min))

    def decide(self, load, active, dead) -> list:
        """``(idx, +1 | -1)`` toggles for this boundary, or ``[]``."""
        cap = sum(self.lanes[i] for i in active)
        util = (load / cap) if cap > 0 else float("inf")
        if util > self.up:
            live_cap = min(self.max, self.n - len(dead))
            room = max(0, live_cap - len(active))
            grow = [i for i in range(self.n)
                    if i not in active and i not in dead]
            return [(i, +1) for i in grow[:min(self.step, room)]]
        if util < self.down and len(active) > self.min:
            k = min(self.step, len(active) - self.min)
            return [(i, -1) for i in sorted(active, reverse=True)[:k]]
        return []


def lifecycle_horizon(t, fail_at, scaler: Optional[Autoscaler],
                      extras=()):
    """Earliest future time a lifecycle decision can fire at/after ``t``
    (a pending failure, the next autoscale boundary, or any of the
    ``extras`` — chaos boundaries like the next
    :meth:`~repro_torch.core.chaos.FaultTimeline.next_time` fault/recovery
    or :meth:`~repro_torch.core.chaos.RetryWatchdog.next_boundary` deadline/
    backoff release; None entries are ignored), or None when no
    decision is pending.  Event-driven backends (the jax fast-forward,
    the DES event heap) must not advance past it without evaluating the
    decision at exactly that time."""
    h = None
    if fail_at is not None:
        h = fail_at if fail_at > t else t
    if scaler is not None:
        p = scaler.period
        b = t if t % p == 0 else (t // p + 1) * p
        h = b if h is None else min(h, b)
    for x in extras:
        if x is None:
            continue
        x = x if x > t else t
        h = x if h is None else min(h, x)
    return h
