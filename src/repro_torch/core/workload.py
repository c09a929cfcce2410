"""Registered workload stages of the tick family (``WORKLOAD_REGISTRY``).

A copy of the staged-workload part of ``repro.core.workload`` (the JAX
package's module).  The DES workload generator of that module
(``FaaSBenchConfig``, the Azure duration tables) is not ported.

Stages compose through the WorkloadSpec pipe grammar
(``"bimodal:n=800|zipf:funcs=16|flash:at=600,x=4"``): the first stage is
a *generator* (``generate(total_lanes) -> [serving Request]``) and every
later stage a *transform* (``apply(reqs, total_lanes) -> same list``,
mutated in place).  All stages operate on the mutable serving
:class:`~repro_torch.serving.request.Request`; transforms are
deterministic given their knobs.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.spec import WORKLOAD_REGISTRY, TickWorkloadSpec

# the legacy bimodal tick workload is just the first registered
# generator, not a special case
WORKLOAD_REGISTRY.register("bimodal")(TickWorkloadSpec)


@WORKLOAD_REGISTRY.register("zipf")
class ZipfPopularity:
    """Assign ``func_id`` by Zipf(s) popularity over ``funcs`` functions.

    Rank-1 is the most popular; weights are ``rank**-s`` normalized.
    Stresses warm-set keep-alive (popular functions stay warm, the tail
    cold-starts) and the per-function duration predictors.
    """

    def __init__(self, funcs: int = 16, s: float = 1.1, seed: int = 101):
        if funcs < 1:
            raise ValueError("zipf needs funcs >= 1")
        self.funcs, self.s, self.seed = int(funcs), float(s), int(seed)

    def apply(self, reqs, total_lanes):
        ranks = np.arange(1, self.funcs + 1, dtype=np.float64)
        p = ranks ** -self.s
        p /= p.sum()
        rng = np.random.default_rng(self.seed)
        fids = rng.choice(self.funcs, size=len(reqs), p=p)
        for r, f in zip(reqs, fids.tolist()):
            r.func_id = int(f)
        return reqs


@WORKLOAD_REGISTRY.register("drift")
class DurationDrift:
    """Duration-regime drift: from arrival time ``at`` on, every
    request's decode demand scales by ``x`` (the case that stresses
    history/class predictors — Przybylski et al.).  Front-end hints
    track the new demand so oracle parity is preserved."""

    def __init__(self, at: int = 0, x: float = 2.0):
        if x <= 0:
            raise ValueError("drift needs x > 0")
        self.at, self.x = int(at), float(x)

    def apply(self, reqs, total_lanes):
        for r in reqs:
            if r.arrival >= self.at:
                r.n_tokens = max(1, int(r.n_tokens * self.x))
                if r.eta_hint is not None:
                    r.eta_hint = r.n_tokens + 1
        return reqs


@WORKLOAD_REGISTRY.register("flash")
class FlashCrowd:
    """Flash crowd: arrivals inside ``[at, at+dur)`` are compressed
    ``x``-fold toward ``at`` and the tail shifts left to close the gap,
    so the same requests land ``x`` times as densely (a transient
    overload spike, Fig. 12 style) without changing total work."""

    def __init__(self, at: int = 0, x: float = 4.0, dur: int = 100):
        if x < 1:
            raise ValueError("flash needs x >= 1")
        if dur < 1:
            raise ValueError("flash needs dur >= 1")
        self.at, self.x, self.dur = int(at), float(x), int(dur)

    def apply(self, reqs, total_lanes):
        shift = int(self.dur - self.dur / self.x)
        for r in reqs:
            if self.at <= r.arrival < self.at + self.dur:
                r.arrival = self.at + int((r.arrival - self.at) / self.x)
            elif r.arrival >= self.at + self.dur:
                r.arrival -= shift
        return reqs


@WORKLOAD_REGISTRY.register("diurnal")
class DiurnalModulation:
    """Sinusoidal arrival-time warp with period ``period`` and
    amplitude ``amp`` (< 1 keeps the warp monotone: the instantaneous
    rate swings between ``1/(1+amp)`` and ``1/(1-amp)`` of nominal)."""

    def __init__(self, period: int = 500, amp: float = 0.5):
        if period < 1:
            raise ValueError("diurnal needs period >= 1")
        if not 0.0 <= amp < 1.0:
            raise ValueError("diurnal needs 0 <= amp < 1")
        self.period, self.amp = int(period), float(amp)

    def apply(self, reqs, total_lanes):
        w = 2.0 * math.pi / self.period
        for r in reqs:
            r.arrival = max(0, int(r.arrival
                                   + self.amp / w * math.sin(w * r.arrival)))
        return reqs
