"""Online duration prediction — learned ETA hints for three-level SFS.

A copy of ``repro.core.predict`` (the JAX package's module); the
predictor registry's provider is this module.

The paper's per-server FILTER needs no duration knowledge (run first,
demote on slice expiry), but the cluster dispatch tier above it
(``repro_torch.core.dispatch``) routes by an ETA estimate.  An oracle —
the front-end handing dispatch each request's true service demand —
is what no real FaaS platform has.  This module replaces
the oracle with a pluggable predictor subsystem learned from execution
history, following:

* Przybylski et al., "Data-driven scheduling in serverless computing":
  per-function estimates from past execution durations are accurate
  enough to drive scheduling decisions (``history``).
* Kaffes et al., "Practical Scheduling for Real-World Serverless
  Computing": a coarse short/long classifier with a safety margin is
  often all the dispatcher needs (``class``).

Design rules:

* Predictors are **engine-agnostic**: they see only opaque ``func_id``
  keys and durations in whatever unit the owner uses (DES seconds,
  tick-engine ticks).  Both cluster implementations consume the same
  objects through :func:`repro_torch.core.dispatch.route_hinted`.
* **No oracle leakage**: ``observe`` is called by the owner only when a
  request *finishes* (enforced by tests), and ``predict`` never sees
  ground truth.  Only :class:`OracleEta` consumes the ``true_eta``
  argument of :meth:`EtaPredictor.estimate` — it models a front-end
  that genuinely knows the demand (e.g. a max-tokens cap), and exists
  for back-compat cross-validation against the legacy ``hinted=True``.
"""
from __future__ import annotations

import bisect
from collections import deque
from typing import Optional

from repro_torch.core.spec import PREDICTOR_REGISTRY, PredictorSpec


class EtaPredictor:
    """Duration-predictor interface for cluster dispatch.

    ``predict(func_id)`` returns the estimated service demand of the
    next invocation of ``func_id`` (owner units), or None when the
    predictor has nothing to say — dispatch then falls back to FILTER's
    optimism (unknown == short).  ``observe(func_id, true_service)``
    closes the feedback loop; owners call it only for finished requests.
    """

    name = "base"

    def predict(self, func_id) -> Optional[float]:
        raise NotImplementedError

    def observe(self, func_id, true_service: float):
        pass

    def estimate(self, func_id, true_eta: Optional[float] = None
                 ) -> Optional[float]:
        """Routing-time hint.  Learned predictors ignore ``true_eta``
        (the ground truth known to the simulation harness); only the
        oracle consumes it."""
        return self.predict(func_id)


@PREDICTOR_REGISTRY.register("oracle")
class OracleEta(EtaPredictor):
    """Front-end knows the true demand (the legacy ``hinted=True``)."""

    name = "oracle"

    def predict(self, func_id) -> Optional[float]:
        return None                     # no learned per-function state

    def estimate(self, func_id, true_eta=None):
        return true_eta


@PREDICTOR_REGISTRY.register("none")
class NoneEta(EtaPredictor):
    """Blind dispatch (the legacy ``hinted=False``): every request routes as
    unknown, i.e. optimistically short."""

    name = "none"

    def predict(self, func_id) -> Optional[float]:
        return None


@PREDICTOR_REGISTRY.register("history")
class HistoryEta(EtaPredictor):
    """Per-function online mean/EWMA with a global-quantile cold start.

    Per Przybylski et al.: the estimate for a function with execution
    history is a running mean of its observed durations (``alpha=None``)
    or an EWMA with floor ``alpha`` (running mean while 1/n > alpha,
    then exponential — adapts to drifting functions).  ``mode="median"``
    uses the median of the last ``recent_window`` observations instead.

    A function with fewer than ``min_obs`` observations falls back to
    the ``cold_quantile`` of the global duration distribution (over the
    last ``global_window`` completions, any function) — the data-driven
    prior for a never-seen function.  With no completions at all the
    predictor returns None (unknown == short, FILTER's optimism).

    ``window`` (mean mode only) bounds the per-function memory: the
    estimate becomes the mean of the last ``window`` observations,
    tracking drifting functions (e.g. the ``drift`` workload stage)
    without EWMA tuning.  None keeps the unbounded running mean —
    bit-exact legacy behaviour.
    """

    name = "history"

    def __init__(self, alpha: Optional[float] = None, mode: str = "mean",
                 min_obs: int = 1, cold_quantile: float = 0.5,
                 global_window: int = 4096, recent_window: int = 64,
                 window: Optional[int] = None):
        if mode not in ("mean", "median"):
            raise ValueError(f"unknown history mode: {mode!r}")
        if window is not None and int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window!r}")
        self.alpha = alpha
        self.mode = mode
        self.window = None if window is None else int(window)
        self._windowed: dict = {}
        # a function needs at least one observation before per-function
        # state exists, so min_obs=0 would KeyError on never-seen ids —
        # clamp; the cold-start fallback is the 0-observation answer
        self.min_obs = max(1, int(min_obs))
        self.cold_quantile = float(cold_quantile)
        self.n_observed = 0
        self._mean: dict = {}
        self._count: dict = {}
        self._recent: dict = {}
        self._recent_window = int(recent_window)
        self._global: deque = deque(maxlen=int(global_window))
        self._gsorted: Optional[list] = None

    # -- feedback ----------------------------------------------------------
    def observe(self, func_id, true_service: float):
        s = float(true_service)
        c = self._count.get(func_id, 0) + 1
        self._count[func_id] = c
        a = 1.0 / c if self.alpha is None else max(self.alpha, 1.0 / c)
        m = self._mean.get(func_id, 0.0)
        self._mean[func_id] = m + a * (s - m)
        if self.mode == "median":
            self._recent.setdefault(
                func_id, deque(maxlen=self._recent_window)).append(s)
        if self.window is not None:
            self._windowed.setdefault(
                func_id, deque(maxlen=self.window)).append(s)
        # keep the sorted quantile window incrementally (predict() may
        # need a quantile on every routing decision — re-sorting the
        # whole window per observation would be O(W log W) each)
        if self._gsorted is not None:
            if len(self._global) == self._global.maxlen:
                evicted = self._global[0]
                del self._gsorted[bisect.bisect_left(self._gsorted,
                                                     evicted)]
            bisect.insort(self._gsorted, s)
        self._global.append(s)
        self.n_observed += 1

    # -- estimates ---------------------------------------------------------
    def global_quantile(self, q: Optional[float] = None) -> Optional[float]:
        """Linear-interpolated quantile of recent durations (any function);
        None before the first observation."""
        if not self._global:
            return None
        if self._gsorted is None:
            self._gsorted = sorted(self._global)
        xs = self._gsorted
        q = self.cold_quantile if q is None else q
        pos = q * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    def predict(self, func_id) -> Optional[float]:
        if self._count.get(func_id, 0) >= self.min_obs:
            if self.mode == "median":
                xs = sorted(self._recent[func_id])
                mid = len(xs) // 2
                return (xs[mid] if len(xs) % 2
                        else 0.5 * (xs[mid - 1] + xs[mid]))
            if self.window is not None:
                w = self._windowed[func_id]
                return sum(w) / len(w)
            return self._mean[func_id]
        return self.global_quantile()


@PREDICTOR_REGISTRY.register("class")
class ClassEta(HistoryEta):
    """Short/long classifier with a safety margin, per Kaffes et al.

    The duration axis is split at the ``boundary_quantile`` of the
    global distribution (unit-free — no fixed cutoff, so the same
    predictor serves DES seconds and tick-engine ticks).  A function is
    *short* only when its historical mean times ``safety_margin`` stays
    below the boundary — borderline functions are treated long, because
    a long function misrouted into FILTER-rich servers clogs short
    lanes, while a short one misrouted long merely queues behind the
    fair-share pool.  Short functions report the ``short_quantile`` of
    the global distribution, long ones max(mean x margin, the
    ``long_quantile``); never-seen functions return None (optimistic).

    Defaults are the knobs tuned in ``benchmarks/predict_sweep.py``
    (``margin=1, boundary=0.75``), validated by a non-smoke sweep across
    loads 0.6-1.2 (bursty arrivals, hinted demotion): misclassification
    vs the dispatcher's S drops ~42% -> ~10% and short-function P99
    improves 1.6-6.3x over the legacy ``margin=2, boundary=0.5`` at
    every load, at <10% long-P99 cost.  On the Azure-shaped bimodal
    duration law the short mode is far below the long mode, so the
    boundary belongs *above* the median (most requests are short) and
    the extra safety margin only misroutes borderline shorts.
    """

    name = "class"

    def __init__(self, safety_margin: float = 1.0,
                 boundary_quantile: float = 0.75,
                 short_quantile: float = 0.25,
                 long_quantile: float = 0.9, **kw):
        if kw.get("mode", "mean") != "mean":
            raise ValueError("class predictor classifies on the running "
                             "mean; mode is not configurable")
        super().__init__(**kw)
        self.safety_margin = float(safety_margin)
        self.boundary_quantile = float(boundary_quantile)
        self.short_quantile = float(short_quantile)
        self.long_quantile = float(long_quantile)

    def predict(self, func_id) -> Optional[float]:
        boundary = self.global_quantile(self.boundary_quantile)
        if boundary is None or self._count.get(func_id, 0) < self.min_obs:
            return None
        if self._mean[func_id] * self.safety_margin <= boundary:
            return self.global_quantile(self.short_quantile)
        return max(self._mean[func_id] * self.safety_margin,
                   self.global_quantile(self.long_quantile))


PREDICTORS = tuple(PREDICTOR_REGISTRY)


def make_predictor(spec="oracle") -> EtaPredictor:
    """Build a predictor from a spec: an :class:`EtaPredictor` instance
    (returned as-is, so one object can be shared/pre-trained), a
    :class:`~repro_torch.core.spec.PredictorSpec`, or a string ``"name"`` /
    ``"name:key=val,key=val"``, e.g.
    ``"history:alpha=0.25,mode=median"`` (registry-backed)."""
    if isinstance(spec, EtaPredictor):
        return spec
    return PredictorSpec.parse(spec).build()


# ---------------------------------------------------------------------------
# Prediction-quality accounting (benchmarks/predict_sweep.py)
# ---------------------------------------------------------------------------


def prediction_metrics(pairs, boundary: Optional[float] = None) -> dict:
    """Error metrics over ``(eta, true_service)`` routing outcomes.

    ``eta`` None (no estimate) counts against coverage but not MAPE.
    ``boundary`` (e.g. the dispatcher's slice S) adds the short/long
    misclassification rate: requests whose predicted class (eta <=
    boundary, None == short) differs from the true one.
    """
    pairs = list(pairs)
    n = len(pairs)
    known = [(e, s) for e, s in pairs if e is not None]
    out = {
        "n": n,
        "coverage": len(known) / n if n else 0.0,
        "mape": (sum(abs(e - s) / max(s, 1e-12) for e, s in known)
                 / len(known)) if known else float("nan"),
    }
    if boundary is not None and n:
        wrong = sum(1 for e, s in pairs
                    if ((e is None or e <= boundary) != (s <= boundary)))
        out["misclass_vs_S"] = wrong / n
    return out
