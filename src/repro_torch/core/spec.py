"""Typed, registry-backed experiment specs — the port's config surface.

A copy of ``repro.core.spec`` (the JAX package's module).  The four
registries name this package's modules as providers, so a lookup never
imports the JAX package.

* ``SchedulerSpec`` / ``DispatchSpec`` / ``PredictorSpec`` — typed
  ``name + args`` specs with a canonical string form
  (``"sfs-aware:overload_factor=3,adaptive_window=100"``, short aliases
  like ``O=3,N=100`` accepted on parse) that round-trips:
  ``parse(str(spec)) == spec``.
* ``ServerSpec`` — one server's shape: ``cores`` (DES cores == tick
  decode lanes), its scheduler spec, and cache ``slots`` (tick only).
* ``ExperimentSpec`` — workload + engine + servers + dispatch +
  predictor + lifecycle/chaos knobs, runnable through
  :func:`run_experiment`, which returns one :class:`ExperimentResult`.
  The engines are the discrete-event simulator ``des``
  (:mod:`repro_torch.core.simulator`, seconds, host Python) and the three
  tick-semantics backends: ``torch`` (the fleet stepping on the device,
  :mod:`repro_torch.serving.torch_cluster`, the counterpart of the JAX
  package's ``jax``), ``tick`` (per-object engines,
  :mod:`repro_torch.serving.cluster`) and ``vector`` (numpy
  struct-of-arrays groups, :mod:`repro_torch.serving.vector_cluster`);
  ``des``, ``tick`` and ``vector`` are host code.

Scheduler knob names are canonical and unit-free here (``slice_init``,
``slice`` …); the per-engine converters map them onto each engine's
native fields (``slice_init_s`` seconds in the DES, ``slice_init`` ticks
in the tick engine).  :meth:`ExperimentSpec.to_json` gives the same
provenance dict as the JAX package's for the same spec, and
:meth:`ExperimentSpec.from_json` rebuilds a spec from either package's.

The JAX package's ``jax`` engine is ``torch`` here; naming it raises.
This module imports nothing heavier than numpy at module scope; engine
construction is lazy.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import time
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "Registry", "SCHEDULER_REGISTRY", "DISPATCH_REGISTRY",
    "PREDICTOR_REGISTRY", "WORKLOAD_REGISTRY", "DES_POLICIES",
    "SchedulerSpec", "DispatchSpec", "PredictorSpec", "LifecycleSpec",
    "ScalingSpec", "FaultSpec", "RetrySpec", "ServerSpec",
    "TickWorkloadSpec", "WorkloadStageSpec", "WorkloadSpec",
    "ExperimentSpec", "ExperimentResult", "run_experiment",
    "resolve_dispatch",
]


# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------


class Registry:
    """Name -> implementation class registry with decorator registration.

    ``provider`` is the module whose import populates the registry; it is
    imported lazily on first lookup, so specs can be parsed and compared
    without pulling any engine code.
    """

    def __init__(self, kind: str, provider: str):
        self.kind = kind
        self.provider = provider
        self._classes: dict = {}
        self._loaded = False

    def register(self, name: str):
        def deco(cls):
            prev = self._classes.get(name)
            if prev is not None and (prev.__module__, prev.__qualname__) \
                    != (cls.__module__, cls.__qualname__):
                raise ValueError(
                    f"duplicate {self.kind} registration: {name!r}")
            # same module+qualname == a provider re-import (reload, or a
            # retried import after a transient failure): last wins
            self._classes[name] = cls
            return cls
        return deco

    def _ensure(self):
        # gate on successful provider import, not on _classes being
        # non-empty — a partial (failed) import must be retried, not
        # frozen as "these are all the implementations"
        if not self._loaded:
            importlib.import_module(self.provider)
            self._loaded = True

    def names(self) -> tuple:
        self._ensure()
        return tuple(self._classes)

    def get(self, name: str):
        self._ensure()
        try:
            return self._classes[name]
        except KeyError:
            raise ValueError(f"unknown {self.kind} {name!r}; "
                             f"expected one of {tuple(self._classes)}") \
                from None

    def __contains__(self, name) -> bool:
        self._ensure()
        return name in self._classes

    def __iter__(self):
        self._ensure()
        return iter(self._classes)


SCHEDULER_REGISTRY = Registry("scheduler", "repro_torch.serving.schedulers")
DISPATCH_REGISTRY = Registry("dispatch", "repro_torch.core.dispatch")
PREDICTOR_REGISTRY = Registry("predictor", "repro_torch.core.predict")
WORKLOAD_REGISTRY = Registry("workload", "repro_torch.core.workload")

# DES per-server policies are simulator modes, not factory classes, so
# they are validated against this fixed set instead of a registry.
DES_POLICIES = ("sfs", "cfs", "fifo", "rr", "srtf", "ideal")

# the JAX package's engine that this package does not run (its
# counterpart here is "torch")
NOT_PORTED = ("jax",)
ENGINES = ("torch", "des", "tick", "vector")


# ---------------------------------------------------------------------------
# name:key=val spec grammar
# ---------------------------------------------------------------------------


def _coerce(v: str):
    """Parse one spec value: int, float, bool, None, else string."""
    s = str(v).strip()
    low = s.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low == "null" or s == "None":
        return None
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


class _SpecBase:
    """Shared behaviour of the ``name + args`` spec family.

    ``args`` is a canonically-sorted tuple of ``(key, value)`` pairs —
    hashable, order-independent, and alias-normalized at construction,
    so two specs that mean the same thing compare equal regardless of
    how they were written.
    """

    ALIASES: dict = {}

    def __post_init__(self):
        raw = self.args.items() if isinstance(self.args, dict) else self.args
        seen: dict = {}
        for k, v in raw:
            k = self.ALIASES.get(str(k), str(k))
            if not k or any(c in k for c in ":,= "):
                raise ValueError(f"spec arg key {k!r} contains grammar "
                                 "separators")
            # fail fast on values the unquoted grammar cannot carry —
            # non-scalars, separators, and strings that reparse as
            # another literal ("true", "5", ...) — keeping
            # parse(str(spec)) == spec an invariant, not a convention
            if not isinstance(v, (str, int, float, bool, type(None))):
                raise ValueError(f"spec arg {k}={v!r}: only scalar "
                                 "values survive the string grammar")
            if isinstance(v, str):
                if any(c in v for c in ":,="):
                    raise ValueError(f"spec arg {k}={v!r} contains "
                                     "grammar separators")
                if _coerce(v) != v:
                    raise ValueError(
                        f"spec arg {k}={v!r} would not round-trip "
                        f"through the string form (parses as "
                        f"{_coerce(v)!r})")
            seen[k] = v
        object.__setattr__(self, "args", tuple(sorted(seen.items())))

    @property
    def kwargs(self) -> dict:
        return dict(self.args)

    @classmethod
    def parse(cls, spec):
        """``"name"`` / ``"name:k=v,k=v"`` (or an instance) -> spec."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, _SpecBase):
            raise TypeError(f"cannot parse {type(spec).__name__} "
                            f"as {cls.__name__}")
        name, _, argstr = str(spec).partition(":")
        args = []
        for part in argstr.split(",") if argstr else ():
            k, eq, v = part.partition("=")
            if not eq:
                raise ValueError(f"malformed spec arg {part!r} in {spec!r} "
                                 "(expected key=value)")
            args.append((k.strip(), _coerce(v)))
        return cls(name=name.strip(), args=tuple(args))

    def __str__(self) -> str:
        if not self.args:
            return self.name
        return self.name + ":" + ",".join(f"{k}={v}" for k, v in self.args)

    def with_args(self, **kw):
        """New spec with ``kw`` set (overriding existing keys)."""
        merged = self.kwargs
        merged.update(kw)
        return dataclasses.replace(self, args=tuple(merged.items()))

    def with_defaults(self, **kw):
        """New spec with ``kw`` filled in only where not already set."""
        have = self.kwargs
        merged = {self.ALIASES.get(k, k): v for k, v in kw.items()}
        merged.update(have)
        return dataclasses.replace(self, args=tuple(merged.items()))


# canonical scheduler knob -> DES SimConfig field (seconds)
DES_SCHED_FIELDS = {
    "slice": "slice_s",
    "slice_init": "slice_init_s",
    "adaptive_window": "adaptive_window",
    "overload_factor": "overload_factor",
    "io_aware": "io_aware",
    "poll_interval": "poll_interval_s",
    "hinted_demotion": "hinted_demotion",
    "rr_quantum": "rr_quantum_s",
    "cfs_latency": "cfs_latency_s",
    "cfs_min_gran": "cfs_min_gran_s",
    "ctx_switch_cost": "ctx_switch_cost_s",
}

# canonical scheduler knob -> tick-engine make_scheduler kwarg (ticks)
TICK_SCHED_FIELDS = {
    "slice": "slice_ticks",
    "slice_init": "slice_init",
    "adaptive_window": "adaptive_window",
    "overload_factor": "overload_factor",
    "stall_aware": "stall_aware",
    "hinted_demotion": "hinted_demotion",
}


@dataclasses.dataclass(frozen=True)
class SchedulerSpec(_SpecBase):
    """Per-server scheduling policy + knobs, engine-agnostic.

    Knob names are canonical (``slice``, ``slice_init``,
    ``adaptive_window``, ``overload_factor``, …); the engine converters
    (:meth:`ServerSpec.to_sim_config` / :meth:`ServerSpec.to_engine_config`)
    map them to the engine's native field names and units.
    """

    name: str = "sfs"
    args: tuple = ()

    ALIASES = {"O": "overload_factor", "N": "adaptive_window",
               "window": "adaptive_window", "S": "slice",
               "init": "slice_init"}


@dataclasses.dataclass(frozen=True)
class DispatchSpec(_SpecBase):
    """Cluster dispatch policy + knobs (level 3).

    ``"sfs-aware:O=3,N=100"`` parses to
    ``DispatchSpec("sfs-aware", (("adaptive_window", 100),
    ("overload_factor", 3)))``.  Args map 1:1 onto the policy
    constructor's kwargs (``overload_factor``, ``adaptive_window``,
    ``slice_init`` — owner units: DES seconds, tick-engine ticks).
    """

    name: str = "hash"
    args: tuple = ()

    ALIASES = {"O": "overload_factor", "N": "adaptive_window",
               "window": "adaptive_window", "init": "slice_init"}

    def build(self, views):
        cls = DISPATCH_REGISTRY.get(self.name)
        return cls(views, **self.kwargs)


@dataclasses.dataclass(frozen=True)
class PredictorSpec(_SpecBase):
    """Duration-predictor spec (``repro_torch.core.predict``).

    Exposes every predictor knob declaratively — including the ``class``
    predictor's quantile knobs (``safety_margin``, ``boundary_quantile``,
    ``short_quantile``, ``long_quantile``), swept in
    ``benchmarks/predict_sweep.py``.  ``"history:warmup=2"`` ==
    ``"history:min_obs=2"``.
    """

    name: str = "oracle"
    args: tuple = ()

    ALIASES = {"warmup": "min_obs", "margin": "safety_margin",
               "boundary": "boundary_quantile", "short": "short_quantile",
               "long": "long_quantile", "cold": "cold_quantile"}

    def build(self):
        cls = PREDICTOR_REGISTRY.get(self.name)
        return cls(**self.kwargs)


def resolve_dispatch(policy, *, overload_factor=None, adaptive_window=None,
                     slice_init=None) -> DispatchSpec:
    """The one shared dispatch-wiring path for both cluster owners.

    Parses ``policy`` (name, ``"name:k=v"`` string, or DispatchSpec) and,
    for ``sfs-aware``, fills the owner's legacy knob fields in as
    defaults — explicit spec args always win.  Replaces the hand-rolled
    ``kw = {...}`` blocks that used to be duplicated in
    ``ClusterSimulator`` and ``Cluster``.
    """
    spec = DispatchSpec.parse(policy)
    if spec.name == "sfs-aware":
        legacy = {"overload_factor": overload_factor,
                  "adaptive_window": adaptive_window,
                  "slice_init": slice_init}
        spec = spec.with_defaults(**{k: v for k, v in legacy.items()
                                     if v is not None})
    return spec


# ---------------------------------------------------------------------------
# Fleet lifecycle specs (cold starts / keep-alive / failure, autoscaling)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LifecycleSpec(_SpecBase):
    """Cold starts, keep-alive and server failure for a cluster run.

    The runtime lives in :mod:`repro_torch.core.lifecycle`
    (docs/CLUSTER.md); every knob is engine-native time units (ticks
    for the tick family, seconds for the DES):

    * ``cold`` — extra service demand charged when a request's
      ``func_id`` is not warm on the server it lands on (0 disables).
    * ``keep_alive`` (alias ``ttl``) — warm-container time-to-live
      since last dispatch; omitted/None keeps containers warm forever.
    * ``warm_cap`` (alias ``cap``) — max distinct warm functions per
      server, evicting least-recently-used beyond it (0 = unbounded).
    * ``fail_at`` (alias ``fail``) / ``fail_server`` — kill server
      ``fail_server`` at time ``fail_at``: its in-flight and queued
      requests are reset and re-enter dispatch (``requeue`` events),
      and the server never returns.
    """

    name: str = "lifecycle"
    args: tuple = ()

    ALIASES = {"ttl": "keep_alive", "cap": "warm_cap", "fail": "fail_at"}
    _KNOWN = ("cold", "keep_alive", "warm_cap", "fail_at", "fail_server")

    def __post_init__(self):
        super().__post_init__()
        if self.name != "lifecycle":
            raise ValueError(f"LifecycleSpec name must be 'lifecycle', "
                             f"got {self.name!r}")
        for k, _ in self.args:
            if k not in self._KNOWN:
                raise ValueError(f"unknown lifecycle knob {k!r}; expected "
                                 f"one of {self._KNOWN}")

    @property
    def cold(self):
        return self.kwargs.get("cold", 0)

    @property
    def keep_alive(self):
        return self.kwargs.get("keep_alive")

    @property
    def warm_cap(self) -> int:
        return self.kwargs.get("warm_cap", 0)

    @property
    def fail_at(self):
        return self.kwargs.get("fail_at")

    @property
    def fail_server(self) -> int:
        return self.kwargs.get("fail_server", 0)


@dataclasses.dataclass(frozen=True)
class ScalingSpec(_SpecBase):
    """Load-signal autoscaler over the server fleet (docs/CLUSTER.md).

    Every ``period`` time units the frontend computes fleet utilization
    ``(outstanding + central queue) / active lanes`` and toggles
    membership: above ``up`` it activates up to ``step`` drained
    servers (lowest index first, never beyond ``max``); below ``down``
    it drains up to ``step`` active servers (highest index first,
    never below ``min``).  Draining is graceful: in-flight work
    completes, the server just stops receiving dispatches.  The run
    starts with servers ``0..min-1`` active.
    """

    name: str = "scale"
    args: tuple = ()

    ALIASES = {"T": "period"}
    _KNOWN = ("min", "max", "period", "up", "down", "step")

    def __post_init__(self):
        super().__post_init__()
        if self.name != "scale":
            raise ValueError(f"ScalingSpec name must be 'scale', "
                             f"got {self.name!r}")
        for k, _ in self.args:
            if k not in self._KNOWN:
                raise ValueError(f"unknown scaling knob {k!r}; expected "
                                 f"one of {self._KNOWN}")
        if self.period < 1:
            raise ValueError(f"scaling period must be >= 1, "
                             f"got {self.period!r}")
        if self.min_servers < 1:
            raise ValueError("scaling min must be >= 1")

    @property
    def min_servers(self) -> int:
        return self.kwargs.get("min", 1)

    @property
    def max_servers(self):
        return self.kwargs.get("max")         # None == fleet size

    @property
    def period(self) -> int:
        return self.kwargs.get("period", 100)

    @property
    def up(self) -> float:
        return self.kwargs.get("up", 0.75)

    @property
    def down(self) -> float:
        return self.kwargs.get("down", 0.25)

    @property
    def step(self) -> int:
        return self.kwargs.get("step", 1)


@dataclasses.dataclass(frozen=True)
class FaultSpec(_SpecBase):
    """Correlated, repeated failure episodes with recovery
    (docs/CLUSTER.md "Chaos and graceful degradation").

    Replaces the one-shot ``fail_at``/``fail_server`` pair with a
    deterministic schedule precomputed by
    :class:`~repro_torch.core.chaos.FaultTimeline` — every backend replays
    the same events.  Knobs (engine-native time units):

    * ``mttf`` — mean time to failure: episode gaps draw
      ``Exp(mttf)`` from ``seed`` (required, > 0).
    * ``mttr`` — mean time to repair; the blast group recovers after
      ``Exp(mttr)`` and re-enters dispatch cold.  Omitted/None makes
      failures permanent.
    * ``blast`` — blast radius: each episode kills ``blast``
      consecutive servers (correlated failure; default 1).
    * ``episodes`` — number of failure episodes (default 1).
    * ``seed`` — RNG seed for the schedule (default 0).
    * ``first`` — pins the first episode's failure time exactly
      (later episodes still draw from the RNG).
    """

    name: str = "faults"
    args: tuple = ()

    _KNOWN = ("mttf", "mttr", "blast", "episodes", "seed", "first")

    def __post_init__(self):
        super().__post_init__()
        if self.name != "faults":
            raise ValueError(f"FaultSpec name must be 'faults', "
                             f"got {self.name!r}")
        for k, _ in self.args:
            if k not in self._KNOWN:
                raise ValueError(f"unknown faults knob {k!r}; expected "
                                 f"one of {self._KNOWN}")
        if self.mttf is None or self.mttf <= 0:
            raise ValueError("faults mttf is required and must be > 0")
        if self.mttr is not None and self.mttr <= 0:
            raise ValueError("faults mttr must be > 0 (omit for "
                             "permanent failure)")
        if self.blast < 1:
            raise ValueError("faults blast must be >= 1")
        if self.episodes < 1:
            raise ValueError("faults episodes must be >= 1")

    @property
    def mttf(self):
        return self.kwargs.get("mttf")

    @property
    def mttr(self):
        return self.kwargs.get("mttr")

    @property
    def blast(self) -> int:
        return self.kwargs.get("blast", 1)

    @property
    def episodes(self) -> int:
        return self.kwargs.get("episodes", 1)

    @property
    def seed(self) -> int:
        return self.kwargs.get("seed", 0)

    @property
    def first(self):
        return self.kwargs.get("first")


@dataclasses.dataclass(frozen=True)
class RetrySpec(_SpecBase):
    """Request-level robustness: timeouts, retries, hedging, shedding
    (docs/CLUSTER.md "Chaos and graceful degradation").

    Runtime lives in :class:`~repro_torch.core.chaos.RetryWatchdog`.  Knobs
    (engine-native time units; at least one of ``timeout`` / ``hedge``
    / ``shed`` must be set):

    * ``timeout`` — per-dispatch deadline; an expiry evicts the
      request and retries it through normal dispatch.
    * ``retries`` (alias ``budget``) — retry budget: after this many
      timeouts the next expiry sheds the request (default 1).
    * ``backoff`` / ``factor`` — exponential backoff: retry ``k``
      waits ``backoff * factor^(k-1)`` before re-dispatch (default
      0 == immediate, factor 2.0).
    * ``hedge`` — straggler relocation: a request still running at
      ``hedge x`` its routing ETA is re-dispatched once (cancel-and-
      relocate, not duplicate), without burning retry budget.
    * ``shed`` — admission watermark: a fresh arrival is dropped
      (``shed`` event, excluded from completion percentiles) when
      outstanding work per active lane is at or above it.
    """

    name: str = "retry"
    args: tuple = ()

    ALIASES = {"budget": "retries"}
    _KNOWN = ("timeout", "retries", "backoff", "factor", "hedge", "shed")

    def __post_init__(self):
        super().__post_init__()
        if self.name != "retry":
            raise ValueError(f"RetrySpec name must be 'retry', "
                             f"got {self.name!r}")
        for k, _ in self.args:
            if k not in self._KNOWN:
                raise ValueError(f"unknown retry knob {k!r}; expected "
                                 f"one of {self._KNOWN}")
        if (self.timeout is None and self.hedge is None
                and self.shed is None):
            raise ValueError("retry spec needs at least one of "
                             "timeout / hedge / shed")
        if self.timeout is not None and self.timeout <= 0:
            raise ValueError("retry timeout must be > 0")
        if self.retries < 0:
            raise ValueError("retry retries must be >= 0")
        if self.backoff < 0:
            raise ValueError("retry backoff must be >= 0")
        if self.factor <= 0:
            raise ValueError("retry factor must be > 0")
        if self.hedge is not None and self.hedge <= 0:
            raise ValueError("retry hedge must be > 0")
        if self.shed is not None and self.shed <= 0:
            raise ValueError("retry shed must be > 0")

    @property
    def timeout(self):
        return self.kwargs.get("timeout")

    @property
    def retries(self) -> int:
        return self.kwargs.get("retries", 1)

    @property
    def backoff(self):
        return self.kwargs.get("backoff", 0)

    @property
    def factor(self) -> float:
        return self.kwargs.get("factor", 2.0)

    @property
    def hedge(self):
        return self.kwargs.get("hedge")

    @property
    def shed(self):
        return self.kwargs.get("shed")


# ---------------------------------------------------------------------------
# Server / workload / experiment specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """One server's shape: parallelism + scheduler (+ tick cache shape).

    ``cores`` is the server's parallelism in every engine (DES cores ==
    tick decode lanes).  ``slots`` (resident cache slots, default
    ``16 * cores``) and ``max_len`` (per-slot cache capacity) are
    tick-engine notions; the DES ignores them.

    The spec has a terse one-line string form
    (``"cores=6;scheduler=sfs:O=3;slots=96"``, non-default fields only)
    with ``parse(str(spec)) == spec``.
    """

    cores: int = 4
    scheduler: SchedulerSpec = SchedulerSpec("sfs")
    slots: Optional[int] = None
    max_len: Optional[int] = None

    def __post_init__(self):
        if not isinstance(self.scheduler, SchedulerSpec):
            object.__setattr__(self, "scheduler",
                               SchedulerSpec.parse(self.scheduler))

    # -- string grammar (";"-separated so scheduler specs nest) ---------
    def __str__(self) -> str:
        parts = [f"cores={self.cores}"]
        if self.scheduler != SchedulerSpec("sfs"):
            parts.append(f"scheduler={self.scheduler}")
        if self.slots is not None:
            parts.append(f"slots={self.slots}")
        if self.max_len is not None:
            parts.append(f"max_len={self.max_len}")
        return ";".join(parts)

    @classmethod
    def parse(cls, spec) -> "ServerSpec":
        """``"cores=6;scheduler=sfs:O=3;slots=96"`` -> spec (the
        converse of ``str``; unknown fields raise)."""
        if isinstance(spec, cls):
            return spec
        kw: dict = {}
        for part in str(spec).split(";"):
            part = part.strip()
            if not part:
                continue
            k, eq, v = part.partition("=")
            if not eq:
                raise ValueError(f"malformed server field {part!r} in "
                                 f"{spec!r} (expected key=value)")
            k, v = k.strip(), v.strip()
            if k == "scheduler":
                kw[k] = SchedulerSpec.parse(v)
            elif k in ("cores", "slots", "max_len"):
                kw[k] = int(v)
            else:
                raise ValueError(f"unknown server field {k!r}; expected "
                                 "cores/scheduler/slots/max_len")
        return cls(**kw)

    # -- converters (spec <-> SimConfig / EngineConfig) ------------------
    def to_sim_config(self):
        """DES :class:`~repro_torch.core.simulator.SimConfig` for this
        server."""
        from repro_torch.core.simulator import SimConfig
        if self.scheduler.name not in DES_POLICIES:
            raise ValueError(
                f"scheduler {self.scheduler.name!r} is not a DES policy; "
                f"expected one of {DES_POLICIES}")
        kw = {}
        for k, v in self.scheduler.args:
            if k not in DES_SCHED_FIELDS:
                raise ValueError(f"unknown scheduler knob {k!r} for the "
                                 f"DES engine; expected one of "
                                 f"{tuple(DES_SCHED_FIELDS)}")
            kw[DES_SCHED_FIELDS[k]] = v
        return SimConfig(cores=self.cores, policy=self.scheduler.name, **kw)

    def to_engine_config(self):
        """This package's :class:`~repro_torch.serving.engine.EngineConfig`
        for this server (lazy import)."""
        from repro_torch.serving.engine import EngineConfig
        SCHEDULER_REGISTRY.get(self.scheduler.name)   # validate early
        kw = {}
        for k, v in self.scheduler.args:
            if k not in TICK_SCHED_FIELDS:
                raise ValueError(f"unknown scheduler knob {k!r} for the "
                                 f"tick engine; expected one of "
                                 f"{tuple(TICK_SCHED_FIELDS)}")
            kw[TICK_SCHED_FIELDS[k]] = v
        extra = ({} if self.max_len is None
                 else {"max_len": self.max_len})
        return EngineConfig(lanes=self.cores,
                            n_slots=(self.slots if self.slots is not None
                                     else 16 * self.cores),
                            policy=self.scheduler.name, sched_kw=kw,
                            **extra)

    @classmethod
    def from_sim_config(cls, cfg) -> "ServerSpec":
        """Lossless converse of :meth:`to_sim_config` (non-default
        fields only, so specs stay terse)."""
        from repro_torch.core.simulator import SimConfig
        base = SimConfig()
        args = tuple((canon, getattr(cfg, field))
                     for canon, field in DES_SCHED_FIELDS.items()
                     if getattr(cfg, field) != getattr(base, field))
        return cls(cores=cfg.cores,
                   scheduler=SchedulerSpec(cfg.policy, args))

    @classmethod
    def from_engine_config(cls, ecfg) -> "ServerSpec":
        """Lossless converse of :meth:`to_engine_config`."""
        inv = {v: k for k, v in TICK_SCHED_FIELDS.items()}
        args = []
        for k, v in ecfg.sched_kw.items():
            if k not in inv:
                raise ValueError(f"sched_kw {k!r} has no canonical spec "
                                 "knob")
            args.append((inv[k], v))
        return cls(cores=ecfg.lanes, scheduler=SchedulerSpec(
            ecfg.policy, tuple(args)), slots=ecfg.n_slots,
            max_len=ecfg.max_len)


@dataclasses.dataclass(frozen=True)
class TickWorkloadSpec:
    """Declarative bimodal open-loop workload for the tick engine.

    The same stream every tick benchmark used to hand-roll: ``short_frac``
    of requests draw a short decode demand, the rest a long one; IATs are
    exponential, normalized so offered load over ``total_lanes`` (the
    whole cluster's lanes, supplied at generation time) equals ``load``.
    ``hints`` attaches the front-end ``eta_hint`` (max-tokens cap).
    """

    n: int = 1000
    load: float = 0.8
    seed: int = 7
    short_frac: float = 0.8
    short_range: tuple = (2, 8)
    long_range: tuple = (30, 80)
    prompt_len: int = 4
    hints: bool = True

    def generate(self, total_lanes: int) -> list:
        from repro_torch.serving.request import Request
        rng = np.random.default_rng(self.seed)
        svc = np.where(rng.random(self.n) < self.short_frac,
                       rng.integers(*self.short_range, self.n),
                       rng.integers(*self.long_range, self.n))
        span = svc.sum() / (self.load * total_lanes)
        iats = rng.exponential(1.0, self.n)
        arr = np.cumsum(iats * span / iats.sum()).astype(int)
        return [Request(rid=i, arrival=int(arr[i]),
                        prompt_len=self.prompt_len, n_tokens=int(svc[i]),
                        eta_hint=int(svc[i]) + 1 if self.hints else None)
                for i in range(self.n)]


@dataclasses.dataclass(frozen=True)
class WorkloadStageSpec(_SpecBase):
    """One stage of a staged workload in the ``name:k=v`` grammar.

    ``name`` looks up :data:`WORKLOAD_REGISTRY`
    (``repro_torch.core.workload``): the first stage of a
    :class:`WorkloadSpec` must be a *generator* (``generate(total_lanes)
    -> [Request]``, e.g. ``bimodal``); later stages must be
    *transforms* (``apply(reqs, total_lanes) -> [Request]``, e.g.
    ``zipf`` / ``drift`` / ``flash`` / ``diurnal``).
    """

    name: str = "bimodal"
    args: tuple = ()

    def build(self):
        return WORKLOAD_REGISTRY.get(self.name)(**self.kwargs)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Staged tick workload: a generator piped through transforms.

    The pipe-combinator grammar composes registered stages serially —
    ``"bimodal:n=800|zipf:funcs=16|flash:at=600,x=4"`` draws the
    bimodal stream, assigns Zipf function popularity, then compresses a
    flash crowd into ``[600, 700)``.  ``parse(str(spec)) == spec``
    holds like every other spec (``tests/test_lifecycle.py``).
    """

    stages: tuple = (WorkloadStageSpec("bimodal"),)

    def __post_init__(self):
        stages = tuple(s if isinstance(s, WorkloadStageSpec)
                       else WorkloadStageSpec.parse(s)
                       for s in self.stages)
        if not stages:
            raise ValueError("WorkloadSpec needs at least one stage")
        object.__setattr__(self, "stages", stages)

    def __str__(self) -> str:
        return "|".join(str(s) for s in self.stages)

    @classmethod
    def parse(cls, spec) -> "WorkloadSpec":
        if isinstance(spec, cls):
            return spec
        return cls(stages=tuple(str(spec).split("|")))

    def generate(self, total_lanes: int) -> list:
        head = self.stages[0].build()
        if not hasattr(head, "generate"):
            raise ValueError(
                f"workload stage {self.stages[0].name!r} is a transform; "
                "the first stage of a WorkloadSpec must be a generator")
        reqs = head.generate(total_lanes)
        for st in self.stages[1:]:
            stage = st.build()
            if not hasattr(stage, "apply"):
                raise ValueError(
                    f"workload stage {st.name!r} is a generator; stages "
                    "after the first must be transforms")
            reqs = stage.apply(reqs, total_lanes)
        return reqs


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """A complete experiment: workload + engine + per-server shapes +
    dispatch + predictor.

    ``servers`` is a per-server list — mixed cores/lanes/slots/policies
    form one group per shape.  ``workload`` is a
    :class:`~repro_torch.core.workload.FaaSBenchConfig` (DES), a
    :class:`TickWorkloadSpec` or staged :class:`WorkloadSpec` (tick
    family; a ``"gen|stage|..."`` pipe string parses to the latter), or
    None when requests are passed to :func:`run_experiment` directly.
    ``dispatch_latency`` is the DES router->server delay in seconds (the
    tick family has no latency model; it must stay 0 there).
    ``lifecycle`` / ``scaling`` opt the fleet into cold starts,
    failure/drain and autoscaling; ``faults`` / ``retry`` into correlated
    failure episodes with recovery and request
    timeouts/retries/hedging/shedding (:mod:`repro_torch.core.chaos`).

    ``engine="des"`` runs the discrete-event simulator
    (:class:`~repro_torch.core.simulator.ClusterSimulator`), bit-exact
    with the JAX package's ``engine="des"``.
    ``engine="torch"`` (the default) runs tick semantics through
    :class:`~repro_torch.serving.torch_cluster.TorchCluster`, the
    counterpart of the JAX package's ``engine="jax"``, bit for bit.
    ``engine="tick"`` runs per-object engines
    (:class:`~repro_torch.serving.cluster.Cluster`) and ``engine="vector"``
    the struct-of-arrays groups
    (:class:`~repro_torch.serving.vector_cluster.VectorCluster`), both on
    the host.  ``vector`` is bit-exact with ``torch``.  ``tick`` is
    bit-exact with both except after a failed server recovers: its
    eviction builds a fresh scheduler, while ``vector`` and ``torch``
    keep the server's adaptive slice, arrival window and
    ``min_vruntime``, as the JAX package's backends do.
    """

    engine: str = "torch"
    servers: tuple = (ServerSpec(), ServerSpec(), ServerSpec(),
                      ServerSpec())
    dispatch: DispatchSpec = DispatchSpec("hash")
    predictor: object = PredictorSpec("oracle")
    workload: object = None
    dispatch_latency: float = 0.0
    lifecycle: object = None                 # None | LifecycleSpec | str
    scaling: object = None                   # None | ScalingSpec | str
    faults: object = None                    # None | FaultSpec | str
    retry: object = None                     # None | RetrySpec | str

    def __post_init__(self):
        if self.engine in NOT_PORTED:
            raise ValueError(f"engine {self.engine!r} is not ported to "
                             "repro_torch; use engine='torch' (the fleet "
                             "backend, equal to the JAX package's 'jax')")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             "expected 'torch', 'des', 'tick' or 'vector'")
        servers = tuple(ServerSpec.parse(s) if isinstance(s, str) else s
                        for s in self.servers)
        if not servers:
            raise ValueError("ExperimentSpec needs at least one server")
        for s in servers:
            if not isinstance(s, ServerSpec):
                raise TypeError(f"servers must be ServerSpec, got {s!r}")
        object.__setattr__(self, "servers", servers)
        if not isinstance(self.dispatch, DispatchSpec):
            object.__setattr__(self, "dispatch",
                               DispatchSpec.parse(self.dispatch))
        if isinstance(self.predictor, (str, PredictorSpec)):
            object.__setattr__(self, "predictor",
                               PredictorSpec.parse(self.predictor))
        if isinstance(self.workload, str):
            object.__setattr__(self, "workload",
                               WorkloadSpec.parse(self.workload))
        if isinstance(self.lifecycle, str):
            object.__setattr__(self, "lifecycle",
                               LifecycleSpec.parse(self.lifecycle))
        if self.lifecycle is not None \
                and not isinstance(self.lifecycle, LifecycleSpec):
            raise TypeError(f"lifecycle must be a LifecycleSpec or its "
                            f"string form, got {self.lifecycle!r}")
        if isinstance(self.scaling, str):
            object.__setattr__(self, "scaling",
                               ScalingSpec.parse(self.scaling))
        if self.scaling is not None \
                and not isinstance(self.scaling, ScalingSpec):
            raise TypeError(f"scaling must be a ScalingSpec or its "
                            f"string form, got {self.scaling!r}")
        if isinstance(self.faults, str):
            object.__setattr__(self, "faults", FaultSpec.parse(self.faults))
        if self.faults is not None \
                and not isinstance(self.faults, FaultSpec):
            raise TypeError(f"faults must be a FaultSpec or its "
                            f"string form, got {self.faults!r}")
        if isinstance(self.retry, str):
            object.__setattr__(self, "retry", RetrySpec.parse(self.retry))
        if self.retry is not None \
                and not isinstance(self.retry, RetrySpec):
            raise TypeError(f"retry must be a RetrySpec or its "
                            f"string form, got {self.retry!r}")
        if self.faults is not None and self.faults.blast > len(servers):
            raise ValueError(
                f"faults blast={self.faults.blast} exceeds the fleet "
                f"size {len(servers)}")
        if self.lifecycle is not None:
            fs = self.lifecycle.fail_server
            if not 0 <= fs < len(servers):
                raise ValueError(
                    f"lifecycle fail_server={fs} out of range for "
                    f"{len(servers)} servers")
        if self.scaling is not None:
            if self.scaling.min_servers > len(servers):
                raise ValueError(
                    f"scaling min={self.scaling.min_servers} exceeds the "
                    f"fleet size {len(servers)}")
            mx = self.scaling.max_servers
            if mx is not None and mx < self.scaling.min_servers:
                raise ValueError("scaling max must be >= min")
        if self.engine != "des" and self.dispatch_latency:
            raise ValueError("dispatch_latency is DES-only (the tick "
                             "engine has no network-delay model)")

    @property
    def total_cores(self) -> int:
        return sum(s.cores for s in self.servers)

    # -- provenance (JSON round-trip) -----------------------------------
    def to_json(self) -> dict:
        """JSON-safe provenance dict stamped into benchmark artifacts;
        :meth:`from_json` rebuilds an equal spec (asserted in tests).
        Servers/dispatch/predictor travel through their canonical string
        grammar; a non-spec predictor instance degrades to its name
        (best-effort provenance, not rebuildable)."""
        pred = (str(self.predictor)
                if isinstance(self.predictor, PredictorSpec)
                else getattr(self.predictor, "name", repr(self.predictor)))
        d = {"engine": self.engine,
             "servers": [str(s) for s in self.servers],
             "dispatch": str(self.dispatch),
             "predictor": pred,
             "dispatch_latency": self.dispatch_latency,
             "lifecycle": (None if self.lifecycle is None
                           else str(self.lifecycle)),
             "scaling": (None if self.scaling is None
                         else str(self.scaling)),
             "faults": (None if self.faults is None
                        else str(self.faults)),
             "retry": (None if self.retry is None
                       else str(self.retry)),
             "workload": None}
        wl = self.workload
        if isinstance(wl, WorkloadSpec):
            d["workload"] = {"kind": "staged", "spec": str(wl)}
        elif isinstance(wl, TickWorkloadSpec):
            d["workload"] = {"kind": "tick", **dataclasses.asdict(wl)}
        elif wl is not None:
            from repro_torch.core.workload import FaaSBenchConfig
            if isinstance(wl, FaaSBenchConfig):
                d["workload"] = {"kind": "faas", **dataclasses.asdict(wl)}
            else:
                d["workload"] = {"kind": "opaque", "repr": repr(wl)}
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ExperimentSpec":
        """Rebuild a spec from :meth:`to_json` output (tuple-typed
        workload fields come back as JSON lists and are re-tupled)."""
        wl = d.get("workload")
        workload = None
        if wl is not None:
            kind = wl.get("kind")
            body = {k: v for k, v in wl.items() if k != "kind"}
            if kind == "staged":
                workload = WorkloadSpec.parse(body["spec"])
            elif kind == "tick":
                for k in ("short_range", "long_range"):
                    body[k] = tuple(body[k])
                workload = TickWorkloadSpec(**body)
            elif kind == "faas":
                from repro_torch.core.workload import FaaSBenchConfig
                body["duration_table"] = tuple(
                    tuple(row) for row in body["duration_table"])
                body["io_ms_range"] = tuple(body["io_ms_range"])
                workload = FaaSBenchConfig(**body)
            else:
                raise ValueError(
                    f"cannot rebuild workload of kind {kind!r}")
        return cls(engine=d["engine"], servers=tuple(d["servers"]),
                   dispatch=d["dispatch"], predictor=d["predictor"],
                   workload=workload,
                   dispatch_latency=d.get("dispatch_latency", 0.0),
                   lifecycle=d.get("lifecycle"), scaling=d.get("scaling"),
                   faults=d.get("faults"), retry=d.get("retry"))

    # -- converters -----------------------------------------------------
    def to_cluster_sim_config(self):
        from repro_torch.core.simulator import ClusterSimConfig
        return ClusterSimConfig(
            n_servers=len(self.servers),
            servers=[s.to_sim_config() for s in self.servers],
            dispatch=self.dispatch, predictor=self.predictor,
            dispatch_latency_s=self.dispatch_latency,
            lifecycle=self.lifecycle, scaling=self.scaling,
            faults=self.faults, retry=self.retry)

    def to_cluster_config(self):
        from repro_torch.serving.cluster import ClusterConfig
        return ClusterConfig(policy=self.dispatch,
                             predictor=self.predictor,
                             lifecycle=self.lifecycle,
                             scaling=self.scaling,
                             faults=self.faults,
                             retry=self.retry)


# ---------------------------------------------------------------------------
# Unified result schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExperimentResult:
    """One result schema for every benchmark, whichever engine ran.

    Per-request arrays are rid-ordered; ``unit`` is ``"s"`` (DES) or
    ``"t"`` (ticks).  ``raw`` keeps the engine-native result
    (:class:`~repro_torch.core.simulator.ClusterSimResult` or the finished
    serving requests) for anything schema-shaped access can't answer.
    """

    spec: ExperimentSpec
    engine: str
    unit: str
    rids: np.ndarray
    service: np.ndarray
    turnaround: np.ndarray
    rte: np.ndarray
    finish: np.ndarray
    n_ctx: np.ndarray
    demoted: np.ndarray
    policy: str
    predictor: str
    dispatch_counts: list
    overload_bypasses: int
    eta_log: dict
    dispatch_S: Optional[float]
    wall_s: float
    raw: object
    # the repro_torch.core.telemetry.Telemetry session attached via
    # run_experiment(telemetry=...); None when telemetry was off
    telemetry: object = None
    # chaos accounting (docs/CLUSTER.md): shed requests never finish,
    # so they are excluded from every per-request array above and
    # reported here as their own metric — P99 claims stay honest
    shed: int = 0
    timeouts: int = 0
    retries: int = 0

    @property
    def n(self) -> int:
        return len(self.rids)

    def buckets(self, edges: Optional[Sequence[float]] = None,
                ps=(50, 99)) -> dict:
        """Per-service-bucket turnaround percentiles + mean RTE
        (``repro_torch.core.metrics.bucket_stats`` under unit-matched
        edges)."""
        from repro_torch.core.metrics import (DEFAULT_BUCKET_EDGES_S,
                                        DEFAULT_BUCKET_EDGES_T,
                                        bucket_stats)
        if edges is None:
            edges = (DEFAULT_BUCKET_EDGES_S if self.unit == "s"
                     else DEFAULT_BUCKET_EDGES_T)
        return bucket_stats(self.service, self.turnaround, self.rte,
                            edges=edges, ps=ps, unit=self.unit)

    def fingerprint(self) -> str:
        """SHA-256 of the (rid, finish, n_ctx, demoted) stream — the
        bit-exactness currency of the golden tests."""
        blob = repr([(int(r), f, int(c), bool(d))
                     for r, f, c, d in zip(self.rids, self.finish.tolist(),
                                           self.n_ctx, self.demoted)
                     ]).encode()
        return hashlib.sha256(blob).hexdigest()

    def summary(self) -> dict:
        return {
            "engine": self.engine, "policy": self.policy,
            "predictor": self.predictor, "n": self.n,
            "servers": len(self.spec.servers),
            "dispatch_counts": list(self.dispatch_counts),
            "overload_bypasses": self.overload_bypasses,
            "wall_s": self.wall_s,
            "shed": self.shed, "timeouts": self.timeouts,
            "retries": self.retries,
        }


# ---------------------------------------------------------------------------
# The single entry point
# ---------------------------------------------------------------------------


def run_experiment(spec: ExperimentSpec, requests=None, *,
                   max_ticks: int = 20_000_000,
                   telemetry=None, device="cuda") -> ExperimentResult:
    """Run one :class:`ExperimentSpec` end to end on ``device``.

    ``requests`` overrides the spec's declarative workload with an
    explicit request list (core requests for ``des``, serving requests
    for the tick family).  Deterministic given the spec/workload, on
    either device.  ``device`` is the CUDA card unless the caller asks
    for ``"cpu"``; without a card the default raises.  The ``des``,
    ``tick`` and ``vector`` backends step on the host; ``des`` places
    nothing on ``device`` but resolves it all the same, and the tick
    backends build their engines there.

    ``telemetry`` opts into the observability layer
    (:mod:`repro_torch.core.telemetry`): a ``Telemetry`` /
    ``TelemetryConfig`` instance, or ``True`` for lifecycle tracing only.
    It never changes results; the session comes back on
    ``ExperimentResult.telemetry``.
    """
    spec = spec if isinstance(spec, ExperimentSpec) else ExperimentSpec(
        **spec)
    tel = None
    if telemetry is not None and telemetry is not False:
        from repro_torch.core.telemetry import Telemetry
        tel = Telemetry.ensure(telemetry)
    t0 = time.perf_counter()
    if spec.engine == "des":
        from repro_torch.device import resolve_device
        resolve_device(device)
        return _run_des(spec, requests, t0, tel)
    return _run_tick(spec, requests, t0, max_ticks, tel, device)


def _chaos_counts(owner) -> dict:
    """ExperimentResult chaos fields from an engine's counters."""
    cc = getattr(owner, "chaos_counts", None) or {}
    return {"shed": cc.get("shed", 0), "timeouts": cc.get("timeout", 0),
            "retries": cc.get("retry", 0)}


def _build_tick_cluster(spec: ExperimentSpec, device):
    """Stepping backend for a tick-semantics experiment: the
    struct-of-arrays ``VectorCluster`` (``engine="vector"``), the fleet
    stepping ``TorchCluster`` on ``device`` (``engine="torch"``), or the
    per-object ``Cluster`` (``engine="tick"``).  All three are bit-exact
    with each other, except that ``tick`` schedules differently after a
    failed server recovers (see :class:`ExperimentSpec`)."""
    if spec.engine == "vector":
        from repro_torch.serving.vector_cluster import VectorCluster
        return VectorCluster(spec.servers, spec.to_cluster_config(),
                             device=device)
    if spec.engine == "torch":
        from repro_torch.serving.torch_cluster import TorchCluster
        return TorchCluster(spec.servers, spec.to_cluster_config(),
                            device=device)
    from repro_torch.serving.cluster import Cluster
    from repro_torch.serving.engine import Engine
    engines = [Engine(s.to_engine_config(), device=device)
               for s in spec.servers]
    return Cluster(engines, spec.to_cluster_config())


def _run_des(spec: ExperimentSpec, requests, t0: float,
             tel=None) -> ExperimentResult:
    from repro_torch.core.simulator import ClusterSimulator
    from repro_torch.core.workload import FaaSBenchConfig, generate
    if requests is None:
        if not isinstance(spec.workload, FaaSBenchConfig):
            raise ValueError(
                "DES experiment needs a FaaSBenchConfig workload (or an "
                f"explicit request list); got {spec.workload!r}")
        requests = generate(spec.workload)
    sim = ClusterSimulator(requests, spec.to_cluster_sim_config())
    if tel is not None:
        sim.attach_telemetry(tel)
    res = sim.run()
    st = res.merged.stats
    return ExperimentResult(
        spec=spec, engine="des", unit="s",
        rids=np.array([s.rid for s in st]),
        service=np.array([s.service for s in st]),
        turnaround=np.array([s.turnaround for s in st]),
        rte=np.array([s.rte for s in st]),
        finish=np.array([s.finish for s in st]),
        n_ctx=np.array([s.n_ctx for s in st]),
        demoted=np.array([s.demoted for s in st]),
        policy=res.policy, predictor=res.predictor,
        dispatch_counts=list(res.dispatch_counts),
        overload_bypasses=res.overload_bypasses,
        eta_log=dict(res.eta_log), dispatch_S=res.dispatch_S,
        wall_s=time.perf_counter() - t0, raw=res, telemetry=tel,
        **_chaos_counts(sim))


def _run_tick(spec: ExperimentSpec, requests, t0: float,
              max_ticks: int, tel=None, device="cuda") -> ExperimentResult:
    if requests is None:
        if not isinstance(spec.workload, (TickWorkloadSpec, WorkloadSpec)):
            raise ValueError(
                "tick experiment needs a TickWorkloadSpec or WorkloadSpec "
                f"workload (or an explicit request list); got "
                f"{spec.workload!r}")
        requests = spec.workload.generate(spec.total_cores)
    cluster = _build_tick_cluster(spec, device)
    if tel is not None:
        cluster.attach_telemetry(tel)
    done = cluster.run(requests, max_ticks=max_ticks)
    return ExperimentResult(
        spec=spec, engine=spec.engine, unit="t",
        rids=np.array([r.rid for r in done]),
        service=np.array([r.service_demand for r in done],
                         dtype=np.float64),
        turnaround=np.array([r.turnaround for r in done],
                            dtype=np.float64),
        rte=np.array([r.rte for r in done], dtype=np.float64),
        finish=np.array([r.finish for r in done]),
        n_ctx=np.array([r.n_ctx for r in done]),
        demoted=np.array([r.demoted for r in done]),
        policy=cluster.policy.name, predictor=cluster.predictor.name,
        dispatch_counts=list(cluster.dispatch_counts),
        overload_bypasses=cluster.summary()["overload_bypasses"],
        eta_log=dict(cluster.eta_log),
        dispatch_S=getattr(cluster.policy, "S", None),
        wall_s=time.perf_counter() - t0, raw=done, telemetry=tel,
        **_chaos_counts(cluster))
