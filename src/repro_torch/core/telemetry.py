"""Cross-engine scheduling telemetry: lifecycle traces, fleet
time-series, and host-path profiling (docs/OBSERVABILITY.md).

A copy of ``repro.core.telemetry`` (the JAX package's module); the
port's fleet backend (``serving/torch_cluster.py``) emits the same
events, and its profile phases are named ``torch_step``,
``torch_events``, ``torch_scan`` ….

The four execution backends (DES ``simulator.py``, object tick
``serving/cluster.py``, numpy ``serving/vector_cluster.py``, jitted
``serving/jax_cluster.py``) emit the *same* typed per-request lifecycle
events into a :class:`TraceRecorder`, which makes equal-trace agreement
a correctness tool strictly stronger than end-state fingerprints
(``tests/test_agreement.py``) and gives every run a Perfetto-loadable
Chrome trace export.

Everything here is strictly opt-in: engines hold ``trace = None`` /
``prof = None`` defaults and every emission site is guarded with a
single ``is not None`` check, so the disabled path adds no allocations
to the hot loops (pinned by ``tests/test_telemetry.py``).

Attach at run time, never through the frozen spec grammar::

    tel = Telemetry(trace=True, series_cadence=50, profile=True)
    res = run_experiment(spec, telemetry=tel)
    res.telemetry.trace.canonical()     # cross-backend comparable
    res.telemetry.summary()             # counters + phase breakdown
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Optional

# ---------------------------------------------------------------------------
# Lifecycle event vocabulary
# ---------------------------------------------------------------------------

#: Canonical event kinds, in within-timestamp ordering.  ``arrival``,
#: ``dispatch`` and the fleet-lifecycle kinds ``cold_start`` (aux =
#: penalty charged), ``fail`` / ``scale`` / ``recover`` (rid = -1;
#: ``scale`` aux = +1 activate / -1 drain) and ``requeue`` (failed
#: server's in-flight work re-entering dispatch) are emitted by the
#: cluster frontend (shared code), as are the chaos kinds ``shed``
#: (arrival dropped at admission or on budget exhaustion), ``retry``
#: (timed-out/hedged request re-entering dispatch) and ``timeout``
#: (per-dispatch deadline expired); ``admit``/``bypass``/``demote``/
#: ``preempt``/``complete`` by the per-server scheduling backends.
#: See docs/OBSERVABILITY.md for the exact semantics of each kind per
#: backend.
KINDS = ("arrival", "shed", "retry", "dispatch", "cold_start", "admit",
         "bypass", "demote", "preempt", "timeout", "fail", "requeue",
         "recover", "scale", "complete")
KIND_ORDER = {k: i for i, k in enumerate(KINDS)}


class TraceRecorder:
    """Append-only recorder of ``(t, kind, rid, server, aux)`` events.

    ``aux`` carries the predictor ETA on ``dispatch`` events (None when
    the predictor abstained), the charged penalty on ``cold_start``,
    the +1/-1 direction on ``scale``, and is None elsewhere.  Fleet
    events (``fail``/``scale``) use ``rid = -1``.  Within one backend
    a tick's events may be appended in backend-specific order;
    :meth:`canonical` sorts by ``(t, kind-rank, rid, server)``, under
    which ``(t, rid, kind)`` is unique, so canonical traces from
    different backends compare order-insensitively.
    """

    __slots__ = ("events",)

    def __init__(self):
        self.events: list = []

    def __len__(self) -> int:
        return len(self.events)

    # -- emission ------------------------------------------------------------

    def emit(self, t, kind: str, rid: int, server: int = -1, aux=None):
        self.events.append((t, kind, int(rid), int(server), aux))

    def emit_rows(self, t, kind: str, rid_server_pairs):
        """Batch emission for the array backends: an iterable of
        ``(rid, server)`` pairs sharing one timestamp and kind."""
        ev = self.events
        for rid, server in rid_server_pairs:
            ev.append((t, kind, int(rid), int(server), None))

    # -- views ---------------------------------------------------------------

    def canonical(self) -> list:
        """Events sorted into the cross-backend canonical order."""
        ko = KIND_ORDER
        return sorted(self.events,
                      key=lambda e: (e[0], ko[e[1]], e[2], e[3]))

    def by_rid(self, rid: int) -> list:
        return [e for e in self.canonical() if e[2] == rid]

    def counts(self) -> dict:
        out = dict.fromkeys(KINDS, 0)
        for e in self.events:
            out[e[1]] += 1
        return out

    def digest(self) -> str:
        """SHA-256 over the canonical event stream (aux rounded so float
        ETAs hash stably)."""
        canon = [(e[0], e[1], e[2], e[3],
                  None if e[4] is None else round(float(e[4]), 9))
                 for e in self.canonical()]
        return hashlib.sha256(repr(canon).encode()).hexdigest()

    # -- export --------------------------------------------------------------

    def chrome_events(self, pid: int = 0, label: str = "run",
                      scale: float = 1.0) -> list:
        """Chrome-trace (Perfetto-loadable) event dicts for this trace.

        One process per recorder (``pid``/``label``), one thread per
        server.  Request lifetimes (dispatch -> complete) render as "X"
        duration events; admit/bypass/demote/preempt as thread-scoped
        instants.  ``scale`` converts engine time units to microseconds
        (ticks map 1:1 by default — Perfetto only needs monotone time).
        """
        disp, comp, servers = {}, {}, set()
        out = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": label}}]
        for t, kind, rid, server, aux in self.canonical():
            if kind == "dispatch":
                disp[rid] = (t, server, aux)
            elif kind == "complete":
                comp[rid] = (t, server)
            if server >= 0:
                servers.add(server)
            if kind in ("admit", "bypass", "demote", "preempt",
                        "cold_start", "fail", "requeue", "scale",
                        "shed", "retry", "timeout", "recover"):
                out.append({"name": kind, "ph": "i", "s": "t",
                            "ts": t * scale, "pid": pid, "tid": server,
                            "args": {"rid": rid}})
        for rid, (t1, server) in comp.items():
            t0, dserver, eta = disp.get(rid, (t1, server, None))
            out.append({"name": f"r{rid}", "ph": "X", "ts": t0 * scale,
                        "dur": max(t1 - t0, 0) * scale, "pid": pid,
                        "tid": server,
                        "args": {"rid": rid, "eta": eta,
                                 "routed_to": dserver}})
        for s in sorted(servers):
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": s, "args": {"name": f"server {s}"}})
        return out


def save_chrome_trace(path: str, named_traces: dict,
                      scale: float = 1.0) -> str:
    """Write one Chrome-trace JSON merging several recorders — each
    ``{label: TraceRecorder}`` entry becomes its own process row, so
    e.g. an sfs-aware run and a hash run sit side by side in Perfetto.
    """
    events = []
    for pid, (label, tr) in enumerate(named_traces.items()):
        events += tr.chrome_events(pid=pid, label=label, scale=scale)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  default=float)
    return path


# ---------------------------------------------------------------------------
# Fleet time-series
# ---------------------------------------------------------------------------

#: Cluster-wide counters a FleetSeries snapshots at every sample.  The
#: ``*_done`` pair is derived at completion time (uniform across all
#: four backends — the jitted backend only surfaces per-event demotions
#: when tracing): ``demoted_done`` counts completions that ever left
#: FILTER, ``nctx_done`` sums their involuntary context switches.
COUNTER_KEYS = ("completions", "demoted_done", "nctx_done",
                "predictor_hits", "predictor_misses")


class FleetSeries:
    """Per-server gauges + cluster counters sampled every ``cadence``
    engine time units (ticks, or seconds for the DES)."""

    __slots__ = ("cadence", "samples", "counters")

    def __init__(self, cadence: int = 100):
        self.cadence = max(1, int(cadence))
        self.samples: list = []
        self.counters = dict.fromkeys(COUNTER_KEYS, 0)

    def sample(self, t, views, extra: Optional[dict] = None):
        """Snapshot the ServerView gauges of every server plus the
        running counters.  ``extra`` lets a backend add scalars (e.g.
        overload bypasses, which live on the dispatch policy)."""
        row = {
            "t": t,
            "queue_len": [v.queue_len() for v in views],
            "filter_active": [v.lanes - v.filter_free() for v in views],
            "fair_load": [v.fair_load() for v in views],
            "outstanding": [v.outstanding() for v in views],
            "counters": dict(self.counters),
        }
        if extra:
            row.update(extra)
        self.samples.append(row)

    def count(self, key: str, inc: int = 1):
        self.counters[key] += inc

    def summary(self) -> dict:
        if not self.samples:
            return {"n_samples": 0, "counters": dict(self.counters)}
        peak_q = max(sum(s["queue_len"]) for s in self.samples)
        peak_cfs = max(sum(s["fair_load"]) for s in self.samples)
        occ = [sum(s["filter_active"]) for s in self.samples]
        return {
            "n_samples": len(self.samples),
            "cadence": self.cadence,
            "peak_queue_len": peak_q,
            "peak_fair_load": peak_cfs,
            "mean_filter_active": sum(occ) / len(occ),
            "counters": dict(self.counters),
        }

    def to_dict(self) -> dict:
        return {"cadence": self.cadence, "samples": self.samples,
                "counters": dict(self.counters)}


# ---------------------------------------------------------------------------
# Host-path profiling
# ---------------------------------------------------------------------------


class HostProfile:
    """Wall-clock accumulator for named host-loop phases.

    Usage at a call site (guarded, so the disabled path costs one
    attribute read)::

        prof = self.prof
        t0 = time.perf_counter() if prof is not None else 0.0
        ...phase work...
        if prof is not None:
            prof.add("torch_step", time.perf_counter() - t0)

    Phase names are a flat namespace; docs/OBSERVABILITY.md carries the
    glossary (route, step, torch_step, torch_events, torch_scan, ...).
    """

    __slots__ = ("phases",)

    def __init__(self):
        self.phases: dict = {}          # name -> [total_s, count]

    def add(self, name: str, dt: float):
        slot = self.phases.get(name)
        if slot is None:
            self.phases[name] = [dt, 1]
        else:
            slot[0] += dt
            slot[1] += 1

    def timer(self):
        return time.perf_counter()

    def summary(self) -> dict:
        return {name: {"total_s": round(tot, 6), "calls": n,
                       "mean_us": round(tot / n * 1e6, 3) if n else 0.0}
                for name, (tot, n) in sorted(
                    self.phases.items(), key=lambda kv: -kv[1][0])}

    def format(self) -> str:
        total = sum(tot for tot, _ in self.phases.values()) or 1.0
        lines = [f"  {name:14s} {s['total_s']:9.3f}s "
                 f"{self.phases[name][0] / total * 100:5.1f}%  "
                 f"x{s['calls']:<9d} {s['mean_us']:10.1f}us/call"
                 for name, s in self.summary().items()]
        return "\n".join(lines) if lines else "  (no phases recorded)"


# ---------------------------------------------------------------------------
# Session object
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """What to collect.  Deliberately *not* part of ExperimentSpec: the
    spec describes the experiment (and must round-trip its string
    grammar); telemetry describes what this run records about it."""

    trace: bool = False
    series_cadence: Optional[int] = None    # None == disabled
    profile: bool = False


class Telemetry:
    """One run's telemetry session: holds the enabled collectors.

    Pass to ``run_experiment(spec, telemetry=...)``; the backend wires
    each collector into its hot loop only when enabled.  The same
    object comes back on ``ExperimentResult.telemetry``.
    """

    def __init__(self, config: Optional[TelemetryConfig] = None, *,
                 trace: bool = False, series_cadence: Optional[int] = None,
                 profile: bool = False):
        cfg = config or TelemetryConfig(trace=trace,
                                        series_cadence=series_cadence,
                                        profile=profile)
        self.config = cfg
        self.trace = TraceRecorder() if cfg.trace else None
        self.series = (FleetSeries(cfg.series_cadence)
                       if cfg.series_cadence else None)
        self.profile = HostProfile() if cfg.profile else None

    @classmethod
    def ensure(cls, obj) -> Optional["Telemetry"]:
        """Normalize what callers pass for ``telemetry=``: None stays
        None (fully disabled), a Telemetry passes through, a
        TelemetryConfig is instantiated, True means trace-only."""
        if obj is None or isinstance(obj, cls):
            return obj
        if isinstance(obj, TelemetryConfig):
            return cls(obj)
        if obj is True:
            return cls(trace=True)
        raise TypeError(f"telemetry must be None/True/TelemetryConfig/"
                        f"Telemetry, got {type(obj).__name__}")

    def summary(self) -> dict:
        out: dict = {}
        if self.trace is not None:
            out["trace"] = {"n_events": len(self.trace),
                            "counts": self.trace.counts(),
                            "digest": self.trace.digest()[:16]}
        if self.series is not None:
            out["series"] = self.series.summary()
        if self.profile is not None:
            out["profile"] = self.profile.summary()
        return out
