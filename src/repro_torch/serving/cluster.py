"""The cluster's dispatch frontend (level three).

The scheduling hierarchy:

  level 3  cluster dispatch   — which engine an invocation lands on
  level 2  FILTER lanes       — run-to-completion short lanes (paper §V)
  level 1  fair-share pool    — CFS for demoted/long work

A copy of ``ClusterConfig`` and ``ClusterFrontend`` from
``repro.serving.cluster`` (the JAX package's module): routing through a
policy from :mod:`repro_torch.core.dispatch` (``hash``,
``least-outstanding``, ``pull``, ``sfs-aware``), the central pull queue,
ETA-hint propagation, and the lifecycle/chaos decisions at the top of a
tick.  The stepping backend plugs in through the hooks below.  The JAX
package's per-object ``Cluster`` and its ``EngineView`` are not ported.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from time import perf_counter
from typing import Optional, Sequence

from repro_torch.core.chaos import FaultTimeline, RetryWatchdog
from repro_torch.core.dispatch import (DispatchPolicy, HashDispatch,
                                       PullDispatch, ServerView,
                                       make_dispatch, route_hinted)
from repro_torch.core.lifecycle import (Autoscaler, WarmSet,
                                        lifecycle_horizon)
from repro_torch.core.predict import make_predictor
from repro_torch.core.spec import (FaultSpec, LifecycleSpec, RetrySpec,
                                   ScalingSpec, resolve_dispatch)
from repro_torch.serving.request import Request


@dataclasses.dataclass
class ClusterConfig:
    # dispatch policy: a name ("hash" | "least-outstanding" | "pull" |
    # "sfs-aware"), a "name:key=val,..." spec string, or a
    # repro_torch.core.spec.DispatchSpec
    policy: object = "hash"
    # duration predictor feeding dispatch its ETA hints
    # (repro_torch.core.predict): "oracle" passes the front-end ``eta_hint``
    # through unchanged (legacy behaviour), "none" routes blind,
    # "history" / "class" learn online from finished requests.  Also
    # accepts an EtaPredictor instance, a PredictorSpec, or a
    # "name:key=val,..." spec.
    predictor: object = "oracle"
    # sfs-aware knobs (cluster-level O x S rule, units = engine ticks);
    # explicit args on a dispatch spec take precedence over these
    overload_factor: float = 3.0
    adaptive_window: int = 100
    slice_init: float = 32.0
    # fleet lifecycle (cold starts / keep-alive / failure) and
    # autoscaling: None, a LifecycleSpec/ScalingSpec, or its string form
    lifecycle: object = None
    scaling: object = None
    # chaos subsystem (core/chaos.py): correlated failure episodes with
    # recovery (FaultSpec) and request timeouts/retries/hedging/shedding
    # (RetrySpec); None, a spec, or its string form
    faults: object = None
    retry: object = None


class ClusterFrontend:
    """Level-3 dispatch frontend, independent of the stepping backend.

    Owns the dispatch policy, the predictor, the central (pull) queue
    and the per-tick routing semantics.  Backends (here the fleet
    backend, :class:`~repro_torch.serving.torch_cluster.TorchCluster`,
    which also owns the run loop) plug in through five hooks: ``_submit`` (deliver a routed request to server ``idx``),
    ``_step`` (advance every server one tick), ``_active_counts``
    (per-server running-request counts for the tick log),
    ``_finished_count`` and ``_collect`` (result extraction).
    """

    def __init__(self, views: Sequence[ServerView],
                 cfg: Optional[ClusterConfig] = None):
        self.cfg = cfg or ClusterConfig()
        self.views = list(views)
        self.n_servers = len(self.views)
        self.policy: DispatchPolicy = make_dispatch(
            resolve_dispatch(self.cfg.policy,
                             overload_factor=self.cfg.overload_factor,
                             adaptive_window=self.cfg.adaptive_window,
                             slice_init=self.cfg.slice_init), self.views)
        self.predictor = make_predictor(self.cfg.predictor)
        self.eta_log: dict[int, Optional[int]] = {}
        self.central_queue: deque[Request] = deque()
        self.t = 0
        # -- fleet lifecycle (docs/CLUSTER.md) --------------------------
        lc = self.cfg.lifecycle
        self.lifecycle = (LifecycleSpec.parse(lc)
                          if isinstance(lc, str) else lc)
        sc = self.cfg.scaling
        self.scaling = ScalingSpec.parse(sc) if isinstance(sc, str) else sc
        self._cold_pen = int(self.lifecycle.cold) if self.lifecycle else 0
        self._warm = (WarmSet(self.n_servers,
                              keep_alive=self.lifecycle.keep_alive,
                              cap=self.lifecycle.warm_cap)
                      if self._cold_pen > 0 else None)
        self._cold_extra: dict[int, int] = {}   # rid -> charged inflation
        self._fail_at = self.lifecycle.fail_at if self.lifecycle else None
        self._fail_server = (self.lifecycle.fail_server
                             if self.lifecycle else 0)
        self._dead: set[int] = set()
        self._scaler = (Autoscaler(self.scaling, self.n_servers,
                                   [v.lanes for v in self.views])
                        if self.scaling is not None else None)
        # -- chaos (core/chaos.py, docs/CLUSTER.md) ---------------------
        fa = self.cfg.faults
        self.faults = FaultSpec.parse(fa) if isinstance(fa, str) else fa
        rt = self.cfg.retry
        self.retry = RetrySpec.parse(rt) if isinstance(rt, str) else rt
        self._timeline = (FaultTimeline(self.faults, self.n_servers)
                          if self.faults is not None else None)
        self._watchdog = (RetryWatchdog(self.retry)
                          if self.retry is not None else None)
        self._shed: list[Request] = []
        self.chaos_counts = {"shed": 0, "timeout": 0, "retry": 0}
        # live membership: None = unrestricted (legacy fast paths); a
        # sorted list once autoscaling or a failure constrains routing
        self._active: Optional[list] = None
        if self._scaler is not None:
            self._active = self._scaler.initial_active()
            self.policy.set_active(self._active)
        # (t, central_qlen after pulls, tuple of per-engine active counts)
        self.tick_log: list[tuple[int, int, tuple]] = []
        # opt-in telemetry (core/telemetry.py): all None when disabled,
        # so the hot loop pays one attribute read per guard and nothing
        # else (pinned by tests/test_telemetry.py)
        self.telemetry = None
        self._trace = None
        self._series = None
        self._prof = None

    def attach_telemetry(self, tel):
        """Wire a :class:`repro_torch.core.telemetry.Telemetry` session into
        this run.  Must be called before ``run()``; backends extend
        ``_bind_backend`` to hook their stepping loops."""
        self.telemetry = tel
        if tel is None:
            return
        self._trace = tel.trace
        self._series = tel.series
        self._prof = tel.profile
        self._bind_backend(tel)

    def _bind_backend(self, tel):
        """Backend hook: propagate collectors into the stepping layer."""

    # -- backend hooks -------------------------------------------------
    def _submit(self, idx: int, req: Request):
        raise NotImplementedError

    def _step(self):
        raise NotImplementedError

    def _active_counts(self) -> tuple:
        raise NotImplementedError

    def _finished_count(self) -> int:
        raise NotImplementedError

    def _collect(self) -> list:
        raise NotImplementedError

    # ------------------------------------------------------------------
    def _observe_finish(self, req: Request, t: int):
        """Feedback loop: predictors only ever see finished requests."""
        if self._watchdog is not None:
            self._watchdog.complete(req.rid)
        ser = self._series
        if ser is not None:
            c = ser.counters
            c["completions"] += 1
            if req.demoted:
                c["demoted_done"] += 1
            c["nctx_done"] += req.n_ctx
        self.predictor.observe(req.func_id, req.service_demand)

    def route(self, req: Request) -> Optional[int]:
        """Engine index for ``req`` (None = held in the central queue).

        The ETA hint flows through the shared
        :func:`repro_torch.core.dispatch.route_hinted` entry point: the
        ``oracle`` predictor passes the front-end ``req.eta_hint``
        through unchanged (legacy behaviour); learned predictors see
        only ``req.func_id``.
        """
        idx, eta = route_hinted(self.policy, self.predictor, req.rid,
                                req.func_id, req.eta_hint, self.t)
        self.eta_log[req.rid] = eta
        ser = self._series
        if ser is not None:
            ser.counters["predictor_hits" if eta is not None
                         else "predictor_misses"] += 1
        return idx

    def _deliver(self, idx: int, req: Request):
        self.policy.record(idx)
        eta = self.eta_log.get(req.rid)
        if self._warm is not None:
            # per-dispatch coldness: a redispatched request whose prior
            # cold charge was never unwound (any requeue path) is
            # uncharged first, so repeated hops can never compound
            # cold_extra — the charge below is idempotent per dispatch
            stale = self._cold_extra.pop(req.rid, 0)
            if stale:
                req.n_tokens -= stale
            # cold start: charge the penalty as extra decode demand the
            # moment the request lands on a server whose container for
            # this function is absent or expired (docs/CLUSTER.md)
            if self._warm.is_cold(idx, req.func_id, self.t):
                self._cold_extra[req.rid] = self._cold_pen
                req.n_tokens += self._cold_pen
                if self._trace is not None:
                    self._trace.emit(self.t, "cold_start", req.rid, idx,
                                     self._cold_pen)
            self._warm.touch(idx, req.func_id, self.t)
        if self._trace is not None:
            # dispatch-route event: chosen server + predictor ETA
            self._trace.emit(self.t, "dispatch", req.rid, idx, eta)
        if req.eta_hint is None and eta is not None:
            # propagate the learned estimate so a per-engine scheduler
            # running in hinted_demotion mode can use it; an explicit
            # front-end hint is never overwritten
            req.eta_hint = eta
        if self._watchdog is not None:
            self._watchdog.on_dispatch(req.rid, idx, self.t, eta)
        self._submit(idx, req)

    # -- fleet lifecycle ------------------------------------------------
    def _evict_server(self, idx: int) -> list:
        """Backend hook: remove every resident request of server ``idx``
        (in-flight, queued and slot-pending) and reset the server to an
        empty state.  Returns the evicted serving Requests."""
        raise NotImplementedError

    def _evict_request(self, idx: int, rid: int):
        """Backend hook: remove the single request ``rid`` from server
        ``idx`` (wherever it sits: slot-pending, queued, in a FILTER
        lane or the fair pool) and return it, or None if absent."""
        raise NotImplementedError

    def _lifecycle_horizon(self) -> Optional[int]:
        """Next tick a lifecycle decision can fire at, or None.  The
        fleet backend clamps its event-driven fast-forward to this so
        failure/scale/fault/timeout decisions are evaluated at exactly
        the same tick as in the per-tick backends."""
        if (self._fail_at is None and self._scaler is None
                and self._timeline is None and self._watchdog is None):
            return None
        extras = []
        if self._timeline is not None:
            extras.append(self._timeline.next_time())
        if self._watchdog is not None:
            extras.append(self._watchdog.next_boundary())
        return lifecycle_horizon(self.t, self._fail_at, self._scaler,
                                 extras)

    def _lifecycle_tick(self):
        """Evaluate faults/recoveries, failure, request deadlines and
        autoscale at the top of a tick, before any of the tick's
        arrivals are routed."""
        t = self.t
        if self._timeline is not None:
            for _, kind, idx in self._timeline.due(t):
                if kind == "recover":
                    self._recover(idx)
                else:
                    self._maybe_fail(idx)
        if self._fail_at is not None and t >= self._fail_at:
            self._fail_at = None
            self._fail(self._fail_server)
        if self._watchdog is not None:
            self._watchdog_tick(t)
        if self._scaler is not None and t % self._scaler.period == 0:
            self._autoscale()

    def _maybe_fail(self, idx: int):
        """A FaultTimeline failure event: skipped when the server is
        already dead (overlapping episodes) or when killing it would
        leave the fleet with no live server to route to."""
        if idx in self._dead or len(self._dead) + 1 >= self.n_servers:
            return
        self._fail(idx)

    def _fail(self, idx: int):
        """Kill server ``idx``: evict its resident requests, remove it
        from the routable set, and re-enter every evicted request
        through normal dispatch (requeue events).  The server stays
        dead until a scheduled recovery (if any) revives it."""
        self._dead.add(idx)
        if self._warm is not None:
            self._warm.fail(idx)
        tr = self._trace
        if tr is not None:
            tr.emit(self.t, "fail", -1, idx)
        evicted = self._evict_server(idx)
        if self._active is None:
            self._active = [i for i in range(self.n_servers)
                            if i not in self._dead]
        else:
            self._active = [i for i in self._active if i != idx]
            if not self._active:
                # the last routable server died while live spares sit
                # drained: emergency-activate the lowest-index one so
                # the evicted work (and future arrivals) can route
                spare = min(i for i in range(self.n_servers)
                            if i not in self._dead)
                self._active = [spare]
                if tr is not None:
                    tr.emit(self.t, "scale", -1, spare, 1)
        self.policy.set_active(self._active)
        wd = self._watchdog
        for req in sorted(evicted, key=lambda r: r.rid):
            if wd is not None:
                wd.disarm(req.rid)
            req.requeue_reset(self._cold_extra.pop(req.rid, 0))
            if tr is not None:
                tr.emit(self.t, "requeue", req.rid, idx)
            self._redispatch(req)

    def _recover(self, idx: int):
        """A FaultTimeline repair completed: the server re-enters the
        fleet empty and cold (its warm set was dropped at failure).
        Without an autoscaler it rejoins the routable set immediately;
        with one it comes back drained — the next scale-up may re-admit
        it now that it is no longer dead."""
        if idx not in self._dead:
            return                       # never died (failure skipped)
        self._dead.discard(idx)
        if self._trace is not None:
            self._trace.emit(self.t, "recover", -1, idx)
        if self._scaler is None and self._active is not None:
            self._active = sorted(set(self._active) | {idx})
            self.policy.set_active(self._active)

    def _watchdog_tick(self, t):
        """Drain expired deadlines (timeouts + hedges) then released
        backoff holds, in deterministic (time, rid) order."""
        wd = self._watchdog
        tr = self._trace
        for rid, idx, kind in wd.expired(t):
            req = self._evict_request(idx, rid)
            if req is None:              # defensive: state drifted
                continue
            req.requeue_reset(self._cold_extra.pop(rid, 0))
            if kind == "hedge":
                # straggler relocation: cancel-and-redispatch once,
                # without burning retry budget
                wd.mark_hedged(rid)
                self.chaos_counts["retry"] += 1
                if tr is not None:
                    tr.emit(t, "retry", rid, idx, 1)
                self._redispatch(req)
                continue
            self.chaos_counts["timeout"] += 1
            if tr is not None:
                tr.emit(t, "timeout", rid, idx)
            attempt = wd.record_timeout(rid)
            if wd.exhausted(rid):
                # retry budget spent: shed instead of retrying
                wd.forget(rid)
                self.chaos_counts["shed"] += 1
                self._shed.append(req)
                if tr is not None:
                    tr.emit(t, "shed", rid, idx)
                continue
            release = wd.backoff_until(t, attempt)
            if release <= t:
                self.chaos_counts["retry"] += 1
                if tr is not None:
                    tr.emit(t, "retry", rid, idx)
                self._redispatch(req)
            else:
                wd.hold(rid, req, release)
        for rid, req in wd.released(t):
            self.chaos_counts["retry"] += 1
            if tr is not None:
                tr.emit(t, "retry", rid, -1)
            self._redispatch(req)

    def _redispatch(self, req: Request):
        """Re-enter a requeued/retried request through normal dispatch."""
        idx = self.route(req)
        if idx is None:
            self.central_queue.append(req)
        else:
            self._deliver(idx, req)

    def _autoscale(self):
        load = sum(v.outstanding() for v in self.views) \
            + len(self.central_queue)
        toggles = self._scaler.decide(load, self._active, self._dead)
        if not toggles:
            return
        tr = self._trace
        active = set(self._active)
        for idx, d in toggles:
            if d > 0:
                active.add(idx)
            else:
                active.discard(idx)
            if tr is not None:
                tr.emit(self.t, "scale", -1, idx, d)
        self._active = sorted(active)
        self.policy.set_active(self._active)

    def _shed_filter(self, arrivals):
        """Admission control: drop fresh arrivals while outstanding
        work per active lane sits at/above the ``shed`` watermark —
        kept requests count toward the load their successors see."""
        mark = self._watchdog.shed
        views = (self.views if self._active is None
                 else [self.views[i] for i in self._active])
        load = sum(v.outstanding() for v in views) \
            + len(self.central_queue) + self._watchdog.pending()
        lanes = sum(v.lanes for v in views) or 1
        kept = []
        tr, t = self._trace, self.t
        for r in arrivals:
            if load >= mark * lanes:
                self.chaos_counts["shed"] += 1
                self._shed.append(r)
                if tr is not None:
                    tr.emit(t, "shed", r.rid)
            else:
                kept.append(r)
                load += 1
        return kept

    def tick(self, arrivals: Sequence[Request] = ()):
        """Dispatch this tick's arrivals, drain pulls, tick every engine."""
        if (self._fail_at is not None or self._scaler is not None
                or self._timeline is not None
                or self._watchdog is not None):
            self._lifecycle_tick()
        tr, prof = self._trace, self._prof
        if tr is not None and arrivals:
            t = self.t
            for r in arrivals:
                tr.emit(t, "arrival", r.rid)
        if (arrivals and self._watchdog is not None
                and self._watchdog.shed is not None):
            arrivals = self._shed_filter(arrivals)
        t0 = perf_counter() if prof is not None else 0.0
        if isinstance(self.policy, HashDispatch):
            # legacy Router semantics: route the whole tick's batch
            # against pre-delivery state (p2c comparisons unaffected by
            # same-tick siblings), then deliver
            for idx, req in [(self.route(r), r) for r in arrivals]:
                self._deliver(idx, req)
        else:
            # state-sensitive policies see each delivery immediately —
            # a same-tick burst must grow queue_len/outstanding or the
            # sfs-aware overload bypass could never trigger
            for req in arrivals:
                idx = self.route(req)
                if idx is None:
                    self.central_queue.append(req)
                else:
                    self._deliver(idx, req)
        # pull drain: submit() updates engine capacity immediately, so the
        # loop terminates once every engine is lane- or slot-saturated.
        if self.central_queue and isinstance(self.policy, PullDispatch):
            while self.central_queue:
                idx = self.policy.next_puller()
                if idx is None:
                    break
                self._deliver(idx, self.central_queue.popleft())
        if prof is not None:
            prof.add("route", perf_counter() - t0)
            t0 = perf_counter()
        self._step()
        if prof is not None:
            prof.add("step", perf_counter() - t0)
        self.tick_log.append(
            (self.t, len(self.central_queue), self._active_counts()))
        ser = self._series
        if ser is not None and self.t % ser.cadence == 0:
            ser.sample(self.t, self.views,
                       {"central_queue": len(self.central_queue)})
        self.t += 1

    # ------------------------------------------------------------------
    @property
    def dispatch_counts(self) -> list[int]:
        return list(self.policy.dispatch_counts)

    def summary(self) -> dict:
        return {
            "policy": self.policy.name,
            "predictor": self.predictor.name,
            "engines": self.n_servers,
            "dispatch_counts": self.dispatch_counts,
            "overload_bypasses": getattr(self.policy, "overload_bypasses",
                                         0),
            "ticks": self.t,
        }
