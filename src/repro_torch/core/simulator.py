"""Discrete-event multicore scheduling simulator.

A copy of ``repro.core.simulator`` (the JAX package's module), pure Python
over this package's ``dispatch``, ``predict``, ``lifecycle`` and ``chaos``;
its arithmetic, event order and tie-breaks are the reference's, so every
result is bit-exact with it.

This is the *faithful-reproduction* half of the repo: it models a host OS
scheduling function processes on ``c`` cores, exactly as measured in the
paper's standalone-SFS evaluation (§VIII), and implements:

* ``cfs``   — Linux CFS emulation: single runqueue ordered by vruntime,
              per-dispatch slice = max(sched_latency / nr_runnable,
              min_granularity), vruntime does not tick while waiting.
* ``fifo``  — SCHED_FIFO: run-to-completion, blocked tasks re-enter at the
              queue tail on wake (convoy effect).
* ``rr``    — SCHED_RR: fixed quantum, expired tasks re-enter at the tail.
* ``srtf``  — offline oracle: preemptive Shortest Remaining Time First.
* ``ideal`` — infinite resources, zero contention (analytic).
* ``sfs``   — the paper's two-level scheduler: a FILTER pool (FIFO-like,
              high priority, dynamically-adapted time slice S) concatenated
              with CFS for demoted (long) functions; I/O-aware polling;
              transient-overload bypass (§V-B..E).

Design notes / simplifications (documented in DESIGN.md):
* All tasks share one priority/weight (FaaS functions are peers).
* The CFS runqueue is global (the paper's own argument for a single queue);
  per-core runqueues + load balancing converge to this in steady state.
* In the io-*oblivious* SFS ablation the held core does not run CFS during
  the sleep (the kernel would sneak CFS in); this only strengthens the
  paper's Fig.-11 conclusion and affects no other experiment.
* Context switches counted are involuntary (preemption/demotion/quantum).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Optional

from repro_torch.core.dispatch import (BoundedTimeline, PullDispatch, ServerView,
                                 make_dispatch,
                                 route_hinted)
from repro_torch.core.chaos import FaultTimeline, RetryWatchdog
from repro_torch.core.lifecycle import Autoscaler, WarmSet
from repro_torch.core.predict import make_predictor
from repro_torch.core.spec import (FaultSpec, LifecycleSpec, RetrySpec,
                             ScalingSpec, resolve_dispatch)
from repro_torch.core.workload import Request

_EPS = 1e-12
_INF = float("inf")


# ---------------------------------------------------------------------------
# Config & results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimConfig:
    cores: int = 12
    policy: str = "sfs"               # sfs | cfs | fifo | rr | srtf | ideal
    # --- FILTER (SFS) ---
    slice_s: Optional[float] = None   # fixed S; None => adaptive (paper §V-C)
    adaptive_window: int = 100        # N
    slice_init_s: float = 0.1         # S before the first window closes
    overload_factor: Optional[float] = 3.0   # O; None disables §V-E bypass
    io_aware: bool = True             # §V-D polling on/off
    poll_interval_s: float = 0.004    # 4 ms
    # hinted demotion: a request delivered with an ETA hint > S skips
    # FILTER straight to CFS on arrival — no wasted slice S, no demotion
    # context switch.  Hints arrive via inject(eta=...), i.e. only in
    # cluster mode from the dispatch-level predictor; without a hint the
    # arrival path is unchanged (FILTER optimism).
    hinted_demotion: bool = False
    # --- RR ---
    rr_quantum_s: float = 0.100       # Linux SCHED_RR default
    # --- CFS ---
    cfs_latency_s: float = 0.024      # sched_latency
    cfs_min_gran_s: float = 0.003     # min_granularity
    # --- misc ---
    # Dead time a core pays when it starts running a job it wasn't already
    # running (direct switch cost + cache/TLB pollution; ~100 us is typical
    # for container-heavy hosts).  At rho = 1 this is what makes workload-
    # oblivious fine-slicing (CFS/RR) collapse: effective load exceeds 1 and
    # the backlog grows without bound, while SFS's run-to-completion FILTER
    # keeps the switch rate (and thus effective load) near the offered load.
    ctx_switch_cost_s: float = 100e-6

    def to_spec(self):
        """Equivalent :class:`~repro_torch.core.spec.ServerSpec` (lossless;
        round-trips through ``ServerSpec.to_sim_config()``)."""
        from repro_torch.core.spec import ServerSpec
        return ServerSpec.from_sim_config(self)


@dataclasses.dataclass
class JobStats:
    rid: int
    arrival: float
    service: float
    io_total: float
    finish: float
    n_ctx: int
    demoted: bool
    queue_delay: float                # total time spent in the global queue

    @property
    def turnaround(self) -> float:
        return self.finish - self.arrival

    @property
    def rte(self) -> float:
        """Run-Time Effectiveness (Eq. 1): service time / turnaround."""
        return self.service / max(self.turnaround, _EPS)

    @property
    def slowdown(self) -> float:
        """Turnaround normalized by the IDEAL (zero-contention) turnaround."""
        return self.turnaround / max(self.service + self.io_total, _EPS)


@dataclasses.dataclass
class SimResult:
    stats: list                       # list[JobStats], rid order
    busy_time: float                  # total core-busy seconds
    makespan: float
    n_ctx_total: int
    queue_delay_timeline: list        # [(arrival, queue_delay)] for Fig. 12
    slice_timeline: list              # [(time, S)] adaptive-S trace, Fig. 10


# ---------------------------------------------------------------------------
# Runtime job state
# ---------------------------------------------------------------------------


class _Job:
    __slots__ = ("req", "cpu_done", "io_idx", "slice_left", "vruntime",
                 "finish", "n_ctx", "demoted", "queue_enter", "queue_delay",
                 "io_wake")

    def __init__(self, req: Request):
        self.req = req
        self.cpu_done = 0.0
        self.io_idx = 0
        self.slice_left: Optional[float] = None
        self.vruntime = 0.0
        self.finish: Optional[float] = None
        self.n_ctx = 0
        self.demoted = False
        self.queue_enter: Optional[float] = None
        self.queue_delay = 0.0
        self.io_wake = 0.0

    # -- CPU-demand helpers ------------------------------------------------
    def to_completion(self) -> float:
        return self.req.service - self.cpu_done

    def to_next_io(self) -> float:
        if self.io_idx < len(self.req.io_events):
            return self.req.io_events[self.io_idx][0] - self.cpu_done
        return _INF

    def next_io_dur(self) -> float:
        return self.req.io_events[self.io_idx][1]

    def remaining(self) -> float:
        return self.req.service - self.cpu_done


class _Core:
    __slots__ = ("idx", "state", "job", "token", "seg_start", "last_rid")

    def __init__(self, idx: int):
        self.idx = idx
        self.state = "idle"           # idle | filter | cfs | held
        self.job: Optional[_Job] = None
        self.token = 0
        self.seg_start = 0.0
        self.last_rid = -1            # for switch-in cost accounting


# ---------------------------------------------------------------------------
# The simulator
# ---------------------------------------------------------------------------


class Simulator:
    def __init__(self, requests, cfg: SimConfig):
        self.reqs = list(requests)
        self.cfg = cfg
        self.now = 0.0
        self._seq = 0
        self.events: list = []
        self.cores = [_Core(i) for i in range(cfg.cores)]
        self.global_queue: deque = deque()          # FILTER/FIFO/RR queue
        self.cfs_rq: list = []                      # heap (vruntime, seq, job)
        self.cfs_min_vruntime = 0.0
        self.jobs: dict[int, _Job] = {}
        self.busy_time = 0.0
        self.n_ctx_total = 0
        self.finished = 0
        # adaptive slice state
        self.S = cfg.slice_s if cfg.slice_s is not None else cfg.slice_init_s
        self._iat_window: deque = deque(maxlen=cfg.adaptive_window)
        self._last_arrival: Optional[float] = None
        self._arrivals_since_update = 0
        self.slice_timeline = BoundedTimeline((0.0, self.S))
        self.srtf_wait: list = []        # heap (remaining, seq, job)
        # cluster-mode plumbing: per-rid ETA hints delivered alongside
        # inject(), and a completion callback (req, finish_time) through
        # which the owner feeds its duration predictor — the feedback
        # loop only ever sees *finished* requests.
        self.eta_hints: dict[int, float] = {}
        self.on_finish = None
        # opt-in telemetry (core/telemetry.py): a lifecycle TraceRecorder
        # (events carry float DES times) and a shared fleet-series counter
        # dict; both None when disabled — each emit site pays one read
        self.trace = None
        self.trace_idx = -1
        self.counters = None

    def bind_trace(self, trace, idx: int):
        self.trace = trace
        self.trace_idx = idx

    def _finish_job(self, job: _Job):
        job.finish = self.now
        self.finished += 1
        if self.trace is not None:
            self.trace.emit(self.now, "complete", job.req.rid,
                            self.trace_idx)
        if self.counters is not None:
            c = self.counters
            c["completions"] += 1
            if job.demoted:
                c["demoted_done"] += 1
            c["nctx_done"] += job.n_ctx
        if self.on_finish is not None:
            self.on_finish(job.req, self.now)

    # -- event plumbing -----------------------------------------------------
    def _push(self, t: float, kind: str, *data):
        self._seq += 1
        heapq.heappush(self.events, (t, self._seq, kind, data))

    # -- stepwise API (multi-server / cluster mode) -------------------------
    def next_event_time(self) -> float:
        return self.events[0][0] if self.events else _INF

    def step(self):
        """Pop and process one event."""
        self.now, _, kind, data = heapq.heappop(self.events)
        getattr(self, "_ev_" + kind)(*data)

    def inject(self, req: Request, t: Optional[float] = None,
               eta: Optional[float] = None):
        """Cluster mode: deliver a request to this server at time ``t``.

        ``req.arrival`` keeps the *cluster* arrival time, so turnaround
        measured from it includes any central-queue wait (and dispatch
        latency) before delivery.  ``eta`` is the dispatch tier's
        duration estimate, consumed by ``hinted_demotion``.
        """
        assert self.cfg.policy != "ideal", "ideal has no event loop"
        t = self.now if t is None else t
        self.reqs.append(req)
        if eta is not None:
            self.eta_hints[req.rid] = eta
        kind = "s_arrival" if self.cfg.policy == "srtf" else "arrival"
        self._push(t, kind, req)

    def idle_cores(self) -> int:
        return sum(1 for c in self.cores if c.state == "idle")

    # -- chaos eviction (cluster mode) --------------------------------------
    def evict_rid(self, rid: int):
        """Remove one unfinished request wholesale — queued, running,
        mid-I/O, or still in flight — and return its workload Request
        (None when absent or already finished).  The timeout/hedge
        eviction seam: the cluster owner re-dispatches or sheds the
        request, and must follow with :meth:`kick` to refill any freed
        core.  The partial segment of a running victim is not charged
        to ``busy_time`` (mirrors a server failure's eviction)."""
        req = next((r for r in self.reqs if r.rid == rid), None)
        if req is None:
            return None
        job = self.jobs.get(rid)
        if job is not None and job.finish is not None:
            return None
        self.reqs = [r for r in self.reqs if r.rid != rid]
        self.jobs.pop(rid, None)
        self.eta_hints.pop(rid, None)
        if job is not None:
            if job in self.global_queue:
                self.global_queue.remove(job)
            if any(e[2] is job for e in self.cfs_rq):
                self.cfs_rq = [e for e in self.cfs_rq if e[2] is not job]
                heapq.heapify(self.cfs_rq)
            if any(e[2] is job for e in self.srtf_wait):
                self.srtf_wait = [e for e in self.srtf_wait
                                  if e[2] is not job]
                heapq.heapify(self.srtf_wait)
            for core in self.cores:
                if core.job is job:
                    # the running segment's event dies via the token bump
                    core.token += 1
                    core.job, core.state = None, "idle"
        # drop the request's own pending events: an in-flight arrival
        # (nonzero dispatch latency) and any I/O wake-ups — core
        # segment events already died with the token bump above
        keep = [ev for ev in self.events if not self._owns_event(ev, rid)]
        if len(keep) != len(self.events):
            self.events = keep
            heapq.heapify(self.events)
        return req

    @staticmethod
    def _owns_event(ev, rid: int) -> bool:
        kind, data = ev[2], ev[3]
        if kind in ("arrival", "s_arrival"):
            return data[0].rid == rid
        if kind in ("f_io_done", "c_io_done", "s_io_done",
                    "obliv_io_to_cfs"):
            return data[0] == rid
        return False

    def kick(self):
        """Refill cores after an out-of-band eviction (the normal finish
        path refills from its own event handler)."""
        if self.cfg.policy == "srtf":
            for core in self.cores:
                if core.state == "idle" and self.srtf_wait:
                    _, _, nxt = heapq.heappop(self.srtf_wait)
                    self._srtf_start(core, nxt)
        else:
            self._dispatch(self.now)

    # -- public entry ---------------------------------------------------------
    def run(self) -> SimResult:
        if self.cfg.policy == "ideal":
            return self._run_ideal()
        if self.cfg.policy == "srtf":
            return self._run_srtf()
        for r in self.reqs:
            self._push(r.arrival, "arrival", r)
        while self.events:
            self.step()
        return self._result()

    # ------------------------------------------------------------------
    # IDEAL: infinite resources, zero contention
    # ------------------------------------------------------------------
    def _run_ideal(self) -> SimResult:
        stats = []
        for r in self.reqs:
            fin = r.arrival + r.ideal_turnaround
            stats.append(JobStats(r.rid, r.arrival, r.service, r.total_io,
                                  fin, 0, False, 0.0))
        mk = max(s.finish for s in stats) if stats else 0.0
        return SimResult(stats, sum(r.service for r in self.reqs), mk, 0,
                         [], [])

    # ------------------------------------------------------------------
    # SRTF oracle: preemptive shortest-remaining-first on c cores
    # ------------------------------------------------------------------
    def _run_srtf(self) -> SimResult:
        for r in self.reqs:
            self._push(r.arrival, "s_arrival", r)
        while self.events:
            self.step()
        return self._result()

    def _srtf_admit(self, job: _Job):
        """Place a runnable job: idle core, else preempt the worst, else wait."""
        idle = next((c for c in self.cores if c.state == "idle"), None)
        if idle is not None:
            self._srtf_start(idle, job)
            return
        worst = max((c for c in self.cores if c.job is not None),
                    key=lambda c: self._srtf_live_remaining(c), default=None)
        if worst is not None and \
                self._srtf_live_remaining(worst) > job.remaining() + _EPS:
            pre = self._srtf_preempt(worst)
            pre.n_ctx += 1
            self.n_ctx_total += 1
            if self.trace is not None:
                self.trace.emit(self.now, "preempt", pre.req.rid,
                                self.trace_idx)
            self._seq += 1
            heapq.heappush(self.srtf_wait, (pre.remaining(), self._seq, pre))
            self._srtf_start(worst, job)
        else:
            self._seq += 1
            heapq.heappush(self.srtf_wait, (job.remaining(), self._seq, job))

    def _srtf_live_remaining(self, core: _Core) -> float:
        return core.job.remaining() - max(self.now - core.seg_start, 0.0)

    def _srtf_preempt(self, core: _Core) -> _Job:
        job = core.job
        used = max(self.now - core.seg_start, 0.0)
        job.cpu_done += used
        self.busy_time += used
        core.token += 1
        core.job, core.state = None, "idle"
        return job

    def _srtf_start(self, core: _Core, job: _Job):
        cost = self.cfg.ctx_switch_cost_s if core.last_rid != job.req.rid \
            else 0.0
        core.last_rid = job.req.rid
        start = self.now + cost
        core.job, core.state, core.seg_start = job, "cfs", start
        core.token += 1
        seg = min(job.to_completion(), job.to_next_io())
        self._push(start + max(seg, 0.0), "s_seg_end", core.idx, core.token)

    def _ev_s_arrival(self, req: Request):
        job = _Job(req)
        self.jobs[req.rid] = job
        self._srtf_admit(job)

    def _ev_s_seg_end(self, core_idx: int, token: int):
        core = self.cores[core_idx]
        if core.token != token or core.job is None:
            return
        job = self._srtf_preempt(core)   # accounts cpu, frees core
        if job.to_completion() <= _EPS:
            self._finish_job(job)
        elif job.to_next_io() <= _EPS:
            dur = job.next_io_dur()
            job.io_idx += 1
            self._push(self.now + dur, "s_io_done", job.req.rid)
        # pull next waiter onto the freed core
        if self.srtf_wait and core.state == "idle":
            _, _, nxt = heapq.heappop(self.srtf_wait)
            self._srtf_start(core, nxt)

    def _ev_s_io_done(self, rid: int):
        self._srtf_admit(self.jobs[rid])

    # ------------------------------------------------------------------
    # Unified FILTER/CFS machinery (sfs, cfs, fifo, rr)
    # ------------------------------------------------------------------

    # -- arrivals ------------------------------------------------------
    def _ev_arrival(self, req: Request):
        job = _Job(req)
        self.jobs[req.rid] = job
        self._observe_arrival(req.arrival)
        if self.cfg.policy == "cfs":
            self._cfs_enqueue(job)
        elif (self.cfg.policy == "sfs" and self.cfg.hinted_demotion
                and self.eta_hints.get(req.rid, 0.0) > self.S):
            # predicted-long: skip FILTER straight to CFS — saves the
            # wasted slice S and the demotion context switch
            job.demoted = True
            if self.trace is not None:
                self.trace.emit(self.now, "demote", req.rid,
                                self.trace_idx)
            self._cfs_enqueue(job)
        else:
            self._enqueue_global(job)
        self._dispatch(self.now)

    def _observe_arrival(self, t: float):
        if self.cfg.policy != "sfs" or self.cfg.slice_s is not None:
            return
        if self._last_arrival is not None:
            self._iat_window.append(t - self._last_arrival)
        self._last_arrival = t
        self._arrivals_since_update += 1
        if (self._arrivals_since_update >= self.cfg.adaptive_window
                and len(self._iat_window) == self.cfg.adaptive_window):
            mean_iat = sum(self._iat_window) / len(self._iat_window)
            self.S = mean_iat * self.cfg.cores          # S = mean(IAT) * c
            self._arrivals_since_update = 0
            self.slice_timeline.append((t, self.S))

    def _enqueue_global(self, job: _Job):
        job.queue_enter = self.now
        self.global_queue.append(job)

    # -- central dispatch: keep all cores busy per the two-level policy --
    def _dispatch(self, now: float):
        # 1) FILTER jobs claim cores (idle first, then preempt CFS tasks).
        while self.global_queue:
            core = next((c for c in self.cores if c.state == "idle"), None)
            if core is None:
                core = next((c for c in self.cores if c.state == "cfs"), None)
            if core is None:
                break
            job = self.global_queue.popleft()
            job.queue_delay += now - job.queue_enter
            # §V-E transient-overload bypass: long queuing delay => CFS.
            if (self.cfg.policy == "sfs"
                    and self.cfg.overload_factor is not None
                    and now - job.queue_enter
                    >= self.cfg.overload_factor * self.S):
                if self.trace is not None:
                    self.trace.emit(now, "bypass", job.req.rid,
                                    self.trace_idx)
                self._cfs_enqueue(job)
                continue
            if core.state == "cfs":
                self._cfs_preempt(core)
            self._filter_start(core, job)
        # 2) remaining idle cores run CFS.
        for core in self.cores:
            if core.state == "idle" and self.cfs_rq:
                self._cfs_start(core)

    # -- FILTER pool ----------------------------------------------------
    def _filter_start(self, core: _Core, job: _Job):
        if job.slice_left is None or self.cfg.policy == "rr":
            job.slice_left = (self.cfg.rr_quantum_s
                              if self.cfg.policy == "rr" else self.S)
        if self.cfg.policy == "fifo":
            job.slice_left = _INF
        if self.trace is not None:
            self.trace.emit(self.now, "admit", job.req.rid, self.trace_idx)
        # switch-in cost: dead time before the job's CPU burst resumes
        cost = self.cfg.ctx_switch_cost_s if core.last_rid != job.req.rid \
            else 0.0
        core.last_rid = job.req.rid
        start = self.now + cost
        core.job, core.state, core.seg_start = job, "filter", start
        core.token += 1
        seg = min(job.slice_left, job.to_completion(), job.to_next_io())
        seg = max(seg, 0.0)
        if job.to_next_io() <= seg + _EPS and job.to_next_io() < _INF \
                and job.to_next_io() <= min(job.slice_left,
                                            job.to_completion()) + _EPS:
            # segment will end by blocking on I/O
            t_block = start + job.to_next_io()
            if self.cfg.io_aware:
                # user-space polling detects the sleep at the next poll tick
                p = self.cfg.poll_interval_s
                detect = (math.ceil((t_block - self.now) / p) * p
                          if p > 0 else t_block - self.now)
                self._push(max(self.now + detect, t_block), "f_io_detect",
                           core.idx, core.token, t_block)
            else:
                self._push(t_block, "f_obliv_block", core.idx, core.token)
        else:
            self._push(start + seg, "f_seg_end", core.idx, core.token)

    def _filter_release(self, core: _Core, used_cpu: float):
        job = core.job
        job.cpu_done += used_cpu
        if job.slice_left is not None and job.slice_left < _INF:
            job.slice_left -= used_cpu
        self.busy_time += used_cpu
        core.token += 1
        core.job, core.state = None, "idle"
        return job

    def _ev_f_seg_end(self, core_idx: int, token: int):
        core = self.cores[core_idx]
        if core.token != token:
            return
        used = max(self.now - core.seg_start, 0.0)
        job = self._filter_release(core, used)
        if job.to_completion() <= _EPS:                      # 4.1 done
            self._finish_job(job)
        elif job.slice_left is not None and job.slice_left <= _EPS:
            job.n_ctx += 1
            self.n_ctx_total += 1
            if self.cfg.policy == "rr":                      # RR: back to tail
                if self.trace is not None:
                    self.trace.emit(self.now, "preempt", job.req.rid,
                                    self.trace_idx)
                self._enqueue_global(job)
            else:                                            # 4.2 demote
                job.demoted = True
                if self.trace is not None:
                    self.trace.emit(self.now, "demote", job.req.rid,
                                    self.trace_idx)
                self._cfs_enqueue(job)
        else:                                                # shouldn't happen
            self._enqueue_global(job)
        self._dispatch(self.now)

    def _ev_f_io_detect(self, core_idx: int, token: int, t_block: float):
        """io-aware: worker poll notices the sleep (§V-D).

        CPU consumed is only up to t_block; the (now - t_block) gap held the
        core but burned no slice (the worker 'records the unused time slice').
        """
        core = self.cores[core_idx]
        if core.token != token:
            return
        job = self._filter_release(core, t_block - core.seg_start)
        job.n_ctx += 1
        self.n_ctx_total += 1
        if self.trace is not None:
            self.trace.emit(self.now, "preempt", job.req.rid,
                            self.trace_idx)
        dur = job.next_io_dur()
        job.io_idx += 1
        self._push(t_block + dur, "f_io_done", job.req.rid)
        self._dispatch(self.now)

    def _ev_f_obliv_block(self, core_idx: int, token: int):
        """io-oblivious ablation: worker keeps the core + the slice ticking."""
        core = self.cores[core_idx]
        if core.token != token:
            return
        job = core.job
        used = self.now - core.seg_start
        job.cpu_done += used
        self.busy_time += used
        dur = job.next_io_dur()
        job.io_idx += 1
        slice_after = (job.slice_left - used - dur
                       if job.slice_left is not None else _INF)
        if slice_after <= _EPS and self.cfg.policy == "sfs":
            # slice burns out mid-I/O: worker demotes at expiry, frees core
            t_expire = self.now + max(job.slice_left - used, 0.0)
            job.slice_left = 0.0
            core.token += 1
            core.job, core.state = None, "idle"
            job.demoted = True
            job.n_ctx += 1
            self.n_ctx_total += 1
            if self.trace is not None:
                self.trace.emit(self.now, "demote", job.req.rid,
                                self.trace_idx)
            self._push(self.now + dur, "obliv_io_to_cfs", job.req.rid)
            self._push(t_expire, "kick", )
        else:
            # core held (worker believes the fn is running); resume on wake
            job.slice_left = (job.slice_left - used - dur
                              if job.slice_left is not None else None)
            core.state = "held"
            core.token += 1
            self._push(self.now + dur, "obliv_resume", core.idx, core.token)

    def _ev_obliv_resume(self, core_idx: int, token: int):
        core = self.cores[core_idx]
        if core.token != token:
            return
        job = core.job
        core.job, core.state = None, "idle"
        core.token += 1
        self._filter_start(core, job)

    def _ev_obliv_io_to_cfs(self, rid: int):
        self._cfs_enqueue(self.jobs[rid])
        self._dispatch(self.now)

    def _ev_kick(self):
        self._dispatch(self.now)

    def _ev_f_io_done(self, rid: int):
        """io-aware wake-up: back to the global queue (keeps leftover slice)."""
        job = self.jobs[rid]
        self._enqueue_global(job)
        self._dispatch(self.now)

    # -- CFS pool ---------------------------------------------------------
    def _cfs_enqueue(self, job: _Job):
        job.vruntime = max(job.vruntime, self.cfs_min_vruntime)
        self._seq += 1
        heapq.heappush(self.cfs_rq, (job.vruntime, self._seq, job))

    def _cfs_nr_runnable(self) -> int:
        return len(self.cfs_rq) + sum(1 for c in self.cores
                                      if c.state == "cfs")

    def _cfs_start(self, core: _Core):
        vr, _, job = heapq.heappop(self.cfs_rq)
        self.cfs_min_vruntime = max(self.cfs_min_vruntime, vr)
        nr = self._cfs_nr_runnable() + 1
        slice_ = max(self.cfg.cfs_latency_s / nr, self.cfg.cfs_min_gran_s)
        cost = self.cfg.ctx_switch_cost_s if core.last_rid != job.req.rid \
            else 0.0
        core.last_rid = job.req.rid
        start = self.now + cost
        core.job, core.state, core.seg_start = job, "cfs", start
        core.token += 1
        seg = max(min(slice_, job.to_completion(), job.to_next_io()), 0.0)
        cause = "slice"
        if job.to_completion() <= seg + _EPS:
            seg, cause = job.to_completion(), "done"
        if job.to_next_io() <= seg + _EPS:
            seg, cause = job.to_next_io(), "io"
        self._push(start + max(seg, 0.0), "c_seg_end", core.idx,
                   core.token, cause)

    def _cfs_preempt(self, core: _Core):
        """A FILTER job claims this core; the CFS task goes back runnable."""
        job = core.job
        used = max(self.now - core.seg_start, 0.0)
        job.cpu_done += used
        job.vruntime += used
        self.busy_time += used
        job.n_ctx += 1
        self.n_ctx_total += 1
        if self.trace is not None:
            self.trace.emit(self.now, "preempt", job.req.rid,
                            self.trace_idx)
        core.token += 1
        core.job, core.state = None, "idle"
        self._cfs_enqueue(job)

    def _ev_c_seg_end(self, core_idx: int, token: int, cause: str):
        core = self.cores[core_idx]
        if core.token != token:
            return
        job = core.job
        used = max(self.now - core.seg_start, 0.0)
        job.cpu_done += used
        job.vruntime += used
        self.busy_time += used
        core.token += 1
        core.job, core.state = None, "idle"
        if cause == "done" or job.to_completion() <= _EPS:
            self._finish_job(job)
        elif cause == "io" or job.to_next_io() <= _EPS:
            dur = job.next_io_dur()
            job.io_idx += 1
            self._push(self.now + dur, "c_io_done", job.req.rid)
        else:                                   # slice expiry
            if self.cfs_rq:
                job.n_ctx += 1
                self.n_ctx_total += 1
                if self.trace is not None:
                    self.trace.emit(self.now, "preempt", job.req.rid,
                                    self.trace_idx)
            self._cfs_enqueue(job)
        self._dispatch(self.now)

    def _ev_c_io_done(self, rid: int):
        self._cfs_enqueue(self.jobs[rid])
        self._dispatch(self.now)

    # -- results ----------------------------------------------------------
    def _result(self) -> SimResult:
        stats, mk = [], 0.0
        for r in self.reqs:
            j = self.jobs[r.rid]
            assert j.finish is not None, f"job {r.rid} never finished"
            stats.append(JobStats(r.rid, r.arrival, r.service, r.total_io,
                                  j.finish, j.n_ctx, j.demoted,
                                  j.queue_delay))
            mk = max(mk, j.finish)
        qd = [(s.arrival, s.queue_delay) for s in stats]
        return SimResult(stats, self.busy_time, mk, self.n_ctx_total, qd,
                         list(self.slice_timeline))


def simulate(requests, cfg: SimConfig) -> SimResult:
    """Run one policy over a workload; deterministic given the workload."""
    return Simulator(requests, cfg).run()


# ---------------------------------------------------------------------------
# Multi-server mode: N per-server Simulators behind cluster dispatch
# ---------------------------------------------------------------------------


class _SimView(ServerView):
    """Dispatch-visible scheduling state of one DES server.

    Under nonzero dispatch latency the server's own state is stale by
    design (a routed request only arrives ``dispatch_latency_s`` later),
    but the *router* always knows what it already sent: in-flight
    requests count against idle capacity and spill into the estimated
    FILTER queue.  With zero latency in-flight is always empty, so these
    corrections reduce exactly to the zero-latency views (bit-exact).
    """

    def __init__(self, sim: Simulator):
        self.sim = sim

    @property
    def lanes(self) -> int:
        return self.sim.cfg.cores

    def _in_flight(self) -> int:
        # injected (reqs) but not yet arrived (jobs is keyed at arrival)
        return len(self.sim.reqs) - len(self.sim.jobs)

    def outstanding(self) -> int:
        return len(self.sim.reqs) - self.sim.finished

    def filter_free(self) -> int:
        return max(0, self.sim.idle_cores() - self._in_flight())

    def fair_load(self) -> int:
        return len(self.sim.cfs_rq) + sum(1 for c in self.sim.cores
                                          if c.state == "cfs")

    def queue_len(self) -> int:
        spill = max(0, self._in_flight() - self.sim.idle_cores())
        return len(self.sim.global_queue) + spill

    def capacity(self) -> int:
        return max(0, self.sim.idle_cores() - self._in_flight())


@dataclasses.dataclass
class ClusterSimConfig:
    n_servers: int = 4
    # dispatch policy: a name ("hash" | "least-outstanding" | "pull" |
    # "sfs-aware"), a "name:key=val,..." spec string, or a
    # repro_torch.core.spec.DispatchSpec
    dispatch: object = "hash"
    server: SimConfig = dataclasses.field(default_factory=SimConfig)
    # heterogeneous mode: an explicit per-server SimConfig list
    # (mixed cores / policies / knobs).  Overrides n_servers x server.
    servers: Optional[list] = None
    # duration predictor feeding dispatch its ETA hints
    # (repro_torch.core.predict): "oracle" = the front-end knows each
    # request's true service demand (the legacy hinted=True), "none" =
    # dispatch flies blind (hinted=False), "history" / "class" = learned
    # online from finished requests.  Also accepts an EtaPredictor
    # instance (shared / pre-trained), a PredictorSpec, or a
    # "name:key=val,..." spec.
    predictor: object = "oracle"
    # router -> server network delay: a routed request is injected at
    # arrival + this, so online policies route on slightly stale state
    dispatch_latency_s: float = 0.0
    # sfs-aware cluster knobs (units: seconds, like the per-server S);
    # explicit args on a dispatch spec take precedence over these
    overload_factor: float = 3.0
    adaptive_window: int = 100
    slice_init_s: float = 0.1
    # fleet lifecycle (cold starts / keep-alive / failure) and
    # autoscaling: None, a LifecycleSpec/ScalingSpec, or its string
    # form — knob times are float DES seconds here
    lifecycle: object = None
    scaling: object = None
    # chaos subsystem (core/chaos.py): correlated failure episodes with
    # recovery (FaultSpec) and request timeouts/retries/hedging/
    # shedding (RetrySpec) — knob times are float DES seconds here
    faults: object = None
    retry: object = None

    def server_configs(self) -> list:
        """The per-server SimConfig list both modes reduce to."""
        if self.servers is not None:
            return [dataclasses.replace(s) for s in self.servers]
        return [dataclasses.replace(self.server)
                for _ in range(self.n_servers)]

    def to_spec(self, workload=None):
        """Equivalent :class:`~repro_torch.core.spec.ExperimentSpec` (golden-
        pinned: running it reproduces this config's results bit-exact)."""
        from repro_torch.core.spec import ExperimentSpec
        return ExperimentSpec(
            engine="des",
            servers=tuple(sc.to_spec() for sc in self.server_configs()),
            dispatch=resolve_dispatch(self.dispatch,
                                      overload_factor=self.overload_factor,
                                      adaptive_window=self.adaptive_window,
                                      slice_init=self.slice_init_s),
            predictor=self.predictor, workload=workload,
            dispatch_latency=self.dispatch_latency_s,
            lifecycle=self.lifecycle, scaling=self.scaling,
            faults=self.faults, retry=self.retry)


@dataclasses.dataclass
class ClusterSimResult:
    merged: SimResult                 # all servers, stats in rid order
    per_server: list                  # list[SimResult]
    dispatch_counts: list
    policy: str
    overload_bypasses: int = 0
    predictor: str = "oracle"
    # rid -> eta used at routing time (None = no estimate), for
    # prediction-error accounting against the true durations
    eta_log: dict = dataclasses.field(default_factory=dict)
    # the dispatch policy's final adaptive slice S (sfs-aware only) —
    # the short/long boundary for misclassification accounting
    dispatch_S: Optional[float] = None


class ClusterSimulator:
    """Drives N per-server :class:`Simulator` instances from one shared
    arrival stream through a :mod:`repro_torch.core.dispatch` policy.
    Servers may be heterogeneous (``cfg.servers``: per-server SimConfigs
    with mixed cores / policies), typically declared through
    :class:`repro_torch.core.spec.ExperimentSpec`.

    The global event loop interleaves server event heaps and the arrival
    stream in timestamp order, so online policies (least-outstanding,
    pull, sfs-aware) observe each server's true state at dispatch time.
    With ``n_servers=1`` and ``hash`` dispatch this reduces exactly to
    the single :class:`Simulator` (cross-validated in tests).

    ETA hints come from ``cfg.predictor`` (repro_torch.core.predict) through
    the shared :func:`repro_torch.core.dispatch.route_hinted` entry point; the
    feedback loop closes on each server's completion callback, so
    learned predictors only ever observe *finished* requests.
    """

    def __init__(self, requests, cfg: ClusterSimConfig):
        server_cfgs = cfg.server_configs()
        if any(sc.policy == "ideal" for sc in server_cfgs):
            raise ValueError("per-server policy 'ideal' has no event loop")
        self.reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        self.cfg = cfg
        self.predictor = make_predictor(cfg.predictor)
        self.servers = [Simulator([], sc) for sc in server_cfgs]
        for s in self.servers:
            s.on_finish = self._observe_finish
        views = [_SimView(s) for s in self.servers]
        self.policy = make_dispatch(
            resolve_dispatch(cfg.dispatch,
                             overload_factor=cfg.overload_factor,
                             adaptive_window=cfg.adaptive_window,
                             slice_init=cfg.slice_init_s), views)
        self.central: deque = deque()          # (req, eta) under pull
        self.eta_log: dict[int, Optional[float]] = {}
        self.views = views
        # -- fleet lifecycle (docs/CLUSTER.md), mirrors ClusterFrontend:
        # the decision state machines are shared (repro_torch.core.lifecycle),
        # only the time base differs (float seconds here)
        lc = cfg.lifecycle
        self.lifecycle = LifecycleSpec.parse(lc) if isinstance(lc, str) \
            else lc
        sc = cfg.scaling
        self.scaling = ScalingSpec.parse(sc) if isinstance(sc, str) else sc
        self._cold_pen = (float(self.lifecycle.cold)
                          if self.lifecycle else 0.0)
        self._warm = (WarmSet(len(self.servers),
                              keep_alive=self.lifecycle.keep_alive,
                              cap=self.lifecycle.warm_cap)
                      if self._cold_pen > 0 else None)
        self._cold_extra: dict[int, float] = {}   # rid -> charged inflation
        self._fail_at = self.lifecycle.fail_at if self.lifecycle else None
        self._fail_server = (self.lifecycle.fail_server
                             if self.lifecycle else 0)
        self._dead: set[int] = set()
        self._scaler = (Autoscaler(self.scaling, len(self.servers),
                                   [v.lanes for v in views])
                        if self.scaling is not None else None)
        self._active: Optional[list] = None
        self._next_scale = 0.0
        if self._scaler is not None:
            self._active = self._scaler.initial_active()
            self.policy.set_active(self._active)
        # -- chaos (docs/CLUSTER.md "Chaos and graceful degradation"):
        # the same deterministic state machines as the tick frontend
        # (repro_torch.core.chaos), run in float DES seconds
        fa = cfg.faults
        self.faults = FaultSpec.parse(fa) if isinstance(fa, str) else fa
        rt = cfg.retry
        self.retry = RetrySpec.parse(rt) if isinstance(rt, str) else rt
        self._timeline = (FaultTimeline(self.faults, len(self.servers),
                                        integral=False)
                          if self.faults is not None else None)
        self._watchdog = (RetryWatchdog(self.retry, integral=False)
                          if self.retry is not None else None)
        self._shed: list = []
        self.chaos_counts = {"shed": 0, "timeout": 0, "retry": 0}
        # opt-in telemetry (core/telemetry.py), mirrors
        # ClusterFrontend.attach_telemetry; all None when disabled
        self.telemetry = None
        self._trace = None
        self._series = None
        self._next_sample = 0.0

    def attach_telemetry(self, tel):
        """Wire a :class:`repro_torch.core.telemetry.Telemetry` session.  Same
        contract as ``ClusterFrontend.attach_telemetry``; event times and
        the series cadence are in float DES seconds, and completion
        counters are fed by each server's shared counter dict (the
        workload ``Request`` carries no demotion state)."""
        self.telemetry = tel
        if tel is None:
            return
        self._trace = tel.trace
        self._series = tel.series
        if tel.trace is not None:
            for i, s in enumerate(self.servers):
                s.bind_trace(tel.trace, i)
        if tel.series is not None:
            for s in self.servers:
                s.counters = tel.series.counters

    def _sample_to(self, t: float):
        """Emit fleet-series samples at every cadence boundary up to
        ``t`` (state as of just before the event at ``t``)."""
        ser = self._series
        while self._next_sample <= t:
            ser.sample(self._next_sample, self.views,
                       {"central_queue": len(self.central)})
            self._next_sample += ser.cadence

    # ------------------------------------------------------------------
    def _observe_finish(self, req: Request, t: float):
        if self._watchdog is not None:
            self._watchdog.complete(req.rid)
        self.predictor.observe(req.func_id, req.service)

    def _deliver(self, idx: int, req: Request, t: float,
                 eta: Optional[float] = None):
        self.policy.record(idx)
        if self._warm is not None:
            # coldness is a per-dispatch decision: a re-dispatched
            # request (retry/hedge after an uncharged requeue) must not
            # stack a second inflation on a stale one
            stale = self._cold_extra.pop(req.rid, 0.0)
            if stale:
                req = dataclasses.replace(req,
                                          service=req.service - stale)
            # cold start: extra service demand the moment the request
            # lands on a server whose container for this function is
            # absent or expired (the workload Request is frozen, so the
            # inflation is a replace — _cold_extra undoes it on requeue)
            if self._warm.is_cold(idx, req.func_id, t):
                self._cold_extra[req.rid] = self._cold_pen
                req = dataclasses.replace(
                    req, service=req.service + self._cold_pen)
                if self._trace is not None:
                    self._trace.emit(t, "cold_start", req.rid, idx,
                                     self._cold_pen)
            self._warm.touch(idx, req.func_id, t)
        if self._trace is not None:
            self._trace.emit(t, "dispatch", req.rid, idx, eta)
        if self._watchdog is not None:
            # arm before injecting: a zero-latency instant completion
            # must find the deadline live so complete() can cancel it
            self._watchdog.on_dispatch(req.rid, idx, t, eta)
        srv = self.servers[idx]
        srv.inject(req, t + self.cfg.dispatch_latency_s, eta=eta)
        # process the due events now so the server's capacity/outstanding
        # reflect the delivery before the next dispatch decision (under
        # dispatch latency the arrival itself stays in flight until t +
        # latency — the policy's view is stale by design)
        while srv.next_event_time() <= t:
            srv.step()

    def _drain_pull(self, t: float):
        if not isinstance(self.policy, PullDispatch):
            return
        while self.central:
            idx = self.policy.next_puller()
            if idx is None:
                break
            req, eta = self.central.popleft()
            self._deliver(idx, req, t, eta)

    # -- fleet lifecycle ------------------------------------------------
    def _evict_server(self, idx: int) -> list:
        """Strip server ``idx`` of every request that has not finished
        (in-flight, queued, mid-I/O) and leave it inert: its event heap
        and runnable queues empty, its cores idle, its bookkeeping
        pruned to the finished jobs so ``_result()`` still passes."""
        srv = self.servers[idx]
        done = {rid for rid, j in srv.jobs.items() if j.finish is not None}
        evicted = [r for r in srv.reqs if r.rid not in done]
        srv.events.clear()
        srv.global_queue.clear()
        srv.cfs_rq.clear()
        srv.srtf_wait.clear()
        for c in srv.cores:
            c.token += 1
            c.job, c.state = None, "idle"
        srv.reqs = [r for r in srv.reqs if r.rid in done]
        srv.jobs = {rid: j for rid, j in srv.jobs.items() if rid in done}
        srv.eta_hints.clear()
        return evicted

    def _fail(self, idx: int, t: float):
        """Kill server ``idx`` at ``t`` and re-enter its evicted
        requests through normal dispatch — same orchestration as
        ``ClusterFrontend._fail``, in DES time."""
        self._dead.add(idx)
        if self._warm is not None:
            self._warm.fail(idx)
        tr = self._trace
        if tr is not None:
            tr.emit(t, "fail", -1, idx)
        evicted = self._evict_server(idx)
        if self._active is None:
            self._active = [i for i in range(len(self.servers))
                            if i not in self._dead]
        else:
            self._active = [i for i in self._active if i != idx]
            if not self._active:
                # the last routable server died while live spares sit
                # drained: emergency-activate the lowest-index one so
                # the evicted work (and future arrivals) can route
                spare = min(i for i in range(len(self.servers))
                            if i not in self._dead)
                self._active = [spare]
                if tr is not None:
                    tr.emit(t, "scale", -1, spare, 1)
        self.policy.set_active(self._active)
        wd = self._watchdog
        for req in sorted(evicted, key=lambda r: r.rid):
            if wd is not None:
                wd.disarm(req.rid)
            pen = self._cold_extra.pop(req.rid, 0.0)
            if pen:
                req = dataclasses.replace(req, service=req.service - pen)
            if tr is not None:
                tr.emit(t, "requeue", req.rid, idx)
            self._redispatch(req, t)

    def _maybe_fail(self, idx: int, t: float):
        """A FaultTimeline failure event: skipped when the server is
        already dead (overlapping episodes) or when killing it would
        leave the fleet with no live server to route to."""
        if idx in self._dead or len(self._dead) + 1 >= len(self.servers):
            return
        self._fail(idx, t)

    def _recover(self, idx: int, t: float):
        """A FaultTimeline repair completed: the server re-enters the
        fleet empty and cold (its warm set was dropped at failure).
        Without an autoscaler it rejoins the routable set immediately;
        with one it comes back drained — the next scale-up may re-admit
        it now that it is no longer dead."""
        if idx not in self._dead:
            return                       # never died (failure skipped)
        self._dead.discard(idx)
        if self._trace is not None:
            self._trace.emit(t, "recover", -1, idx)
        if self._scaler is None and self._active is not None:
            self._active = sorted(set(self._active) | {idx})
            self.policy.set_active(self._active)

    def _watchdog_tick(self, t: float):
        """Drain expired deadlines (timeouts + hedges) then released
        backoff holds, in deterministic (time, rid) order — the same
        decision sequence as ``ClusterFrontend._watchdog_tick``, with
        the eviction done against the owning server's event heap."""
        wd = self._watchdog
        tr = self._trace
        for rid, idx, kind in wd.expired(t):
            srv = self.servers[idx]
            req = srv.evict_rid(rid)
            if req is None:              # defensive: state drifted
                continue
            srv.now = max(srv.now, t)
            srv.kick()
            pen = self._cold_extra.pop(rid, 0.0)
            if pen:
                req = dataclasses.replace(req, service=req.service - pen)
            if kind == "hedge":
                # straggler relocation: cancel-and-redispatch once,
                # without burning retry budget
                wd.mark_hedged(rid)
                self.chaos_counts["retry"] += 1
                if tr is not None:
                    tr.emit(t, "retry", rid, idx, 1)
                self._redispatch(req, t)
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
                self._redispatch(req, t)
            else:
                wd.hold(rid, req, release)
        for rid, req in wd.released(t):
            self.chaos_counts["retry"] += 1
            if tr is not None:
                tr.emit(t, "retry", rid, -1)
            self._redispatch(req, t)

    def _redispatch(self, req: Request, t: float):
        """Re-enter a requeued/retried request through normal dispatch."""
        ridx, eta = route_hinted(self.policy, self.predictor, req.rid,
                                 req.func_id, req.service, t)
        self.eta_log[req.rid] = eta
        if self._series is not None:
            self._series.counters["predictor_hits" if eta is not None
                                  else "predictor_misses"] += 1
        if ridx is None:
            self.central.append((req, eta))
        else:
            self._deliver(ridx, req, t, eta)

    def _shed_check(self, req: Request, t: float) -> bool:
        """Admission control: drop a fresh arrival while outstanding
        work per active lane sits at/above the ``shed`` watermark."""
        mark = self._watchdog.shed
        views = (self.views if self._active is None
                 else [self.views[i] for i in self._active])
        load = sum(v.outstanding() for v in views) \
            + len(self.central) + self._watchdog.pending()
        lanes = sum(v.lanes for v in views) or 1
        if load < mark * lanes:
            return False
        self.chaos_counts["shed"] += 1
        self._shed.append(req)
        if self._trace is not None:
            self._trace.emit(t, "shed", req.rid)
        return True

    def _autoscale(self, t: float):
        load = sum(v.outstanding() for v in self.views) + len(self.central)
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
                tr.emit(t, "scale", -1, idx, d)
        self._active = sorted(active)
        self.policy.set_active(self._active)

    def run(self) -> ClusterSimResult:
        tr, ser = self._trace, self._series
        i, n = 0, len(self.reqs)
        while True:
            t_arr = self.reqs[i].arrival if i < n else _INF
            t_srv = min((s.next_event_time() for s in self.servers),
                        default=_INF)
            # a pending backoff hold or armed deadline keeps the loop
            # alive past the last server event — its release re-enters
            # dispatch and creates new work
            t_wd = (self._watchdog.next_boundary()
                    if self._watchdog is not None else None)
            if t_arr == _INF and t_srv == _INF and t_wd is None:
                break
            # lifecycle decisions fire before any arrival or server
            # event at the same instant — the tick backends evaluate
            # them at the top of the tick, before routing
            t_fail = self._fail_at if self._fail_at is not None else _INF
            t_sc = self._next_scale if self._scaler is not None else _INF
            t_tl = (self._timeline.next_time()
                    if self._timeline is not None else None)
            t_life = min(t_fail, t_sc,
                         t_tl if t_tl is not None else _INF,
                         t_wd if t_wd is not None else _INF)
            if t_life <= min(t_arr, t_srv):
                if ser is not None:
                    self._sample_to(t_life)
                if self._timeline is not None:
                    for _, ekind, sidx in self._timeline.due(t_life):
                        if ekind == "recover":
                            self._recover(sidx, t_life)
                        else:
                            self._maybe_fail(sidx, t_life)
                if t_fail <= t_life:
                    self._fail_at = None
                    self._fail(self._fail_server, t_life)
                if self._watchdog is not None:
                    self._watchdog_tick(t_life)
                if self._scaler is not None and t_sc <= t_life:
                    self._autoscale(t_life)
                    self._next_scale += self._scaler.period
                self._drain_pull(t_life)
                continue
            if t_arr <= t_srv and t_arr < _INF:
                req = self.reqs[i]
                i += 1
                if ser is not None:
                    self._sample_to(req.arrival)
                if tr is not None:
                    tr.emit(req.arrival, "arrival", req.rid)
                if (self._watchdog is not None
                        and self._watchdog.shed is not None
                        and self._shed_check(req, req.arrival)):
                    continue
                idx, eta = route_hinted(self.policy, self.predictor,
                                        req.rid, req.func_id, req.service,
                                        req.arrival)
                self.eta_log[req.rid] = eta
                if ser is not None:
                    ser.counters["predictor_hits" if eta is not None
                                 else "predictor_misses"] += 1
                if idx is None:
                    self.central.append((req, eta))
                else:
                    self._deliver(idx, req, req.arrival, eta)
                self._drain_pull(req.arrival)
            elif t_srv < _INF:
                if ser is not None:
                    self._sample_to(t_srv)
                srv = min(self.servers, key=Simulator.next_event_time)
                srv.step()
                self._drain_pull(srv.now)
            else:
                break
        assert not self.central, "central queue not drained at shutdown"
        per_server = [s._result() for s in self.servers]
        return ClusterSimResult(
            merged=_merge_results(per_server),
            per_server=per_server,
            dispatch_counts=list(self.policy.dispatch_counts),
            policy=self.policy.name,
            overload_bypasses=getattr(self.policy, "overload_bypasses", 0),
            predictor=self.predictor.name,
            eta_log=dict(self.eta_log),
            dispatch_S=getattr(self.policy, "S", None),
        )


def _merge_results(results) -> SimResult:
    stats = sorted((s for r in results for s in r.stats),
                   key=lambda s: s.rid)
    qd = sorted((q for r in results for q in r.queue_delay_timeline),
                key=lambda x: x[0])
    if len(results) == 1:
        # single server: keep the (time, S) shape of SimResult
        slice_tl = list(results[0].slice_timeline)
    else:
        # interleave per-server adaptive-S traces by time, tagged with
        # the server index: (time, S, server)
        slice_tl = sorted(((t, s, i) for i, r in enumerate(results)
                           for (t, s) in r.slice_timeline),
                          key=lambda x: (x[0], x[2]))
    return SimResult(
        stats=stats,
        busy_time=sum(r.busy_time for r in results),
        makespan=max((r.makespan for r in results), default=0.0),
        n_ctx_total=sum(r.n_ctx_total for r in results),
        queue_delay_timeline=qd,
        slice_timeline=slice_tl,
    )


def simulate_cluster(requests, cfg: ClusterSimConfig) -> ClusterSimResult:
    """Multi-server run; deterministic given the workload and config."""
    return ClusterSimulator(requests, cfg).run()
