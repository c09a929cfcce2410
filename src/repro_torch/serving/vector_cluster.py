"""Vectorized cluster stepping — homogeneous engine groups as arrays.

A copy of ``repro.serving.vector_cluster`` (the JAX package's module),
``ExperimentSpec(engine="vector")``.  It stays numpy on the host, as
there.  The per-object :class:`~repro_torch.serving.cluster.Cluster`
advances N engines in a lock-step Python loop: every tick pays N
scheduler ``select`` calls, N tick-log appends and O(active)
per-request loops.  This module re-implements the *stepping* — levels
2-1, the per-server FILTER/CFS machinery — as struct-of-arrays state over
whole **homogeneous server groups**, advanced per tick with numpy array
ops:

* lane occupancy        ``filter_rids[G, lanes]`` (row order == the
  object scheduler's ``filter_running`` list order)
* fair-share pools      ``cfs_rows[G, cap]`` + ``pool_pos`` swap-remove
* queue depths          per-engine deques mirrored in ``qlen[G]``
* slice budgets /       per-request columns in
  remaining ticks       :class:`~repro_torch.serving.store._RequestStore`
                        (``slice_left``, ``tokens_done``, ``vruntime``…)

Level 3 (dispatch, predictor, the central pull queue) is untouched: the
shared :class:`~repro_torch.serving.cluster.ClusterFrontend` drives this
backend through the same five hooks as the object cluster, and dispatch
policies observe vector groups through :class:`VectorServerView` — the
same ``ServerView`` protocol, now O(1) array reads.

**Bit-exactness.**  The group step reproduces the object engines'
per-tick semantics operation for operation (FILTER fill with the
``O x S`` bypass, fair-share pick via the schedulers' batched
``pick_active``, displaced-lane accounting, the monotone
``min_vruntime`` recurrence, completion-ordered predictor feedback), so
a ``VectorCluster`` run equals a ``Cluster`` run bit for bit, except
after a failed server recovers: a group's eviction keeps the server's
adaptive slice, arrival window and ``min_vruntime``, where the
per-object eviction builds a fresh scheduler (as in the JAX package).
Heterogeneous stragglers (fifo/srtf schedulers, or sfs/cfs with knobs
the groups do not model) fall back to real ``Engine`` objects, built on
the cluster's ``device``, inside the same cluster.

Not supported on the vector path (submit raises; use ``engine="tick"``
or a straggler's scheduler instead): stall events (§V-D parking) and
real-model decoding — the vector backend is the synthetic scheduling mode only.
"""
from __future__ import annotations

from collections import deque
from time import perf_counter
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.dispatch import (BoundedTimeline, ServerStateColumns,
                                       ServerView)
from repro_torch.core.spec import ServerSpec
from repro_torch.device import resolve_device
from repro_torch.serving.cluster import (ClusterConfig, ClusterFrontend,
                                         EngineView, _evict_engine,
                                         _evict_one)
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request
from repro_torch.serving.schedulers import CFSScheduler
from repro_torch.serving.store import (_SFS_KW, VECTOR_POLICIES,
                                       _RequestStore, _grow)

__all__ = ["VECTOR_POLICIES", "VectorCluster", "VectorServerView"]


class _VectorGroup:
    """G identical engines stepped together as arrays."""

    def __init__(self, members: Sequence[int], lanes: int, n_slots: int,
                 policy: str, sched_kw: dict, store: _RequestStore):
        self.members = list(members)          # global server indices
        self.G = len(self.members)
        self.lanes = lanes
        self.n_slots = n_slots
        self.policy = policy
        self.store = store
        G = self.G
        # -- scheduler knobs (tick-native, as make_scheduler takes them)
        self.fixed_slice = sched_kw.get("slice_ticks")
        slice_init = sched_kw.get("slice_init", 32)
        self.window = int(sched_kw.get("adaptive_window", 100))
        of = sched_kw.get("overload_factor", 3.0)
        self.overload_factor = None if of is None else float(of)
        self.hinted_demotion = bool(sched_kw.get("hinted_demotion", False))
        # -- per-engine state
        init_S = (self.fixed_slice if self.fixed_slice is not None
                  else slice_init)
        self.S = np.full(G, init_S, np.int64)
        self._iats = [deque(maxlen=self.window) for _ in range(G)]
        self._last_arrival = np.full(G, -1, np.int64)
        self._since_update = np.zeros(G, np.int64)
        self.slice_timeline = [BoundedTimeline((0, int(init_S)))
                               for _ in range(G)]
        self.overload_bypasses = np.zeros(G, np.int64)
        self.filter_rids = np.full((G, lanes), -1, np.int64)
        self.filter_count = np.zeros(G, np.int64)
        cap = max(8, lanes)
        self.cfs_rows = np.full((G, cap), -1, np.int64)
        self.cfs_count = np.zeros(G, np.int64)
        self.last_rows = np.full((G, lanes), -1, np.int64)
        self.min_vruntime = np.zeros(G, np.float64)
        self.queue = [deque() for _ in range(G)]
        self.qlen = np.zeros(G, np.int64)
        self.pending = [deque() for _ in range(G)]
        self.pending_len = np.zeros(G, np.int64)
        self.free_slots = np.full(G, n_slots, np.int64)
        self.outstanding = np.zeros(G, np.int64)
        self.lane_busy_ticks = np.zeros(G, np.int64)
        self.n_active = np.zeros(G, np.int64)     # last tick's |chosen|
        # opt-in lifecycle tracing (core/telemetry.py): the cluster sets
        # this; every emission below is guarded so the disabled step
        # stays allocation-free
        self.trace = None

    # -- fair-share pool plumbing --------------------------------------
    def _cfs_add(self, j: int, row: int):
        st = self.store
        c = int(self.cfs_count[j])
        if c == self.cfs_rows.shape[1]:
            self.cfs_rows = _grow(self.cfs_rows, 2 * c, -1)
        self.cfs_rows[j, c] = row
        st.pool_pos[row] = c
        st.in_cfs[row] = True
        self.cfs_count[j] = c + 1

    def _cfs_remove(self, j: int, row: int):
        st = self.store
        p = int(st.pool_pos[row])
        last = int(self.cfs_count[j]) - 1
        moved = self.cfs_rows[j, last]
        self.cfs_rows[j, p] = moved
        st.pool_pos[moved] = p
        self.cfs_rows[j, last] = -1
        st.pool_pos[row] = -1
        st.in_cfs[row] = False
        self.cfs_count[j] = last

    # -- arrivals ------------------------------------------------------
    def _observe_iat(self, j: int, t: int):
        """SFS adaptive slice (paper §V-C), per engine, arrival-driven."""
        if self.fixed_slice is not None:
            return
        if self._last_arrival[j] >= 0:
            self._iats[j].append(t - int(self._last_arrival[j]))
        self._last_arrival[j] = t
        self._since_update[j] += 1
        if (self._since_update[j] >= self.window
                and len(self._iats[j]) == self.window):
            mean_iat = sum(self._iats[j]) / len(self._iats[j])
            self.S[j] = max(1, int(round(mean_iat * self.lanes)))
            self._since_update[j] = 0
            self.slice_timeline[j].append((t, int(self.S[j])))

    def _on_arrival(self, j: int, row: int, t: int):
        st = self.store
        req = st.reqs[row]
        if self.policy == "cfs":
            st.queue_enter[row] = t
            st.vruntime[row] = self.min_vruntime[j]
            self._cfs_add(j, row)
            return
        self._observe_iat(j, t)
        if (self.hinted_demotion and req.eta_hint is not None
                and req.eta_hint > self.S[j]):
            # predicted-long: skip FILTER straight to the fair-share pool
            st.demoted[row] = True
            st.queue_enter[row] = t
            st.vruntime[row] = self.min_vruntime[j]
            self._cfs_add(j, row)
            if self.trace is not None:
                self.trace.emit(t, "demote", req.rid, self.members[j])
            return
        st.queue_enter[row] = t
        self.queue[j].append(row)
        self.qlen[j] += 1

    def submit(self, j: int, req: Request, t: int):
        if req.stall_events:
            raise ValueError(
                "the vector backend does not model stall events on sfs/"
                "cfs groups; use engine='tick'")
        row = self.store.add(req)
        self.outstanding[j] += 1
        if self.free_slots[j] > 0:
            self.free_slots[j] -= 1
            self._on_arrival(j, row, t)
        else:
            self.pending[j].append(row)
            self.pending_len[j] += 1

    def evict(self, j: int) -> list:
        """Server failure: remove every resident
        request of engine ``j`` — queued, slot-pending, FILTER-running
        and fair-share — and reset the engine to empty.  The evicted
        requests' store rows are orphaned (a requeue allocates fresh
        rows on whichever server they land on next); the engine itself
        keeps stepping as a permanent no-op."""
        st = self.store
        rows = [int(r) for r in self.queue[j]]
        self.queue[j].clear()
        self.qlen[j] = 0
        rows += [int(r) for r in self.pending[j]]
        self.pending[j].clear()
        self.pending_len[j] = 0
        frows = self.filter_rids[j, :int(self.filter_count[j])].copy()
        st.in_filter[frows] = False
        self.filter_rids[j] = -1
        self.filter_count[j] = 0
        rows += frows.tolist()
        crows = self.cfs_rows[j, :int(self.cfs_count[j])].copy()
        st.in_cfs[crows] = False
        st.pool_pos[crows] = -1
        self.cfs_rows[j] = -1
        self.cfs_count[j] = 0
        rows += crows.tolist()
        self.last_rows[j] = -1
        self.free_slots[j] = self.n_slots
        self.outstanding[j] = 0
        self.n_active[j] = 0
        return [st.reqs[r] for r in rows]

    def evict_one(self, j: int, rid: int):
        """Chaos eviction (timeout/hedge): remove the
        single resident request ``rid`` from engine ``j`` and return
        its Request, or None when not resident.  The store row is
        orphaned exactly like :meth:`evict`; a slot is freed only when
        the request held one (slot-pending requests never claimed
        theirs)."""
        st = self.store
        for row in self.pending[j]:
            if st.rid[row] == rid:
                self.pending[j].remove(row)
                self.pending_len[j] -= 1
                self.outstanding[j] -= 1
                return st.reqs[int(row)]
        for row in self.queue[j]:
            if st.rid[row] == rid:
                self.queue[j].remove(row)
                self.qlen[j] -= 1
                self.free_slots[j] += 1
                self.outstanding[j] -= 1
                return st.reqs[int(row)]
        fc = int(self.filter_count[j])
        for p in range(fc):
            row = int(self.filter_rids[j, p])
            if st.rid[row] == rid:
                st.in_filter[row] = False
                # stable shift-left: surviving lanes keep their order,
                # same as the end-of-tick lane compaction
                self.filter_rids[j, p:fc - 1] = self.filter_rids[j,
                                                                 p + 1:fc]
                self.filter_rids[j, fc - 1] = -1
                self.filter_count[j] = fc - 1
                self.free_slots[j] += 1
                self.outstanding[j] -= 1
                return st.reqs[row]
        for p in range(int(self.cfs_count[j])):
            row = int(self.cfs_rows[j, p])
            if st.rid[row] == rid:
                self._cfs_remove(j, row)
                lr = self.last_rows[j]
                lr[lr == row] = -1      # no phantom displacement charge
                self.free_slots[j] += 1
                self.outstanding[j] -= 1
                return st.reqs[row]
        return None

    def _admit_pending(self, t: int):
        for j in np.nonzero((self.pending_len > 0) & (self.free_slots > 0)
                            )[0]:
            pen = self.pending[j]
            while self.free_slots[j] > 0 and pen:
                self.free_slots[j] -= 1
                self.pending_len[j] -= 1
                self._on_arrival(j, pen.popleft(), t)

    # -- the per-tick group step ---------------------------------------
    def _fill_filter(self, t: int):
        """FILTER lane fill from the global queue, per engine — the
        object scheduler's pop loop, run only for engines that can
        actually admit (free lane AND queued work)."""
        st = self.store
        L = self.lanes
        for j in np.nonzero((self.filter_count < L) & (self.qlen > 0))[0]:
            q = self.queue[j]
            S = self.S[j]
            while self.filter_count[j] < L and q:
                row = q.popleft()
                self.qlen[j] -= 1
                delay = t - int(st.queue_enter[row])
                st.queue_delay[row] += delay
                if st.first_start[row] < 0:
                    st.first_start[row] = t
                # §V-E transient overload: bypass FILTER, go straight to CFS
                if (self.overload_factor is not None
                        and delay >= self.overload_factor * S):
                    self.overload_bypasses[j] += 1
                    st.demoted[row] = True
                    st.vruntime[row] = self.min_vruntime[j]
                    self._cfs_add(j, row)
                    if self.trace is not None:
                        self.trace.emit(t, "bypass", int(st.rid[row]),
                                        self.members[j])
                    continue
                if not st.slice_set[row] or st.slice_left[row] <= 0:
                    st.slice_left[row] = S
                    st.slice_set[row] = True
                self.filter_rids[j, self.filter_count[j]] = row
                self.filter_count[j] += 1
                st.in_filter[row] = True
                if self.trace is not None:
                    self.trace.emit(t, "admit", int(st.rid[row]),
                                    self.members[j])

    def _cfs_select(self, t: int, free: np.ndarray):
        """Batched fair-share pick across the group (CFS semantics:
        the ``free[g]`` smallest ``(vruntime, rid)`` per engine), plus
        the start/displacement accounting ``select`` performs."""
        st = self.store
        G = self.G
        sel = (free > 0) & (self.cfs_count > 0)
        if not sel.any():
            return (np.empty(0, np.int64),) * 3
        eng, pos = np.nonzero(sel[:, None] & (self.cfs_rows >= 0))
        rows = self.cfs_rows[eng, pos]
        order, ch = CFSScheduler.pick_active(
            eng, st.vruntime[rows], st.rid[rows], free, G)
        chosen_rows = rows[order][ch]
        chosen_eng = eng[order][ch]
        # rank of each chosen request within its engine's pick (0-based)
        k = np.bincount(chosen_eng, minlength=G)
        starts = np.concatenate(([0], np.cumsum(k[:-1])))
        chosen_rank = np.arange(chosen_rows.size) - starts[chosen_eng]
        # first-start / queue-delay accounting for newly started work
        new = st.first_start[chosen_rows] < 0
        nrows = chosen_rows[new]
        st.first_start[nrows] = t
        st.queue_delay[nrows] += t - st.queue_enter[nrows]
        # context-switch accounting: ran last pick, displaced this pick,
        # still runnable (st.mark is persistent scratch — set, gather,
        # clear by index, O(active) instead of O(store) per tick)
        st.mark[chosen_rows] = True
        le, lp = np.nonzero(sel[:, None] & (self.last_rows >= 0))
        lrows = self.last_rows[le, lp]
        dmask = ~st.mark[lrows] & st.in_cfs[lrows]
        disp = lrows[dmask]
        st.n_ctx[disp] += 1
        if self.trace is not None and disp.size:
            # engine index for each displaced row, gathered only when
            # tracing: the disabled hot loop stays allocation-free
            self.trace.emit_rows(
                t, "preempt",
                zip(st.rid[disp].tolist(),
                    (np.asarray(self.members)[le[dmask]]).tolist()))
        st.mark[chosen_rows] = False
        # _last := chosen (only for engines whose select ran)
        self.last_rows[sel] = -1
        self.last_rows[chosen_eng, chosen_rank] = chosen_rows
        return chosen_rows, chosen_eng, chosen_rank

    def tick(self, t: int):
        """Advance every engine in the group one tick.  Returns finish
        events as ``(global_server_idx, within-engine order, Request)``
        so the cluster can replay predictor feedback in exact
        object-cluster order."""
        st = self.store
        G, L = self.G, self.lanes
        self._admit_pending(t)
        if self.policy == "sfs":
            self._fill_filter(t)
            free = L - self.filter_count
            fe, fp = np.nonzero(self.filter_rids >= 0)
            frows = self.filter_rids[fe, fp]
        else:
            free = np.full(G, L, np.int64)
            fe = fp = frows = np.empty(0, np.int64)
        chosen_rows, chosen_eng, chosen_rank = self._cfs_select(t, free)

        self.n_active = self.filter_count + np.bincount(chosen_eng,
                                                        minlength=G)
        if frows.size == 0 and chosen_rows.size == 0:
            return []                      # whole group idle this tick

        # -- run: prefill on first touch, decode afterwards ------------
        all_rows = np.concatenate([frows, chosen_rows])
        pf = st.prefill_done[all_rows]
        st.tokens_done[all_rows[pf]] += 1
        st.prefill_done[all_rows[~pf]] = True
        st.served[all_rows] += 1
        self.lane_busy_ticks += self.n_active

        events = []

        # -- FILTER end-of-tick: finish / slice expiry -----------------
        if frows.size:
            st.slice_left[frows] -= 1
            done_f = st.tokens_done[frows] >= st.n_tokens[frows]
            exp_f = ~done_f & (st.slice_left[frows] <= 0)
            fin_rows, fin_eng, fin_lane = (frows[done_f], fe[done_f],
                                           fp[done_f])
            if fin_rows.size:
                st.finish[fin_rows] = t + 1
                st.in_filter[fin_rows] = False
                np.add.at(self.free_slots, fin_eng, 1)
                np.add.at(self.outstanding, fin_eng, -1)
                tr = self.trace
                for g, lane, row in zip(fin_eng, fin_lane, fin_rows):
                    req = st.write_back(int(row))
                    if tr is not None:
                        tr.emit(t + 1, "complete", req.rid, self.members[g])
                    events.append((self.members[g], int(lane), req))
            drows = frows[exp_f]
            if drows.size:                 # demote to the fair-share pool
                deng = fe[exp_f]
                st.in_filter[drows] = False
                st.n_ctx[drows] += 1
                st.demoted[drows] = True
                st.vruntime[drows] = self.min_vruntime[deng]
                tr = self.trace
                for g, row in zip(deng, drows):
                    self._cfs_add(int(g), int(row))
                    if tr is not None:
                        tr.emit(t, "demote", int(st.rid[row]),
                                self.members[g])
            rem = done_f | exp_f
            if rem.any():                  # stable lane compaction
                self.filter_rids[fe[rem], fp[rem]] = -1
                self.filter_rids = np.take_along_axis(
                    self.filter_rids,
                    np.argsort(self.filter_rids < 0, axis=1, kind="stable"),
                    axis=1)
                self.filter_count -= np.bincount(fe[rem], minlength=G)

        # -- fair-share end-of-tick: charge, finish, min_vruntime ------
        if chosen_rows.size:
            st.vruntime[chosen_rows] += 1.0
            done_c = st.tokens_done[chosen_rows] >= st.n_tokens[chosen_rows]
            fin_rows = chosen_rows[done_c]
            fin_eng = chosen_eng[done_c]
            if fin_rows.size:
                st.finish[fin_rows] = t + 1
                np.add.at(self.free_slots, fin_eng, 1)
                np.add.at(self.outstanding, fin_eng, -1)
                tr = self.trace
                for g, rk, row in zip(fin_eng, chosen_rank[done_c],
                                      fin_rows):
                    self._cfs_remove(int(g), int(row))
                    req = st.write_back(int(row))
                    if tr is not None:
                        tr.emit(t + 1, "complete", req.rid, self.members[g])
                    events.append((self.members[g], L + int(rk), req))
            # min_vruntime: the object recurrence max(m0, min_i) over the
            # per-request updates is monotone, so it collapses to the min
            # over the end state — the surviving pool plus, if the LAST
            # pick of an engine finished, that request (it is discarded
            # only after the final min is taken)
            upd = np.nonzero(np.bincount(chosen_eng, minlength=G) > 0)[0]
            pool = self.cfs_rows[upd]
            pool_vr = np.where(pool >= 0,
                               st.vruntime[np.maximum(pool, 0)], np.inf)
            m = pool_vr.min(axis=1) if pool.shape[1] else \
                np.full(upd.size, np.inf)
            last_idx = np.searchsorted(chosen_eng, upd, side="right") - 1
            last_fin = done_c[last_idx]
            m = np.where(last_fin,
                         np.minimum(m, st.vruntime[chosen_rows[last_idx]]),
                         m)
            self.min_vruntime[upd] = np.where(
                np.isfinite(m),
                np.maximum(self.min_vruntime[upd], m),
                self.min_vruntime[upd])
        return events


class VectorServerView(ServerView):
    """Dispatch-visible state of one engine inside a vector group —
    the ``ServerView`` protocol as O(1) array reads."""

    def __init__(self, group: _VectorGroup, j: int):
        self.group = group
        self.j = j

    @property
    def lanes(self) -> int:
        return self.group.lanes

    def outstanding(self) -> int:
        return int(self.group.outstanding[self.j])

    def filter_free(self) -> int:
        g, j = self.group, self.j
        if g.policy == "sfs":
            active = int(g.filter_count[j])
        else:
            active = min(g.lanes, int(g.cfs_count[j]))
        return max(0, g.lanes - active - self.queue_len())

    def fair_load(self) -> int:
        return int(self.group.cfs_count[self.j])

    def queue_len(self) -> int:
        return (int(self.group.qlen[self.j])
                if self.group.policy == "sfs" else 0)

    def capacity(self) -> int:
        g, j = self.group, self.j
        slots = int(g.free_slots[j]) - int(g.pending_len[j])
        lanes = g.lanes - int(g.outstanding[j])   # no stalls on this path
        return max(0, min(slots, lanes))


class _VectorColumns(ServerStateColumns):
    """Dispatch state columns bulk-loaded straight from group arrays —
    a full refresh is a few fancy-index scatters per group instead of
    5 x M Python method calls."""

    def __init__(self, views, groups, stragglers):
        super().__init__(views)
        self._groups = [(g, np.asarray(g.members, np.int64))
                        for g in groups]
        self._stragglers = stragglers

    def _pull_all(self):
        for g, m in self._groups:
            self.outstanding[m] = g.outstanding
            self.fair_load[m] = g.cfs_count
            if g.policy == "sfs":
                self.queue_len[m] = g.qlen
                self.filter_free[m] = np.maximum(
                    0, g.lanes - g.filter_count - g.qlen)
            else:
                self.queue_len[m] = 0
                self.filter_free[m] = np.maximum(
                    0, g.lanes - np.minimum(g.lanes, g.cfs_count))
            self.capacity[m] = np.maximum(
                0, np.minimum(g.free_slots - g.pending_len,
                              g.lanes - g.outstanding))
        for i in self._stragglers:
            self._pull(i)


class VectorCluster(ClusterFrontend):
    """N servers behind one dispatch policy; homogeneous groups step as
    arrays, stragglers as per-object engines — same frontend, same
    results, fleet-scale tick rate."""

    def __init__(self, servers: Sequence, cfg: Optional[ClusterConfig]
                 = None, *, device="cuda"):
        self.device = resolve_device(device)
        specs = [s if isinstance(s, ServerSpec) else ServerSpec.parse(s)
                 for s in servers]
        self.store = _RequestStore()
        self.groups: list[_VectorGroup] = []
        self.stragglers: dict[int, Engine] = {}  # straggler idx -> Engine
        self._backend: list = [None] * len(specs)  # idx -> (group, j) | Engine
        by_key: dict = {}
        for i, s in enumerate(specs):
            ec = s.to_engine_config()
            ok = (ec.policy in VECTOR_POLICIES
                  and (set(ec.sched_kw) <= _SFS_KW if ec.policy == "sfs"
                       else not ec.sched_kw))
            if not ok:
                self.stragglers[i] = Engine(ec, device=self.device)
                continue
            key = (ec.lanes, ec.n_slots, ec.policy,
                   tuple(sorted(ec.sched_kw.items())))
            by_key.setdefault(key, []).append(i)
        for (lanes, n_slots, policy, kw), members in by_key.items():
            group = _VectorGroup(members, lanes, n_slots, policy,
                                 dict(kw), self.store)
            self.groups.append(group)
            for j, idx in enumerate(members):
                self._backend[idx] = (group, j)
        views = []
        for i in range(len(specs)):
            b = self._backend[i]
            views.append(EngineView(self.stragglers[i]) if b is None
                         else VectorServerView(b[0], b[1]))
        super().__init__(views, cfg)
        self._cols = _VectorColumns(views, self.groups, self.stragglers)
        self.policy.columns = self._cols
        self._done: list[Request] = []
        for idx, e in self.stragglers.items():
            e.on_finish = self._make_straggler_callback(idx)
        self._straggler_obs: list = []

    def _make_straggler_callback(self, idx: int):
        def cb(req: Request, t: int):
            self._straggler_obs.append((idx, len(self._straggler_obs), req))
        return cb

    # -- backend hooks -------------------------------------------------
    def _bind_backend(self, tel):
        if tel.trace is not None:
            for g in self.groups:
                g.trace = tel.trace
            for idx, e in self.stragglers.items():
                e.scheduler.bind_trace(tel.trace, idx)

    def _submit(self, idx: int, req: Request):
        b = self._backend[idx]
        if b is None:
            self.stragglers[idx].submit(req, getattr(req, "_prompt", None))
        else:
            group, j = b
            group.submit(j, req, self.t)
        self._cols.mark(idx)

    def _evict_server(self, idx: int) -> list:
        b = self._backend[idx]
        if b is None:
            evicted = _evict_engine(self.stragglers[idx], self._trace, idx)
        else:
            group, j = b
            evicted = group.evict(j)
        self._cols.mark(idx)
        return evicted

    def _evict_request(self, idx: int, rid: int):
        b = self._backend[idx]
        if b is None:
            req = _evict_one(self.stragglers[idx], rid)
        else:
            group, j = b
            req = group.evict_one(j, rid)
        if req is not None:
            self._cols.mark(idx)
        return req

    def _step(self):
        prof = self._prof
        t0 = perf_counter() if prof is not None else 0.0
        events = []
        self._straggler_obs = []
        for idx, e in self.stragglers.items():
            e.tick(())
        events.extend(self._straggler_obs)
        for group in self.groups:
            events.extend(group.tick(self.t))
        if prof is not None:
            prof.add("group_step", perf_counter() - t0)
            t0 = perf_counter()
        # replay completions in object-cluster order: server index
        # ascending, then each engine's chosen order — so learned
        # predictors see the exact same observation stream
        events.sort(key=lambda ev: (ev[0], ev[1]))
        for idx, _, req in events:
            if self._backend[idx] is not None:
                self._done.append(req)
            self._observe_finish(req, self.t + 1)
        self._cols.mark_all()
        if prof is not None:
            prof.add("replay", perf_counter() - t0)

    def _active_counts(self) -> tuple:
        counts = [0] * self.n_servers
        for idx, e in self.stragglers.items():
            counts[idx] = e.tick_log[-1][1]
        for group in self.groups:
            for j, idx in enumerate(group.members):
                counts[idx] = int(group.n_active[j])
        return tuple(counts)

    def _finished_count(self) -> int:
        return len(self._done) + sum(len(e.finished)
                                     for e in self.stragglers.values())

    def _collect(self) -> list:
        return self._done + [r for e in self.stragglers.values()
                             for r in e.finished]

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        out = super().summary()
        out["backend"] = "vector"
        out["groups"] = [{"members": g.members, "lanes": g.lanes,
                          "policy": g.policy} for g in self.groups]
        out["stragglers"] = sorted(self.stragglers)
        out["engine_overload_bypasses"] = int(
            sum(int(g.overload_bypasses.sum()) for g in self.groups)
            + sum(getattr(e.scheduler, "overload_bypasses", 0)
                  for e in self.stragglers.values()))
        return out
