"""Cluster-level dispatch policies — the third scheduling level.

A copy of ``repro.core.dispatch`` (the JAX package's module); the
dispatch registry's provider is this module, so a lookup never imports
the JAX package.

The paper fixes *per-server* scheduling (FILTER lanes over a fair-share
pool); at production scale the layer above — which server an invocation
lands on — dominates tail latency (Kaffes et al., "Practical Scheduling
for Real-World Serverless Computing"; Hiku, "Pull-Based Scheduling for
Serverless Computing").  This module implements that layer once, shared
by the tick-engine cluster (``repro_torch.serving.cluster``) and the
discrete-event multi-server simulator (``repro.core.simulator``), so the
two execution models can be cross-validated policy-for-policy.

Policies (``make_dispatch``):

  hash               — salted-hash power-of-two-choices over outstanding
                       work (the pre-cluster ``Router`` behaviour; the
                       serving Cluster batch-routes each tick's arrivals
                       against pre-delivery state to keep legacy parity).
  least-outstanding  — global argmin of outstanding work.
  pull               — push nothing: arrivals wait in a central queue and
                       idle servers pull (worker-initiated dispatch, per
                       Hiku).  ``route`` returns None; the owner drains
                       the queue via ``next_puller``.
  sfs-aware          — generalizes the paper's two-level idea up one
                       level: short-ETA requests go to the server with
                       the most idle FILTER lanes, long requests to the
                       server already carrying the largest fair-share
                       pool (concentrating long work keeps the other
                       servers FILTER-rich).  A cluster-level adaptive
                       slice S = mean-IAT x total-lanes and a transient-
                       overload bypass (estimated wait >= O x S falls
                       back to least-outstanding) mirror the per-server
                       ``O x S`` rule of §V-C/E.

Every policy sees servers through the tiny ``ServerView`` interface, so
it never touches engine or simulator internals.
"""
from __future__ import annotations

import hashlib
from collections import deque
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.spec import DISPATCH_REGISTRY, DispatchSpec

# field width for packing lexicographic routing keys into one int64
# argmin; per-server counters are bounded by requests in flight, so the
# max-check guards only pathological configurations
_PACK = 1 << 21


class BoundedTimeline:
    """Append-only ``(t, S)`` adaptive-slice trace with a hard length cap.

    ``slice_timeline`` used to be a plain list growing one entry per
    adaptive window forever — unbounded memory on million-request runs.
    This keeps appends O(1) amortized and, when the cap is reached,
    decimates in place: every second interior entry is dropped (the first
    and the most recent survive), halving time resolution instead of
    growing.  The Fig. 10 shape is preserved at any cap >= 4.
    """

    __slots__ = ("_data", "cap")

    def __init__(self, *entries, cap: int = 4096):
        self.cap = max(int(cap), 4)
        self._data = list(entries)

    def append(self, entry) -> None:
        if len(self._data) >= self.cap:
            self._data = self._data[:-1:2] + [self._data[-1]]
        self._data.append(entry)

    def __len__(self):
        return len(self._data)

    def __getitem__(self, i):
        return self._data[i]

    def __iter__(self):
        return iter(self._data)

    def __eq__(self, other):
        return self._data == list(other)

    def __repr__(self):
        return f"BoundedTimeline({self._data!r}, cap={self.cap})"


class ServerView:
    """Scheduling-state view of one server, as the dispatcher sees it.

    ``lanes`` is the server's parallelism (decode lanes / cores).  Units
    of ``current_slice`` follow the owner (engine ticks vs seconds);
    dispatch only ever compares them against same-unit IATs.
    """

    lanes: int = 1

    def outstanding(self) -> int:
        """Admitted but unfinished requests."""
        raise NotImplementedError

    def filter_free(self) -> int:
        """Idle FILTER lanes (capacity for short work right now)."""
        raise NotImplementedError

    def fair_load(self) -> int:
        """Size of the fair-share (CFS) pool — demoted/long work."""
        raise NotImplementedError

    def queue_len(self) -> int:
        """Length of the server's global FILTER queue."""
        raise NotImplementedError

    def capacity(self) -> int:
        """Requests this server could start this instant (pull mode)."""
        raise NotImplementedError


class ServerStateColumns:
    """Batched ServerView: the per-server state as columns over the whole
    cluster, refreshed lazily from the views.

    At fleet scale the per-arrival Python ``min(..., key=...)`` scans over
    M views dominate routing cost (M method calls and tuple allocations
    per arrival).  Owners that keep server state in arrays (the vector
    cluster backend) bind one of these to ``policy.columns``; policies
    then route via numpy ordering ops with **identical tie-breaking**
    (np.lexsort/argmin are stable, so full-key ties fall back to the
    server index, exactly like the tuple keys).

    The owner marks servers dirty as their state changes — ``mark(idx)``
    after a delivery, ``mark_all()`` after a cluster step — and
    ``refresh()`` re-pulls only what changed.  Subclasses can override
    ``_pull_all`` to bulk-load from backend arrays instead of per-view
    method calls.
    """

    def __init__(self, views: Sequence["ServerView"]):
        self.views = list(views)
        n = len(self.views)
        self.lanes = np.array([v.lanes for v in self.views], np.int64)
        self.outstanding = np.zeros(n, np.int64)
        self.filter_free = np.zeros(n, np.int64)
        self.queue_len = np.zeros(n, np.int64)
        self.fair_load = np.zeros(n, np.int64)
        self.capacity = np.zeros(n, np.int64)
        self._dirty: set = set()
        self._all_dirty = True
        # what the last refresh() re-pulled: None = everything, a tuple
        # of indices, or () for a no-op — lets policies keep derived
        # per-server data (packed routing keys) incrementally current
        self.last_changed: Optional[tuple] = None

    def mark(self, idx: int):
        self._dirty.add(idx)

    def mark_all(self):
        self._all_dirty = True

    def _pull(self, i: int):
        v = self.views[i]
        self.outstanding[i] = v.outstanding()
        self.filter_free[i] = v.filter_free()
        self.queue_len[i] = v.queue_len()
        self.fair_load[i] = v.fair_load()
        self.capacity[i] = v.capacity()

    def _pull_all(self):
        for i in range(len(self.views)):
            self._pull(i)

    def refresh(self) -> "ServerStateColumns":
        if self._all_dirty:
            self._pull_all()
            self._all_dirty = False
            self._dirty.clear()
            self.last_changed = None
        elif self._dirty:
            self.last_changed = tuple(self._dirty)
            for i in self._dirty:
                self._pull(i)
            self._dirty.clear()
        else:
            self.last_changed = ()
        return self


class DispatchPolicy:
    name = "base"

    def __init__(self, views: Sequence[ServerView]):
        self.views = list(views)
        self.dispatch_counts = [0] * len(self.views)
        # optional batched state (ServerStateColumns) bound by owners
        # whose servers live in arrays; None = per-view Python path
        self.columns: Optional[ServerStateColumns] = None
        # routable-membership mask set by lifecycle-aware owners
        # (autoscaling / failure, docs/CLUSTER.md); None = all servers,
        # which keeps the legacy fast paths bit-exact
        self.active: Optional[tuple] = None
        self._active_set: Optional[frozenset] = None

    def set_active(self, active):
        """Restrict routing to these server indices (any iterable;
        stored sorted), or None to lift the restriction.  Masked
        routing always takes the per-view path so every backend makes
        the identical pick regardless of whether columns are bound."""
        if active is None:
            self.active = self._active_set = None
        else:
            self.active = tuple(sorted(active))
            if not self.active:
                raise ValueError("active server set must not be empty")
            self._active_set = frozenset(self.active)

    def route(self, rid: int, eta: Optional[float],
              t: float) -> Optional[int]:
        """Pick a server for request ``rid`` arriving at ``t``.

        ``eta`` is the front-end's service-demand estimate (e.g. from a
        max-tokens cap or a duration predictor), None when unknown.
        Returns a server index, or None to hold the request in the
        owner's central queue (pull mode).
        """
        raise NotImplementedError

    def record(self, idx: int):
        self.dispatch_counts[idx] += 1

    def _least_outstanding(self) -> int:
        if self.active is not None:
            return min(self.active,
                       key=lambda i: (self.views[i].outstanding(), i))
        if self.columns is not None:
            # np.argmin returns the first minimum: ties break on index,
            # same as the tuple key below
            return int(np.argmin(self.columns.refresh().outstanding))
        return min(range(len(self.views)),
                   key=lambda i: (self.views[i].outstanding(), i))


def _hash(rid: int, salt: int) -> int:
    h = hashlib.blake2s(f"{rid}:{salt}".encode(), digest_size=4)
    return int.from_bytes(h.digest(), "little")


@DISPATCH_REGISTRY.register("hash")
class HashDispatch(DispatchPolicy):
    """Power-of-two-choices over consistent hashing (legacy Router)."""
    name = "hash"

    def route(self, rid, eta, t):
        act = self.active
        if act is not None:
            # two hashed choices over the *active* membership: the salted
            # hashes index positions in the sorted active tuple, so a
            # shrink/grow re-spreads load over exactly the live servers
            n = len(act)
            if n == 1:
                return act[0]
            a = act[_hash(rid, 1) % n]
            b = act[_hash(rid, 2) % n]
            if b == a:
                b = act[(act.index(a) + 1) % n]
            return a if (self.views[a].outstanding()
                         <= self.views[b].outstanding()) else b
        n = len(self.views)
        if n == 1:
            return 0
        a = _hash(rid, 1) % n
        b = _hash(rid, 2) % n
        if b == a:
            b = (a + 1) % n
        if self.columns is not None:
            out = self.columns.refresh().outstanding
            return a if out[a] <= out[b] else b
        return a if (self.views[a].outstanding()
                     <= self.views[b].outstanding()) else b


@DISPATCH_REGISTRY.register("least-outstanding")
class LeastOutstandingDispatch(DispatchPolicy):
    name = "least-outstanding"

    def route(self, rid, eta, t):
        return self._least_outstanding()


@DISPATCH_REGISTRY.register("pull")
class PullDispatch(DispatchPolicy):
    """Worker-initiated dispatch: arrivals stay central, idle servers pull.

    ``route`` never places a request; the owner calls ``next_puller``
    whenever the central queue is non-empty and delivers to the returned
    server.  A rotating scan start keeps ties fair across servers.
    """
    name = "pull"

    def __init__(self, views):
        super().__init__(views)
        self._rr = 0

    def route(self, rid, eta, t):
        return None

    def next_puller(self) -> Optional[int]:
        n = len(self.views)
        if self._active_set is not None:
            live = self._active_set
            for k in range(n):
                i = (self._rr + k) % n
                if i in live and self.views[i].capacity() > 0:
                    self._rr = (i + 1) % n
                    return i
            return None
        if self.columns is not None:
            # first server with capacity at/after the scan start,
            # wrapping — the same rotating scan, one vector op
            idxs = np.nonzero(self.columns.refresh().capacity > 0)[0]
            if idxs.size == 0:
                return None
            i = int(idxs[np.searchsorted(idxs, self._rr) % idxs.size])
            self._rr = (i + 1) % n
            return i
        for k in range(n):
            i = (self._rr + k) % n
            if self.views[i].capacity() > 0:
                self._rr = (i + 1) % n
                return i
        return None


@DISPATCH_REGISTRY.register("sfs-aware")
class SFSAwareDispatch(DispatchPolicy):
    """Three-level SFS: route by ETA class, bypass under overload.

    Short requests (eta <= S, or unknown — same optimism as FILTER's
    run-first-demote-later) prefer the server with the most idle FILTER
    lanes; long requests prefer the server whose outstanding work is
    already mostly fair-share (min outstanding - fair_load), which
    concentrates long work and keeps the remaining servers FILTER-rich.
    If the preferred server's estimated FILTER wait (queue_len x S /
    lanes) reaches O x S, the preference is bypassed for plain
    least-outstanding — the cluster analogue of §V-E.
    """
    name = "sfs-aware"

    def __init__(self, views, *, overload_factor: float = 3.0,
                 adaptive_window: int = 100, slice_init: float = 32.0):
        super().__init__(views)
        self.total_lanes = sum(v.lanes for v in self.views)
        self.overload_factor = overload_factor
        self.window = adaptive_window
        self.S = slice_init
        self._iats: deque = deque(maxlen=adaptive_window)
        self._last_arrival: Optional[float] = None
        self._since_update = 0
        self.slice_timeline = BoundedTimeline((0.0, self.S))
        self.overload_bypasses = 0
        self._keys = None          # cached packed argmin keys
        self._pack_ok = True

    def _observe(self, t: float):
        if self._last_arrival is not None:
            self._iats.append(t - self._last_arrival)
        self._last_arrival = t
        self._since_update += 1
        if (self._since_update >= self.window
                and len(self._iats) == self.window):
            mean_iat = sum(self._iats) / len(self._iats)
            self.S = max(mean_iat * self.total_lanes, 1e-9)
            self._since_update = 0
            self.slice_timeline.append((t, self.S))

    def _refresh_keys(self, c):
        """Packed int64 routing keys over freshly-refreshed columns.

        The lexicographic tuple mins become single ``np.argmin`` calls:
        each field is bounded by requests in flight per server — far
        below the 2^21 field width — and argmin's first-minimum rule
        reproduces the stable lexsort's index tie-break exactly.  Keys
        are rebuilt only for the rows ``columns.last_changed`` reports
        (one delivery between consecutive arrivals is the common case),
        so a route costs one argmin, not a lexsort, per arrival.
        Returns None when a counter outgrew its field (pathological
        config) — callers then fall back to np.lexsort.
        """
        ch = c.last_changed
        if self._keys is None or ch is None:
            self._pack_ok = bool(
                c.queue_len.max(initial=0) < _PACK
                and c.outstanding.max(initial=0) < _PACK
                and c.filter_free.max(initial=0) < _PACK)
            if not self._pack_ok:
                self._keys = None
                return None
            self._keys = (
                (-c.filter_free << 42) + (c.queue_len << 21)
                + c.outstanding,
                # (outstanding - fair_load) may touch 0; the int64
                # multiply keeps the order exact either way
                (c.outstanding - c.fair_load) * (1 << 21) + c.outstanding)
        elif not self._pack_ok:
            return None
        else:
            ks, kl = self._keys
            for i in ch:
                out = int(c.outstanding[i])
                ql = int(c.queue_len[i])
                ff = int(c.filter_free[i])
                if out >= _PACK or ql >= _PACK or ff >= _PACK:
                    self._pack_ok = False
                    self._keys = None
                    return None
                ks[i] = (-ff << 42) + (ql << 21) + out
                kl[i] = (out - int(c.fair_load[i])) * (1 << 21) + out
        return self._keys

    def route(self, rid, eta, t):
        self._observe(t)
        short = eta is None or eta <= self.S
        act = self.active
        if act is not None:
            # masked routing: the same lexicographic keys, per-view, over
            # the live membership only (S still adapts on every arrival)
            if short:
                best = min(act,
                           key=lambda i: (-self.views[i].filter_free(),
                                          self.views[i].queue_len(),
                                          self.views[i].outstanding(), i))
                v = self.views[best]
                ff, ql, lanes = v.filter_free(), v.queue_len(), v.lanes
                est_wait = ql * self.S / max(lanes, 1)
                if ff == 0 and est_wait >= self.overload_factor * self.S:
                    self.overload_bypasses += 1
                    return self._least_outstanding()
                return best
            return min(act,
                       key=lambda i: (self.views[i].outstanding()
                                      - self.views[i].fair_load(),
                                      self.views[i].outstanding(), i))
        c = self.columns.refresh() if self.columns is not None else None
        if short:
            # idle FILTER lanes first; under saturation the FILTER queue
            # length is the wait a short request actually sees (longs by
            # then live in the fair-share pool), so prefer the shortest —
            # NOT least-outstanding, which undercounts work on servers
            # that concentrate long requests.
            if c is not None:
                ks = self._refresh_keys(c)
                if ks is not None:
                    best = int(ks[0].argmin())
                else:
                    best = int(np.lexsort((c.outstanding, c.queue_len,
                                           -c.filter_free))[0])
                ff, ql = int(c.filter_free[best]), int(c.queue_len[best])
                lanes = int(c.lanes[best])
            else:
                best = min(range(len(self.views)),
                           key=lambda i: (-self.views[i].filter_free(),
                                          self.views[i].queue_len(),
                                          self.views[i].outstanding(), i))
                v = self.views[best]
                ff, ql, lanes = v.filter_free(), v.queue_len(), v.lanes
            est_wait = ql * self.S / max(lanes, 1)
            if ff == 0 and est_wait >= self.overload_factor * self.S:
                self.overload_bypasses += 1
                return self._least_outstanding()
            return best
        # long: fewest FILTER-bound requests = outstanding - fair pool
        if c is not None:
            ks = self._refresh_keys(c)
            if ks is not None:
                return int(ks[1].argmin())
            return int(np.lexsort((c.outstanding,
                                   c.outstanding - c.fair_load))[0])
        return min(range(len(self.views)),
                   key=lambda i: (self.views[i].outstanding()
                                  - self.views[i].fair_load(),
                                  self.views[i].outstanding(), i))


POLICIES = tuple(DISPATCH_REGISTRY)


def route_hinted(policy: DispatchPolicy, predictor, rid: int, func_id,
                 true_eta: Optional[float], t: float):
    """The single predictor->dispatch entry point, shared by the
    tick-engine ``Cluster`` and the DES ``ClusterSimulator`` (no
    engine-specific predictor code paths).

    ``predictor`` is a :class:`repro_torch.core.predict.EtaPredictor`;
    ``true_eta`` is the ground-truth demand known to the owner (consumed
    only by the oracle — learned predictors see ``func_id`` alone).
    Returns ``(server index or None, eta used for routing)`` so owners
    can log the estimate against the eventual true duration.
    """
    eta = predictor.estimate(func_id, true_eta)
    return policy.route(rid, eta, t), eta


def make_dispatch(policy, views: Sequence[ServerView],
                  **kw) -> DispatchPolicy:
    """Build a dispatch policy from a name, a ``"name:k=v"`` string, or a
    :class:`~repro_torch.core.spec.DispatchSpec` (registry-backed).  Explicit
    ``kw`` overrides spec args."""
    spec = DispatchSpec.parse(policy)
    return DISPATCH_REGISTRY.get(spec.name)(views, **{**spec.kwargs, **kw})
