"""Fleet stepping on the device — homogeneous engine groups as int32
tensor programs (``ExperimentSpec(engine="torch")``).

The counterpart of ``repro.serving.jax_cluster`` (the JAX package's
module), bit for bit.  Each homogeneous group of engines advances one tick
as one tensor program over its whole group — the FILTER lanes and the
fair-share (CFS) pool of every engine at once — with two multi-tick fast
paths driven by the host:

* **closed-form gap advance** — when no event can occur before the next
  arrival or completion (lanes full or queue empty per engine, and each
  fair-share pool either fits its free lanes or cannot run), ``g`` ticks
  collapse into one update: ``served/slice_left/vruntime += g`` plus the
  monotone ``min_vruntime`` recurrence, which telescopes to a max against
  the final pool minimum.
* **64-tick chunks** — arrival-free windows where the pool rotates
  (``pool > free lanes``) step ``_SCAN_CHUNK`` ticks in a Python loop with
  no host sync inside; the per-tick outputs are stacked and pulled once.
  A completion burst past the chunk's event buffer rolls the chunk back
  (the tick body never writes its inputs, so the pre-chunk state is
  intact) and replays it tick by tick.

All device state is int32.  Per-request state travels *with* the request
through region tensors (queue ring -> FILTER lanes -> fair-share pool);
completions emit the full field tuple, so the host keeps no per-request
device columns.  The inner fair-share pick (per-group k-smallest
``(vruntime, rid)``) goes through
:func:`repro_torch.kernels.group_pick.pick_order`: the hand-written CUDA
kernel for a tensor on the card, its plain version on the CPU.

Where JAX and PyTorch differ, the tick body does this:

* JAX scatters with ``mode="drop"`` and an out-of-range sink index
  (``G``, ``CAP``, ``L`` or ``evcap``).  Here every region a scatter
  writes gets one sink row or column, and the sink is sliced off; the
  scatter-adds become ``index_put_(..., accumulate=True)``.
* The pick's tail columns may hold ``CAP`` (see
  ``kernels/group_pick/ref.py``); the gather of the chosen pool rows
  clamps them (those columns are masked out by ``ch``).
* ``torch.argmax`` takes no bool, so the first-match search casts first.
* Every cumsum and sum names ``dtype=torch.int32`` (torch widens to
  int64 otherwise).
* One device->host copy per tick carries both the scalars and the host
  mirrors; the events are copied only when there are any.

Level 3 (dispatch, predictors, the central pull queue, lifecycle and
chaos decisions) is the shared
:class:`~repro_torch.serving.cluster.ClusterFrontend`.  Not supported
here (raises): stall events and per-server object-engine pinning.
"""
from __future__ import annotations

import functools
from collections import deque
from time import perf_counter
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.dispatch import (BoundedTimeline, ServerStateColumns,
                                       ServerView)
from repro_torch.core.spec import ServerSpec
from repro_torch.device import resolve_device
from repro_torch.kernels.group_pick import pick_order
from repro_torch.serving.cluster import ClusterConfig, ClusterFrontend
from repro_torch.serving.request import Request
from repro_torch.serving.store import _SFS_KW, VECTOR_POLICIES, _RequestStore

_IMAX = 2 ** 31 - 1
_I32 = torch.int32

# field layouts of the region tensors (the JAX package's layout)
_QROW, _QRID, _QNTOK, _QENT = range(4)                       # queue ring
_NQ = 4
(_LROW, _LRID, _LNTOK, _LSRV, _LSLC, _LQD, _LFS,
 _LQE) = range(8)                                            # FILTER lanes
_NL = 8
(_PROW, _PRID, _PNTOK, _PSRV, _PVR, _PNCTX, _PQD, _PFS, _PQE, _PFLG,
 _PSLC) = range(11)                                          # CFS pool
_NP = 11
(_EKEY, _EROW, _ESRV, _ENCTX, _EQD, _EFS, _EQE, _EVR, _EFLG,
 _ESLC) = range(10)                                          # events
_NE = 10
_AENG, _AKIND, _AROW, _ARID, _ANTOK, _APOS = range(6)        # arrivals
_NA = 6

_SCAN_CHUNK = 64          # ticks per chunk
_SCAN_EVCAP_MAX = 4096    # per-tick completion buffer cap inside a chunk


def _scan_evcap(G: int, L: int, sfs: bool) -> int:
    """Per-tick completion buffer inside a chunk.  At fleet scale hundreds
    of engines finish in the same drain tick, and an overflow throws away
    a whole computed chunk — so size for the worst burst (every lane and
    every chosen pool slot, ``(2|1) * G * L``) up to a cap that keeps the
    buffer a few MB; past the cap the overflow/rollback path stays the
    correctness net."""
    return min((2 if sfs else 1) * G * L, _SCAN_EVCAP_MAX)


_STATE_KEYS = ("q", "qh", "qn", "lanes", "lc", "pool", "pc", "minvr",
               "last")


@functools.lru_cache(maxsize=None)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _count(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``[n]`` int32 occurrences of each value of ``idx`` in ``[0, n)``;
    the value ``n`` is the sink and is dropped."""
    c = torch.zeros(n + 1, dtype=_I32, device=idx.device)
    c.index_put_((idx.long(),), torch.ones((), dtype=_I32,
                                           device=idx.device),
                 accumulate=True)
    return c[:n]


def _excl_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Exclusive int32 running count of ``mask`` along axis 1."""
    m = mask.to(_I32)
    return torch.cumsum(m, dim=1, dtype=_I32) - m


def _tick_core(G, L, QCAP, CAP, sfs, evcap, trace, state, arr, t, S, thr):
    """One tick of a G-engine homogeneous group, pure int32 tensor ops.

    The JAX package's ``_tick_core`` operation for operation: arrival
    scatter (positions precomputed on the host), FILTER fill with the
    ``O x S`` bypass as a cumulative-sum prefix, the batched fair-share
    pick, run/finish/demote, stable lane compaction, pool compaction, the
    monotone ``min_vruntime`` collapse, and key-sorted completion events
    (key = engine * 2L + lane for FILTER, + L + rank for CFS).  ``t`` is a
    Python int; ``S`` and ``thr`` are ``[G]`` int32 device tensors.  The
    input tensors are never written: every region is copied (with its
    sink) before the first scatter, so a chunk can roll back.

    ``trace`` additionally returns the store rows touched by the intra-tick
    lifecycle transitions (FILTER admit, O x S bypass, slice-expiry
    demotion, fair-share displacement) as -1-padded masks, captured before
    compaction overwrites the rows.
    """
    q, qh, qn, lanes, lc, pool, pc, minvr, last = (state[k]
                                                   for k in _STATE_KEYS)
    dev = pool.device
    gi = _arange(G, dev)
    il = _arange(L, dev)
    ic = _arange(CAP, dev)
    gcol = gi[:, None].long()
    A = arr.shape[0]
    where = torch.where

    # ---- arrival scatter (already classified + positioned on host) ----
    kind = arr[:, _AKIND]
    aeng = arr[:, _AENG]
    apos = arr[:, _APOS]
    tA = torch.full((A,), t, dtype=_I32, device=dev)
    zA = torch.zeros(A, dtype=_I32, device=dev)
    # rows bound for the other region (and the -1 padding rows) go to
    # position 0 of the sink row G
    if sfs:
        qsel = kind == 0
        eq = where(qsel, aeng, G)
        qrow = torch.stack([arr[:, _AROW], arr[:, _ARID], arr[:, _ANTOK],
                            tA], dim=-1)
        qp = F.pad(q, (0, 0, 0, 0, 0, 1))              # sink row G
        qp.index_put_((eq.long(), where(qsel, apos, 0).long()), qrow)
        q = qp[:G]
        qn = qn + _count(eq, G)
    psel = kind >= 1
    ep = where(psel, aeng, G)
    avr = minvr[aeng.clamp(0, G - 1).long()]
    prow = torch.stack([arr[:, _AROW], arr[:, _ARID], arr[:, _ANTOK],
                        zA, avr, zA, zA, zA - 1, tA,
                        (kind == 2).to(_I32), zA], dim=-1)
    pp = F.pad(pool, (0, 0, 0, 1, 0, 1))               # sinks G and CAP
    pp.index_put_((ep.long(), where(psel, apos, 0).long()), prow)
    pool = pp[:G, :CAP]
    pc = pc + _count(ep, G)

    # ---- FILTER fill: the pop loop as a cumulative-sum prefix --------
    n_byp = torch.zeros(G, dtype=_I32, device=dev)
    if sfs:
        iq = _arange(QCAP, dev)
        free0 = L - lc
        ring = (qh[:, None] + iq[None, :]) % QCAP
        qq = torch.gather(q, 1, ring.long()[:, :, None].expand(G, QCAP,
                                                               _NQ))
        qvalid = iq[None, :] < qn[:, None]
        delay = t - qq[..., _QENT]
        byp = qvalid & (delay >= thr[:, None])
        adm = qvalid & ~byp
        # an entry is examined iff the admitted (lane-consuming) entries
        # strictly before it have not yet filled the free lanes — the
        # loop keeps draining past bypasses
        adm_before = _excl_cumsum(adm)
        examined = qvalid & (adm_before < free0[:, None])
        admit = examined & adm
        bypass = examined & byp
        if trace:
            tr_adm = where(admit, qq[..., _QROW], -1)
            tr_byp = where(bypass, qq[..., _QROW], -1)
        zQ = torch.zeros((G, QCAP), dtype=_I32, device=dev)
        lane_i = where(admit, lc[:, None] + adm_before, L)
        lrow = torch.stack([qq[..., _QROW], qq[..., _QRID],
                            qq[..., _QNTOK], zQ, zQ + S[:, None], delay,
                            zQ + t, qq[..., _QENT]], dim=-1)
        lp = F.pad(lanes, (0, 0, 0, 1))                # sink lane L
        lp.index_put_((gcol, lane_i.long()), lrow)
        lanes = lp[:, :L]
        n_adm = admit.sum(dim=1, dtype=_I32)
        lc = lc + n_adm
        bpos = where(bypass, pc[:, None] + _excl_cumsum(bypass), CAP)
        brow = torch.stack([qq[..., _QROW], qq[..., _QRID],
                            qq[..., _QNTOK], zQ, zQ + minvr[:, None], zQ,
                            delay, zQ + t, qq[..., _QENT], zQ + 1, zQ],
                           dim=-1)
        pp.index_put_((gcol, bpos.long()), brow)
        n_byp = bypass.sum(dim=1, dtype=_I32)
        pc = pc + n_byp
        n_ex = n_adm + n_byp
        qh = (qh + n_ex) % QCAP
        qn = qn - n_ex
        free = L - lc
    else:
        free = torch.full((G,), L, dtype=_I32, device=dev)

    # ---- fair-share pick + start/displacement accounting -------------
    pvalid = ic[None, :] < pc[:, None]
    vr_k = where(pvalid, pool[..., _PVR], _IMAX)
    rid_k = where(pvalid, pool[..., _PRID], _IMAX)
    cpos = pick_order(vr_k, rid_k, L)                   # [G, L] positions
    k = torch.minimum(free, pc)
    sel = k > 0
    ch = il[None, :] < k[:, None]
    # tail columns of the pick may be CAP; they are masked by ``ch``
    cpos_l = cpos.clamp(max=CAP - 1).long()
    crows = torch.gather(pool, 1, cpos_l[:, :, None].expand(G, L, _NP))
    new = ch & (crows[..., _PFS] < 0)
    qd2 = crows[..., _PQD] + where(new, t - crows[..., _PQE], 0)
    fs2 = where(new, t, crows[..., _PFS])
    srv2 = crows[..., _PSRV] + 1                        # run (prefill/decode)
    vr2 = crows[..., _PVR] + 1                          # end-of-tick charge
    upd = crows.clone()
    upd[..., _PQD] = qd2
    upd[..., _PFS] = fs2
    upd[..., _PSRV] = srv2
    upd[..., _PVR] = vr2
    pp.index_put_((gcol, where(ch, cpos_l, CAP)), upd)
    # displaced = ran last pick, still in this pool, not re-chosen
    ch_rows = where(ch, crows[..., _PROW], -2)
    prow_ids = where(pvalid, pool[..., _PROW], -3)
    in_ch = (last[:, :, None] == ch_rows[:, None, :]).any(-1)
    eqp = last[:, :, None] == prow_ids[:, None, :]      # [G, L, CAP]
    disp = (last >= 0) & sel[:, None] & eqp.any(-1) & ~in_ch
    dpos = where(disp, eqp.to(torch.uint8).argmax(-1), CAP)
    pp[..., _PNCTX].index_put_(
        (gcol, dpos), torch.ones((), dtype=_I32, device=dev),
        accumulate=True)
    if trace:
        tr_pre = where(disp, last, -1)
    last = where(sel[:, None], where(ch, crows[..., _PROW], -1), last)
    nact = lc + k

    # ---- FILTER run + end of tick ------------------------------------
    if sfs:
        lact = il[None, :] < lc[:, None]
        lact_i = lact.to(_I32)
        lanes[..., _LSRV] += lact_i                 # lanes is lp's view
        lanes[..., _LSLC] -= lact_i
        done_f = lact & (lanes[..., _LSRV] >= lanes[..., _LNTOK] + 1)
        exp_f = lact & ~done_f & (lanes[..., _LSLC] <= 0)
        fkey = where(done_f, gi[:, None] * (2 * L) + il[None, :], _IMAX)
        zL = torch.zeros((G, L), dtype=_I32, device=dev)
        fev = torch.stack([fkey, lanes[..., _LROW], lanes[..., _LSRV], zL,
                           lanes[..., _LQD], lanes[..., _LFS],
                           lanes[..., _LQE], zL, zL + 2,
                           lanes[..., _LSLC]], dim=-1)
        drow = torch.stack([lanes[..., _LROW], lanes[..., _LRID],
                            lanes[..., _LNTOK], lanes[..., _LSRV],
                            zL + minvr[:, None], zL + 1, lanes[..., _LQD],
                            lanes[..., _LFS], lanes[..., _LQE], zL + 3,
                            lanes[..., _LSLC]], dim=-1)
        if trace:
            tr_dem = where(exp_f, lanes[..., _LROW], -1)

    # ---- pool compaction: drop CFS finishes, append demotes ----------
    fin_c = ch & (srv2 >= crows[..., _PNTOK] + 1)
    finm = torch.zeros((G, CAP + 1), dtype=torch.bool, device=dev)
    finm.index_put_((gcol, where(fin_c, cpos_l, CAP)),
                    torch.ones((), dtype=torch.bool, device=dev))
    surv = pvalid & ~finm[:, :CAP]
    # stable compaction as a cumsum scatter (survivors keep their order;
    # dropped/tail slots zero out)
    sdest = where(surv, torch.cumsum(surv.to(_I32), dim=1, dtype=_I32) - 1,
                  CAP)
    pn = torch.zeros((G, CAP + 1, _NP), dtype=_I32, device=dev)
    pn.index_put_((gcol, sdest.long()), pool)
    pc = surv.sum(dim=1, dtype=_I32)
    if sfs:
        dpos2 = where(exp_f, pc[:, None] + _excl_cumsum(exp_f), CAP)
        pn.index_put_((gcol, dpos2.long()), drow)
        pc = pc + exp_f.sum(dim=1, dtype=_I32)
        # stable lane compaction, same cumsum-scatter trick
        lkeep = lact & ~(done_f | exp_f)
        ldest = where(lkeep,
                      torch.cumsum(lkeep.to(_I32), dim=1, dtype=_I32) - 1,
                      L)
        ln = torch.zeros((G, L + 1, _NL), dtype=_I32, device=dev)
        ln.index_put_((gcol, ldest.long()), lanes)
        lanes = ln[:, :L]
        lc = lkeep.sum(dim=1, dtype=_I32)
    pool = pn[:, :CAP]

    # ---- monotone min_vruntime collapse ------------------------------
    pvalid2 = ic[None, :] < pc[:, None]
    m = where(pvalid2, pool[..., _PVR], _IMAX).amin(dim=1)
    last_slot = (k - 1).clamp(min=0).long()[:, None]
    lastfin = torch.gather(fin_c, 1, last_slot)[:, 0] & sel
    lastvr = torch.gather(vr2, 1, last_slot)[:, 0]
    m = where(lastfin, torch.minimum(m, lastvr), m)
    minvr = where(sel & (m < _IMAX), torch.maximum(minvr, m), minvr)

    # ---- completion events, key-sorted to replay order ---------------
    ckey = where(fin_c, gi[:, None] * (2 * L) + L + il[None, :], _IMAX)
    cev = torch.stack([ckey, crows[..., _PROW], srv2, crows[..., _PNCTX],
                       qd2, fs2, crows[..., _PQE], vr2, crows[..., _PFLG],
                       crows[..., _PSLC]], dim=-1)
    # interleaving per engine (FILTER lanes, then CFS ranks) makes the
    # flattened grid already ascending in event key — compacting the
    # valid rows with a cumsum scatter replaces the argsort, and rows
    # past ``evcap`` fall into the sink like the reference's truncation
    grid = torch.cat([fev, cev], dim=1) if sfs else cev
    ev = grid.reshape(-1, _NE)
    evalid = ev[:, _EKEY] < _IMAX
    n_ev = evalid.sum(dtype=_I32)
    edest = torch.cumsum(evalid.to(_I32), dim=0, dtype=_I32) - 1
    edest = where(evalid & (edest < evcap), edest, evcap)
    evout = torch.zeros((evcap + 1, _NE), dtype=_I32, device=dev)
    evout.index_put_((edest.long(),), ev)

    # ---- distance to the next completion/expiry (event skip) ---------
    if sfs:
        lact2 = il[None, :] < lc[:, None]
        lnext = where(lact2,
                      torch.minimum(lanes[..., _LNTOK] + 1
                                    - lanes[..., _LSRV], lanes[..., _LSLC]),
                      _IMAX).amin(dim=1)
        free2 = L - lc
    else:
        lnext = torch.full((G,), _IMAX, dtype=_I32, device=dev)
        free2 = torch.full((G,), L, dtype=_I32, device=dev)
    runnable = (free2 > 0) & (pc <= free2) & (pc > 0)
    pnext = where(runnable[:, None] & pvalid2,
                  pool[..., _PNTOK] + 1 - pool[..., _PSRV],
                  _IMAX).amin(dim=1)
    min_next = torch.minimum(lnext, pnext).amin()

    state = dict(q=q, qh=qh, qn=qn, lanes=lanes, lc=lc, pool=pool, pc=pc,
                 minvr=minvr, last=last)
    # one tensor for the tick's one device->host copy: [n_ev, min_next,
    # then the five host mirrors of G each]
    head = torch.cat([n_ev[None], min_next[None], qn, lc, pc, nact, n_byp])
    out = {"events": evout[:evcap], "head": head}
    if trace:
        out["trace_pre"] = tr_pre
        if sfs:
            out["trace_adm"] = tr_adm
            out["trace_byp"] = tr_byp
            out["trace_dem"] = tr_dem
    return state, out


def _advance_core(G, L, CAP, sfs, state, g, t0):
    """Collapse ``g`` event-free ticks (valid only when the host proved no
    fill, no finish, no expiry and no rotation can occur): active lanes
    serve and burn slice for ``g`` ticks; pools that fit their free lanes
    run whole for ``g`` ticks (first pick at ``t0`` settles first-start
    accounting); ``min_vruntime`` telescopes to a max against the final
    pool minimum; ``last`` becomes the pool itself, so no displacement is
    ever recorded — the same no-op the per-tick path would compute.  The
    input tensors are not written."""
    q, qh, qn, lanes, lc, pool, pc, minvr, last = (state[k]
                                                   for k in _STATE_KEYS)
    dev = pool.device
    il = _arange(L, dev)
    ic = _arange(CAP, dev)
    where = torch.where
    if sfs:
        lact = (il[None, :] < lc[:, None]).to(_I32)
        lanes = lanes.clone()
        lanes[..., _LSRV] += g * lact
        lanes[..., _LSLC] -= g * lact
        free = L - lc
    else:
        free = torch.full((G,), L, dtype=_I32, device=dev)
    run_eng = (free > 0) & (pc > 0)
    pvalid = ic[None, :] < pc[:, None]
    run = run_eng[:, None] & pvalid
    new = run & (pool[..., _PFS] < 0)
    pool = pool.clone()
    pool[..., _PQD] += where(new, t0 - pool[..., _PQE], 0)
    pool[..., _PFS] = where(new, t0, pool[..., _PFS])
    runi = run.to(_I32)
    pool[..., _PSRV] += g * runi
    pool[..., _PVR] += g * runi
    m = where(run, pool[..., _PVR], _IMAX).amin(dim=1)
    minvr = where(run_eng & (m < _IMAX), torch.maximum(minvr, m), minvr)
    rows_pad = where(pvalid, pool[..., _PROW], -1)[:, :L]
    last = where(run_eng[:, None], rows_pad, last)
    return dict(q=q, qh=qh, qn=qn, lanes=lanes, lc=lc, pool=pool, pc=pc,
                minvr=minvr, last=last)


def _grow_np(a: np.ndarray, axis: int, size: int, fill=0) -> np.ndarray:
    shape = list(a.shape)
    shape[axis] = size - a.shape[axis]
    return np.concatenate([a, np.full(shape, fill, a.dtype)], axis=axis)


class _TorchGroup:
    """G identical engines stepped together by one tick program.

    Device state holds only *region* tensors (queue ring, lanes, pool);
    the host keeps the dispatch-visible mirrors (outstanding, free slots,
    queue/pool depths), the adaptive-slice IAT windows, and the pending
    deques, so routing stays identical to the reference."""

    def __init__(self, members: Sequence[int], lanes: int, n_slots: int,
                 policy: str, sched_kw: dict, store: _RequestStore,
                 device: torch.device):
        self.members = list(members)
        self.G = len(self.members)
        self.lanes = lanes
        self.n_slots = n_slots
        self.policy = policy
        self.store = store
        self.device = device
        G = self.G
        self.fixed_slice = sched_kw.get("slice_ticks")
        slice_init = sched_kw.get("slice_init", 32)
        self.window = int(sched_kw.get("adaptive_window", 100))
        of = sched_kw.get("overload_factor", 3.0)
        self.overload_factor = None if of is None else float(of)
        self.hinted_demotion = bool(sched_kw.get("hinted_demotion", False))
        init_S = (self.fixed_slice if self.fixed_slice is not None
                  else slice_init)
        self.S = np.full(G, init_S, np.int64)
        self._iats = [deque(maxlen=self.window) for _ in range(G)]
        self._last_arrival = np.full(G, -1, np.int64)
        self._since_update = np.zeros(G, np.int64)
        self.slice_timeline = [BoundedTimeline((0, int(init_S)))
                               for _ in range(G)]
        self.overload_bypasses = np.zeros(G, np.int64)
        # host mirrors of device depths (refreshed from step outputs)
        self.qh = np.zeros(G, np.int64)
        self.qlen = np.zeros(G, np.int64)
        self.filter_count = np.zeros(G, np.int64)
        self.cfs_count = np.zeros(G, np.int64)
        self.n_active = np.zeros(G, np.int64)
        self.lane_busy_ticks = np.zeros(G, np.int64)
        self.pending: list[deque] = [deque() for _ in range(G)]
        self.pending_len = np.zeros(G, np.int64)
        self.free_slots = np.full(G, n_slots, np.int64)
        self.outstanding = np.zeros(G, np.int64)
        self.min_next = 1
        # device regions
        self.QCAP = 64
        # fleet-scale runs reach pool depth ~2x lanes routinely; starting
        # at 32 avoids a mid-run _grow
        self.CAP = max(32, 2 * lanes)
        self.ACAP = 256
        # opt-in telemetry (core/telemetry.py); None = fully disabled
        self.trace = None
        self.prof = None
        self._state = self._fresh_state()
        self._batch: list = []          # (j, kind, row, rid, ntok)
        self._arr0 = torch.full((1, _NA), -1, dtype=_I32, device=device)

    # -- device plumbing ----------------------------------------------
    def _fresh_state(self):
        G, L, dev = self.G, self.lanes, self.device

        def z(*s):
            return torch.zeros(s, dtype=_I32, device=dev)

        return dict(q=z(G, self.QCAP, _NQ), qh=z(G), qn=z(G),
                    lanes=z(G, L, _NL), lc=z(G),
                    pool=z(G, self.CAP, _NP), pc=z(G), minvr=z(G),
                    last=torch.full((G, L), -1, dtype=_I32, device=dev))

    def _pull(self) -> dict:
        return {k: v.cpu().numpy().copy() for k, v in self._state.items()}

    def _push(self, host: dict):
        self._state = {k: torch.from_numpy(np.ascontiguousarray(
            v, np.int32)).to(self.device) for k, v in host.items()}

    def bind_telemetry(self, trace, prof):
        """Attach trace/profile collectors; tracing makes the step also
        return the lifecycle row masks."""
        self.trace = trace
        self.prof = prof

    def _grow(self, *, qcap=None, cap=None):
        """Resize a device region: pull, pad (unrolling the queue ring to
        head 0), push back."""
        host = self._pull()
        if qcap is not None and qcap > self.QCAP:
            q2 = np.zeros((self.G, qcap, _NQ), np.int32)
            for j in range(self.G):
                n = int(host["qn"][j])
                idx = (int(self.qh[j]) + np.arange(n)) % self.QCAP
                q2[j, :n] = host["q"][j, idx]
            host["q"] = q2
            host["qh"] = np.zeros(self.G, np.int32)
            self.qh[:] = 0
            self.QCAP = qcap
        if cap is not None and cap > self.CAP:
            host["pool"] = _grow_np(host["pool"], 1, cap)
            self.CAP = cap
        self._push(host)

    def _dev_i32(self, *arrays: np.ndarray) -> list:
        """Host int32 arrays -> device tensors through one copy."""
        flat = np.concatenate([np.asarray(a, np.int32).ravel()
                               for a in arrays])
        d = torch.from_numpy(flat).to(self.device)
        out, o = [], 0
        for a in arrays:
            out.append(d[o:o + a.size].view(a.shape))
            o += a.size
        return out

    # -- arrivals (host-classified, device-scattered) ------------------
    def _observe_iat(self, j: int, t: int):
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

    def _classify(self, j: int, row: int, req: Request, t: int):
        """The request's first region (queue / pool / demoted pool) is
        decided here with host state; the device scatters it there."""
        if self.policy == "cfs":
            kind = 1
            self.cfs_count[j] += 1
        else:
            self._observe_iat(j, t)
            if (self.hinted_demotion and req.eta_hint is not None
                    and req.eta_hint > self.S[j]):
                kind = 2
                self.cfs_count[j] += 1
                if self.trace is not None:
                    # hinted demotion: straight to the fair-share pool
                    self.trace.emit(t, "demote", req.rid, self.members[j])
            else:
                kind = 0
                self.qlen[j] += 1
        # flat int buffer: np.array on a flat list is far cheaper than on
        # a list of tuples, and step_tick converts it every tick
        self._batch.extend((j, kind, row, req.rid, req.n_tokens))

    def submit(self, j: int, req: Request, t: int):
        if req.stall_events:
            raise ValueError(
                "the torch fleet backend does not model stall events")
        row = self.store.add(req)
        self.outstanding[j] += 1
        if self.free_slots[j] > 0:
            self.free_slots[j] -= 1
            self._classify(j, row, req, t)
        else:
            self.pending[j].append((row, req))
            self.pending_len[j] += 1

    def _admit_pending(self, t: int):
        for j in np.nonzero((self.pending_len > 0)
                            & (self.free_slots > 0))[0]:
            pen = self.pending[j]
            while self.free_slots[j] > 0 and pen:
                self.free_slots[j] -= 1
                self.pending_len[j] -= 1
                row, req = pen.popleft()
                self._classify(int(j), row, req, t)

    # -- the per-tick step ---------------------------------------------
    def _thr32(self) -> np.ndarray:
        if self.policy != "sfs" or self.overload_factor is None:
            return np.full(self.G, _IMAX, np.int32)
        # delay >= O*S  <=>  delay >= ceil(O*S) for integer delays
        return np.minimum(
            np.ceil(self.overload_factor * self.S), _IMAX).astype(np.int32)

    def step_tick(self, t: int) -> list:
        self._admit_pending(t)
        batch, self._batch = self._batch, []
        G, L = self.G, self.lanes
        b = np.array(batch, np.int64).reshape(-1, 5)
        bj, bkind = b[:, 0], b[:, 1]
        kc = bkind != 0                       # queue vs pool region
        nq = np.bincount(bj[~kc], minlength=G)
        npl = np.bincount(bj[kc], minlength=G)
        # the mirrors already include this batch (classify is eager);
        # conservative pool headroom: every queued entry could bypass
        # into the pool this tick, and every lane could demote
        if int(self.qlen.max(initial=0)) > self.QCAP:
            want = self.QCAP
            while int(self.qlen.max()) > want:
                want *= 2
            self._grow(qcap=want)
        if int((self.cfs_count + self.qlen + L).max(initial=0)) > self.CAP:
            want = self.CAP
            while int((self.cfs_count + self.qlen + L).max()) > want:
                want *= 2
            self._grow(cap=want)
        while len(b) > self.ACAP:
            self.ACAP *= 2
        arr = np.full((self.ACAP, _NA), -1, np.int32)
        if batch:
            # per-(engine, region) arrival ranks in batch order — the
            # grouped cumulative count, via one stable argsort
            gid = bj * 2 + kc
            o = np.argsort(gid, kind="stable")
            sg = gid[o]
            ar = np.arange(len(b))
            first = np.r_[True, sg[1:] != sg[:-1]]
            rank = np.empty(len(b), np.int64)
            rank[o] = ar - np.maximum.accumulate(np.where(first, ar, 0))
            qbase = self.qlen - nq            # depth before this batch
            pbase = self.cfs_count - npl
            pos = np.where(kc, pbase[bj] + rank,
                           (self.qh[bj] + qbase[bj] + rank) % self.QCAP)
            arr[:len(b), :5] = b
            arr[:len(b), 5] = pos
        qn_in = self.qlen.copy()
        prof = self.prof
        pt = perf_counter() if prof is not None else 0.0
        arr_d, S_d, thr_d = self._dev_i32(arr, self.S, self._thr32())
        state, out = _tick_core(
            G, L, self.QCAP, self.CAP, self.policy == "sfs",
            G * L * (2 if self.policy == "sfs" else 1),
            self.trace is not None, self._state, arr_d, int(t), S_d, thr_d)
        self._state = state
        head = out["head"].cpu().numpy().astype(np.int64)
        n_ev = int(head[0])
        self.min_next = int(head[1])
        qn2, lc2, pc2, nact, nbyp = head[2:].reshape(5, G)
        n_ex = qn_in - qn2
        self.qh = (self.qh + n_ex) % self.QCAP
        self.qlen = qn2
        self.filter_count = lc2
        self.cfs_count = pc2
        self.n_active = nact
        self.lane_busy_ticks += nact
        self.overload_bypasses += nbyp
        if prof is not None:
            prof.add("torch_step", perf_counter() - pt)
        if self.trace is not None:
            self._emit_trace(out, t)
        if n_ev == 0:
            return []
        pt = perf_counter() if prof is not None else 0.0
        ev = out["events"][:n_ev].cpu().numpy().astype(np.int64)
        res = self._process_events(ev, t)
        if prof is not None:
            prof.add("torch_events", perf_counter() - pt)
        return res

    def _emit_trace(self, out, t: int):
        """Reconstruct the lifecycle events the object/vector schedulers
        of the JAX package emit inline from the device row masks (-1 = no
        event).  Order within a tick is irrelevant — traces compare
        canonically sorted (core/telemetry.py)."""
        tr, st, mem = self.trace, self.store, self.members
        keys = ([("admit", "trace_adm"), ("bypass", "trace_byp"),
                 ("demote", "trace_dem")] if self.policy == "sfs" else [])
        for kind, key in keys + [("preempt", "trace_pre")]:
            a = out[key].cpu().numpy()
            g, p = np.nonzero(a >= 0)
            if g.size:
                rows = a[g, p]
                tr.emit_rows(t, kind,
                             zip(st.rid[rows].tolist(),
                                 [mem[x] for x in g.tolist()]))

    def _process_events(self, ev: np.ndarray, t: int) -> list:
        """Batched store write-back of finished rows + the (member, order)
        replay tuples the frontend merges across groups."""
        st = self.store
        L2 = 2 * self.lanes
        rows = ev[:, _EROW]
        eng = ev[:, _EKEY] // L2
        st.served[rows] = ev[:, _ESRV]
        st.tokens_done[rows] = ev[:, _ESRV] - 1
        st.prefill_done[rows] = True
        st.n_ctx[rows] = ev[:, _ENCTX]
        st.queue_delay[rows] = ev[:, _EQD]
        st.first_start[rows] = ev[:, _EFS]
        st.queue_enter[rows] = ev[:, _EQE]
        st.vruntime[rows] = ev[:, _EVR]
        st.demoted[rows] = (ev[:, _EFLG] & 1).astype(bool)
        st.slice_set[rows] = (ev[:, _EFLG] >> 1).astype(bool)
        st.slice_left[rows] = ev[:, _ESLC]
        st.finish[rows] = t + 1
        np.add.at(self.free_slots, eng, 1)
        np.add.at(self.outstanding, eng, -1)
        if self.trace is not None:
            self.trace.emit_rows(
                t + 1, "complete",
                zip(st.rid[rows].tolist(),
                    [self.members[g] for g in eng.tolist()]))
        return [(self.members[g], int(key - g * L2), int(row))
                for g, key, row in zip(eng, ev[:, _EKEY], rows)]

    # -- fleet lifecycle ----------------------------------------------
    def evict(self, j: int) -> list:
        """Remove every resident request of engine ``j`` (queue ring,
        FILTER lanes, fair-share pool, pending deque, any unflushed
        arrival batch) and zero its device regions — the backend half of
        the frontend's ``_evict_server`` hook.  Pull/patch/push: the
        shapes are unchanged."""
        st = self.store
        rows: list = []
        if self._batch:
            # arrivals classified this tick but not yet scattered
            b = np.array(self._batch, np.int64).reshape(-1, 5)
            keep = b[:, 0] != j
            rows.extend(b[~keep, 2].tolist())
            self._batch = b[keep].reshape(-1).tolist()
        host = self._pull()
        qn = int(host["qn"][j])
        if qn:
            idx = (int(host["qh"][j]) + np.arange(qn)) % self.QCAP
            rows.extend(host["q"][j, idx, _QROW].tolist())
        lc = int(host["lc"][j])
        if lc:
            rows.extend(host["lanes"][j, :lc, _LROW].tolist())
        pc = int(host["pc"][j])
        if pc:
            rows.extend(host["pool"][j, :pc, _PROW].tolist())
        evicted = [st.reqs[int(r)] for r in rows]
        evicted.extend(req for _row, req in self.pending[j])
        self.pending[j].clear()
        for k in ("q", "lanes", "pool", "qh", "qn", "lc", "pc"):
            host[k][j] = 0
        host["last"][j] = -1
        self._push(host)
        # host mirrors: engine j is empty from here on (the orphaned
        # store rows are never written back — resubmission adds fresh
        # rows), and the stale event-skip distance must be discarded
        self.qh[j] = 0
        self.qlen[j] = 0
        self.filter_count[j] = 0
        self.cfs_count[j] = 0
        self.n_active[j] = 0
        self.pending_len[j] = 0
        self.free_slots[j] = self.n_slots
        self.outstanding[j] = 0
        self.min_next = 1
        return evicted

    def evict_one(self, j: int, rid: int):
        """Remove the single resident request ``rid`` from engine ``j``
        (unflushed arrival batch, pending deque, queue ring, FILTER lane
        or fair-share pool) and return its Request — the backend half of
        the frontend's ``_evict_request`` hook (timeout/hedge).
        Pull/patch/push like :meth:`evict`, and the stale event-skip
        distance is discarded."""
        st = self.store
        if self._batch:
            # classified this tick but not yet scattered: undo the
            # mirror increment _classify made for its target region
            b = np.array(self._batch, np.int64).reshape(-1, 5)
            hit = np.nonzero((b[:, 0] == j) & (b[:, 3] == rid))[0]
            if hit.size:
                k = int(hit[0])
                row, kind = int(b[k, 2]), int(b[k, 1])
                if kind == 0:
                    self.qlen[j] -= 1
                else:
                    self.cfs_count[j] -= 1
                self._batch = np.delete(b, k, axis=0).reshape(-1).tolist()
                self.free_slots[j] += 1
                self.outstanding[j] -= 1
                self.min_next = 1
                return st.reqs[row]
        for k, (row, req) in enumerate(self.pending[j]):
            if req.rid == rid:
                del self.pending[j][k]
                self.pending_len[j] -= 1
                self.outstanding[j] -= 1     # never claimed a slot
                return req
        host = self._pull()
        row = None
        qn = int(host["qn"][j])
        if qn:
            idx = (int(host["qh"][j]) + np.arange(qn)) % self.QCAP
            ring = host["q"][j, idx]
            hit = np.nonzero(ring[:, _QRID] == rid)[0]
            if hit.size:
                p = int(hit[0])
                row = int(ring[p, _QROW])
                q2 = np.zeros_like(host["q"][j])
                q2[:qn - 1] = np.delete(ring, p, axis=0)
                host["q"][j] = q2            # unrolled to head 0
                host["qh"][j] = 0
                host["qn"][j] = qn - 1
                self.qh[j] = 0
                self.qlen[j] -= 1
        lc = int(host["lc"][j])
        if row is None and lc:
            hit = np.nonzero(host["lanes"][j, :lc, _LRID] == rid)[0]
            if hit.size:
                p = int(hit[0])
                row = int(host["lanes"][j, p, _LROW])
                # stable shift-left, like the end-of-tick compaction
                host["lanes"][j, p:lc - 1] = host["lanes"][j, p + 1:lc]
                host["lanes"][j, lc - 1] = 0
                host["lc"][j] = lc - 1
                self.filter_count[j] -= 1
        pc = int(host["pc"][j])
        if row is None and pc:
            hit = np.nonzero(host["pool"][j, :pc, _PRID] == rid)[0]
            if hit.size:
                p = int(hit[0])
                row = int(host["pool"][j, p, _PROW])
                host["pool"][j, p:pc - 1] = host["pool"][j, p + 1:pc]
                host["pool"][j, pc - 1] = 0
                host["pc"][j] = pc - 1
                self.cfs_count[j] -= 1
        if row is None:
            return None
        lr = host["last"][j]
        lr[lr == row] = -1                   # no phantom displacement
        self._push(host)
        self.free_slots[j] += 1
        self.outstanding[j] -= 1
        self.min_next = 1
        return st.reqs[row]

    # -- multi-tick fast paths -----------------------------------------
    def skip_valid(self) -> bool:
        """No event before ``min_next`` ticks can change behaviour: fill
        is a no-op (lanes full or queue empty — the post-tick invariant),
        nothing rotates (each pool fits its free lanes or cannot run), and
        no pending admission could fire (pending work implies exhausted
        slots, which no completion will refill)."""
        L = self.lanes
        free = ((L - self.filter_count) if self.policy == "sfs"
                else np.full(self.G, L))
        return bool(
            np.all((self.filter_count == L) | (self.qlen == 0))
            and np.all((self.cfs_count <= free) | (free == 0))
            and np.all((self.pending_len == 0) | (self.free_slots == 0)))

    def gap_active_counts(self) -> np.ndarray:
        L = self.lanes
        free = ((L - self.filter_count) if self.policy == "sfs"
                else np.full(self.G, L))
        return self.filter_count + np.minimum(free, self.cfs_count)

    def advance(self, g: int, t0: int):
        self._state = _advance_core(self.G, self.lanes, self.CAP,
                                    self.policy == "sfs", self._state,
                                    int(g), int(t0))
        self.min_next -= g
        self.lane_busy_ticks += g * self.gap_active_counts()

    def scan(self, t0: int):
        """Phase 1 of a ``_SCAN_CHUNK``-tick window (no arrivals, no
        pending): run the chunk with no host sync inside, pull the stacked
        outputs once, detect event-buffer overflow.  Nothing is committed,
        so an overflow in ANY group lets the cluster abandon the whole
        window.  Returns ``(False, first_bad_tick)`` or ``(True,
        payload)`` for :meth:`commit_scan`."""
        G, L = self.G, self.lanes
        sfs = self.policy == "sfs"
        evcap = _scan_evcap(G, L, sfs)
        S_d, thr_d = self._dev_i32(self.S, self._thr32())
        state, heads, evs = self._state, [], []
        for i in range(_SCAN_CHUNK):
            # chunks are only entered with traces off
            # (TorchCluster._fast_forward), so the body never traces
            state, out = _tick_core(G, L, self.QCAP, self.CAP, sfs, evcap,
                                    False, state, self._arr0, t0 + i, S_d,
                                    thr_d)
            heads.append(out["head"])
            evs.append(out["events"])
        nh = _SCAN_CHUNK * (2 + 5 * G)
        flat = torch.cat([torch.stack(heads).reshape(-1),
                          torch.stack(evs).reshape(-1)]).cpu().numpy()
        heads = flat[:nh].reshape(_SCAN_CHUNK, 2 + 5 * G).astype(np.int64)
        events = flat[nh:].reshape(_SCAN_CHUNK, evcap, _NE)
        nevs = heads[:, 0]
        if (nevs > evcap).any():
            return False, int(np.argmax(nevs > evcap))
        mir = heads[:, 2:].reshape(_SCAN_CHUNK, 5, G)
        return True, (state, heads[:, :2], mir, events)

    def commit_scan(self, t0: int, payload):
        """Phase 2: adopt the post-chunk state, update mirrors, and return
        (per-tick replay tuples, per-tick active counts)."""
        state, scal, mir, events = payload
        self._state = state
        self.min_next = int(scal[-1, 1])
        per_tick = []
        for i in range(_SCAN_CHUNK):
            n = int(scal[i, 0])
            per_tick.append(
                self._process_events(events[i, :n].astype(np.int64),
                                     t0 + i) if n else [])
        qn2, lc2, pc2, nact, _nbyp = mir[-1]
        self.qh = (self.qh + (self.qlen - qn2)) % self.QCAP
        self.qlen = qn2
        self.filter_count = lc2
        self.cfs_count = pc2
        self.n_active = nact
        self.lane_busy_ticks += mir[:, 3].sum(axis=0)
        self.overload_bypasses += mir[:, 4].sum(axis=0)
        return per_tick, mir[:, 3]


class TorchServerView(ServerView):
    """``ServerView`` protocol over one engine's host mirrors — O(1)
    numpy scalar reads."""

    def __init__(self, group: _TorchGroup, j: int):
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
        lanes = g.lanes - int(g.outstanding[j])
        return max(0, min(slots, lanes))


class _TorchColumns(ServerStateColumns):
    """Bulk dispatch-state refresh from the groups' host mirrors."""

    def __init__(self, views, groups):
        super().__init__(views)
        self._groups = [(g, np.asarray(g.members, np.int64))
                        for g in groups]

    def _pull(self, i: int):
        # one delivery dirties one server between consecutive arrivals —
        # read the group mirrors directly instead of five view-method
        # calls (same formulas as TorchServerView)
        v = self.views[i]
        g, j = v.group, v.j
        out = g.outstanding[j]
        fair = g.cfs_count[j]
        self.outstanding[i] = out
        self.fair_load[i] = fair
        if g.policy == "sfs":
            ql = g.qlen[j]
            ff = g.lanes - g.filter_count[j] - ql
        else:
            ql = 0
            ff = g.lanes - min(g.lanes, fair)
        self.queue_len[i] = ql
        self.filter_free[i] = ff if ff > 0 else 0
        cap = min(g.free_slots[j] - g.pending_len[j], g.lanes - out)
        self.capacity[i] = cap if cap > 0 else 0

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


class TorchCluster(ClusterFrontend):
    """N servers behind one dispatch policy, stepped by group tick
    programs on ``device`` with event-driven multi-tick batching.  Equal,
    field for field, to the JAX package's ``JaxCluster``."""

    def __init__(self, servers: Sequence,
                 cfg: Optional[ClusterConfig] = None, *, device="cuda"):
        self.device = resolve_device(device)
        specs = [s if isinstance(s, ServerSpec) else ServerSpec.parse(s)
                 for s in servers]
        self.store = _RequestStore()
        self.groups: list[_TorchGroup] = []
        self._backend: list = [None] * len(specs)
        by_key: dict = {}
        for i, s in enumerate(specs):
            ec = s.to_engine_config()
            ok = (ec.policy in VECTOR_POLICIES
                  and (set(ec.sched_kw) <= _SFS_KW if ec.policy == "sfs"
                       else not ec.sched_kw))
            if not ok:
                raise ValueError(
                    f"server {i}: scheduler {ec.policy!r} with knobs "
                    f"{ec.sched_kw!r} cannot run on the torch fleet "
                    "backend (sfs or cfs groups only)")
            key = (ec.lanes, ec.n_slots, ec.policy,
                   tuple(sorted(ec.sched_kw.items())))
            by_key.setdefault(key, []).append(i)
        for (lanes, n_slots, policy, kw), members in by_key.items():
            group = _TorchGroup(members, lanes, n_slots, policy, dict(kw),
                                self.store, self.device)
            self.groups.append(group)
            for j, idx in enumerate(members):
                self._backend[idx] = (group, j)
        views = [TorchServerView(*self._backend[i])
                 for i in range(len(specs))]
        super().__init__(views, cfg)
        self._cols = _TorchColumns(views, self.groups)
        self.policy.columns = self._cols
        self._done_rows: list[int] = []
        self._scan_cooldown = 0

    # -- backend hooks -------------------------------------------------
    def _bind_backend(self, tel):
        if tel.trace is not None or tel.profile is not None:
            for g in self.groups:
                g.bind_telemetry(tel.trace, tel.profile)

    def _submit(self, idx: int, req: Request):
        group, j = self._backend[idx]
        group.submit(j, req, self.t)
        self._cols.mark(idx)

    def _evict_server(self, idx: int) -> list:
        group, j = self._backend[idx]
        evicted = group.evict(j)
        self._cols.mark(idx)
        return evicted

    def _evict_request(self, idx: int, rid: int):
        group, j = self._backend[idx]
        req = group.evict_one(j, rid)
        if req is not None:
            self._cols.mark(idx)
        return req

    def _observe_finish(self, req: Request, t: int):
        # series completion counters are handled in _replay from the
        # store columns — ``req`` is only written back at collect time,
        # so its demoted/n_ctx fields are stale here
        if self._watchdog is not None:
            self._watchdog.complete(req.rid)
        self.predictor.observe(req.func_id, req.service_demand)

    def _replay(self, events: list, t: int):
        """Merge per-group completion tuples into object-cluster order
        and drive the predictor feedback loop."""
        events.sort(key=lambda e: (e[0], e[1]))
        ser = self._series
        st = self.store
        for _member, _order, row in events:
            self._done_rows.append(row)
            if ser is not None:
                c = ser.counters
                c["completions"] += 1
                if st.demoted[row]:
                    c["demoted_done"] += 1
                c["nctx_done"] += int(st.n_ctx[row])
            self._observe_finish(st.reqs[row], t + 1)

    def _step(self):
        events = []
        for group in self.groups:
            events.extend(group.step_tick(self.t))
        self._replay(events, self.t)
        self._cols.mark_all()

    def _active_counts(self) -> tuple:
        counts = [0] * self.n_servers
        for group in self.groups:
            for j, idx in enumerate(group.members):
                counts[idx] = int(group.n_active[j])
        return tuple(counts)

    def _finished_count(self) -> int:
        return len(self._done_rows)

    def _collect(self) -> list:
        prof = self._prof
        pt = perf_counter() if prof is not None else 0.0
        out = self.store.write_back_many(self._done_rows)
        if prof is not None:
            prof.add("torch_writeback", perf_counter() - pt)
        return out

    # -- event-driven multi-tick batching ------------------------------
    def _gap_counts(self) -> tuple:
        counts = [0] * self.n_servers
        for group in self.groups:
            nact = group.gap_active_counts()
            for j, idx in enumerate(group.members):
                counts[idx] = int(nact[j])
        return tuple(counts)

    def _fast_forward(self, window: int) -> bool:
        """Advance up to ``window`` arrival-free ticks without paying
        per-tick dispatch: a closed-form gap jump when no event can land,
        else a 64-tick chunk.  Returns False when neither applies (the
        caller falls back to a single tick)."""
        if window <= 0:
            return False
        gap = min(min(g.min_next for g in self.groups) - 1, window)
        if gap >= 1 and all(g.skip_valid() for g in self.groups):
            # the gap advance is trace-safe: no event of any kind can
            # occur inside the gap, so there is nothing to emit
            prof = self._prof
            pt = perf_counter() if prof is not None else 0.0
            counts = self._gap_counts()
            for group in self.groups:
                group.advance(gap, self.t)
            ser = self._series
            for dt in range(gap):
                self.tick_log.append((self.t + dt, 0, counts))
                if ser is not None and (self.t + dt) % ser.cadence == 0:
                    # gauges are frozen across an event-free gap, so the
                    # live views sample the exact per-tick values
                    ser.sample(self.t + dt, self.views,
                               {"central_queue": len(self.central_queue)})
            self.t += gap
            self._cols.mark_all()
            if prof is not None:
                prof.add("torch_advance", perf_counter() - pt)
            return True
        # chunks skip the per-tick host loop, so they cannot emit trace
        # events or series samples — fall back to per-tick stepping
        # whenever either collector is live
        if (window >= _SCAN_CHUNK and self.t >= self._scan_cooldown
                and self._trace is None and self._series is None
                and not any(g.pending_len.any() for g in self.groups)):
            return self._scan_window()
        return False

    def _scan_window(self) -> bool:
        t0 = self.t
        prof = self._prof
        pt = perf_counter() if prof is not None else 0.0
        payloads = []
        for group in self.groups:
            ok, res = group.scan(t0)
            if not ok:
                # a completion burst blew the per-tick event buffer:
                # nothing was committed anywhere — cool down until the
                # per-tick path has stepped past the burst tick
                self._scan_cooldown = t0 + res + 1
                if prof is not None:
                    prof.add("torch_scan", perf_counter() - pt)
                return False
            payloads.append(res)
        if prof is not None:
            prof.add("torch_scan", perf_counter() - pt)
            pt = perf_counter()
        per_group = [g.commit_scan(t0, p)
                     for g, p in zip(self.groups, payloads)]
        for i in range(_SCAN_CHUNK):
            t = t0 + i
            events = []
            counts = [0] * self.n_servers
            for group, (per_tick, nacts) in zip(self.groups, per_group):
                events.extend(per_tick[i])
                for j, idx in enumerate(group.members):
                    counts[idx] = int(nacts[i][j])
            self._replay(events, t)
            self.tick_log.append((t, 0, tuple(counts)))
        self.t = t0 + _SCAN_CHUNK
        self._cols.mark_all()
        if prof is not None:
            prof.add("torch_commit", perf_counter() - pt)
        return True

    def run(self, workload: Sequence[Request], max_ticks: int = 1_000_000,
            prompts: Optional[dict] = None) -> list[Request]:
        workload = sorted(workload, key=lambda r: r.arrival)
        i, n = 0, len(workload)
        # shed requests never finish; they terminate the loop as their
        # own accounting, excluded from every completion metric
        while self._finished_count() + len(self._shed) < n:
            if self.t > max_ticks:
                raise RuntimeError(
                    f"cluster exceeded {max_ticks} ticks "
                    f"({self._finished_count()}/{n})")
            arrivals = []
            while i < n and workload[i].arrival <= self.t:
                r = workload[i]
                if prompts is not None and r.rid in prompts:
                    r._prompt = np.asarray(prompts[r.rid])
                arrivals.append(r)
                i += 1
            if (not arrivals and not self.central_queue):
                next_arr = workload[i].arrival if i < n else max_ticks + 2
                limit = min(next_arr, max_ticks + 2)
                horizon = self._lifecycle_horizon()
                if horizon is not None:
                    # never fast-forward past a pending failure or the
                    # next autoscale boundary: the decision must be
                    # evaluated by a real tick at exactly that time,
                    # same as the per-tick backends
                    limit = min(limit, horizon)
                if self._fast_forward(limit - self.t):
                    continue
            self.tick(arrivals)
        return sorted(self._collect(), key=lambda r: r.rid)

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        out = super().summary()
        out["backend"] = "torch"
        out["device"] = str(self.device)
        out["groups"] = [{"members": g.members, "lanes": g.lanes,
                          "policy": g.policy} for g in self.groups]
        out["engine_overload_bypasses"] = int(
            sum(int(g.overload_bypasses.sum()) for g in self.groups))
        return out
