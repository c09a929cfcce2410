"""Per-request scheduling state of a fleet run, one column per field.

A copy of ``_RequestStore``, ``_SFS_KW`` and ``VECTOR_POLICIES`` from
``repro.serving.vector_cluster`` (the JAX package's module, lines
56-170).  The fleet backend (``serving/torch_cluster.py``) keeps no
per-request device columns: requests travel with their region rows on
the device, and finished rows are written back here from the completion
events, then into their ``Request`` objects at collect time.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.serving.request import Request

# sched_kw the sfs group step implements; anything else is refused
_SFS_KW = {"slice_ticks", "adaptive_window", "slice_init",
           "overload_factor", "stall_aware", "hinted_demotion"}
VECTOR_POLICIES = ("sfs", "cfs")


def _grow(a: np.ndarray, cols: int, fill) -> np.ndarray:
    pad = np.full(a.shape[:-1] + (cols - a.shape[-1],), fill, a.dtype)
    return np.concatenate([a, pad], axis=-1)


class _RequestStore:
    """Per-request scheduling state, one column per field, shared by all
    engine groups of a cluster.  Rows are append-ordered; finished rows
    are written back into their ``Request`` objects at completion."""

    def __init__(self):
        self.n = 0
        self.reqs: list[Request] = []
        cap = 256
        self.rid = np.empty(cap, np.int64)
        self.n_tokens = np.empty(cap, np.int64)
        self.tokens_done = np.zeros(cap, np.int64)
        self.served = np.zeros(cap, np.int64)
        self.prefill_done = np.zeros(cap, bool)
        self.slice_left = np.zeros(cap, np.int64)
        self.slice_set = np.zeros(cap, bool)
        self.vruntime = np.zeros(cap, np.float64)
        self.n_ctx = np.zeros(cap, np.int64)
        self.demoted = np.zeros(cap, bool)
        self.first_start = np.full(cap, -1, np.int64)
        self.queue_enter = np.zeros(cap, np.int64)
        self.queue_delay = np.zeros(cap, np.int64)
        self.finish = np.full(cap, -1, np.int64)
        self.in_filter = np.zeros(cap, bool)
        self.in_cfs = np.zeros(cap, bool)
        self.pool_pos = np.full(cap, -1, np.int64)
        self.mark = np.zeros(cap, bool)          # reusable scratch mask

    _ARRAYS = ("rid", "n_tokens", "tokens_done", "served", "prefill_done",
               "slice_left", "slice_set", "vruntime", "n_ctx", "demoted",
               "first_start", "queue_enter", "queue_delay", "finish",
               "in_filter", "in_cfs", "pool_pos", "mark")

    def add(self, req: Request) -> int:
        if self.n == self.rid.size:
            for name in self._ARRAYS:
                a = getattr(self, name)
                fill = (-1 if name in ("first_start", "finish", "pool_pos")
                        else 0)
                setattr(self, name, _grow(a, 2 * a.size, fill))
        row = self.n
        self.n += 1
        self.reqs.append(req)
        self.rid[row] = req.rid
        self.n_tokens[row] = req.n_tokens
        return row

    def write_back(self, row: int):
        """Materialize a finished row into its Request, matching every
        field the object engine mutates."""
        r = self.reqs[row]
        r.tokens_done = int(self.tokens_done[row])
        r.prefill_done = bool(self.prefill_done[row])
        r.served_ticks = int(self.served[row])
        r.n_ctx = int(self.n_ctx[row])
        r.demoted = bool(self.demoted[row])
        fs = int(self.first_start[row])
        r.first_start = None if fs < 0 else fs
        r.finish = int(self.finish[row])
        r.queue_enter = int(self.queue_enter[row])
        r.queue_delay = int(self.queue_delay[row])
        r.vruntime = float(self.vruntime[row])
        r.slice_left = (int(self.slice_left[row]) if self.slice_set[row]
                        else None)
        r.slot = None
        return r

    def write_back_many(self, rows: Sequence[int]) -> list:
        """Batched :meth:`write_back` — one fancy-indexed gather and
        ``tolist`` per column (native Python scalars), then plain
        attribute stores.  Identical results, ~3x cheaper per row, which
        matters when a million-request run collects in one call."""
        idx = np.asarray(rows, np.int64)
        td = self.tokens_done[idx].tolist()
        pd = self.prefill_done[idx].tolist()
        sv = self.served[idx].tolist()
        nc = self.n_ctx[idx].tolist()
        dm = self.demoted[idx].tolist()
        fs = self.first_start[idx].tolist()
        fin = self.finish[idx].tolist()
        qe = self.queue_enter[idx].tolist()
        qd = self.queue_delay[idx].tolist()
        vr = self.vruntime[idx].tolist()
        sl = self.slice_left[idx].tolist()
        ss = self.slice_set[idx].tolist()
        out = []
        for k, row in enumerate(rows):
            r = self.reqs[row]
            r.tokens_done = td[k]
            r.prefill_done = pd[k]
            r.served_ticks = sv[k]
            r.n_ctx = nc[k]
            r.demoted = dm[k]
            r.first_start = None if fs[k] < 0 else fs[k]
            r.finish = fin[k]
            r.queue_enter = qe[k]
            r.queue_delay = qd[k]
            r.vruntime = vr[k]
            r.slice_left = sl[k] if ss[k] else None
            r.slot = None
            out.append(r)
        return out
