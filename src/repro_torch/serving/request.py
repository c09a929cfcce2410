"""Serving request model + per-request accounting (turnaround, RTE, ctx).

A request is the serving analogue of the paper's "function invocation":
service time = prefill ticks + number of generated tokens, unknown to the
scheduler a-priori (except for the SRTF oracle).  ``stall_events`` mirrors
the paper's I/O blocking: (tokens_done_offset, stall_ticks) pairs — e.g. a
tool call or client backpressure parking the request off its lane.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class Request:
    rid: int
    arrival: int                     # engine tick of arrival
    prompt_len: int
    n_tokens: int                    # true decode demand (oracle-only info)
    stall_events: tuple = ()         # ((tokens_done, stall_ticks), ...)
    eta_hint: Optional[int] = None   # front-end demand estimate (ticks),
                                     # e.g. a max-tokens cap; None=unknown.
                                     # Used by cluster dispatch and, when a
                                     # scheduler opts into hinted_demotion,
                                     # by the per-engine SFS scheduler.
    func_id: int = 0                 # which app/function this invokes —
                                     # the key duration predictors learn on
                                     # (repro.core.predict)

    # --- engine bookkeeping -------------------------------------------------
    slot: Optional[int] = None
    tokens_done: int = 0
    prefill_done: bool = False
    first_start: Optional[int] = None
    finish: Optional[int] = None
    served_ticks: int = 0            # decode+prefill ticks actually executed
    n_ctx: int = 0                   # lane reassignments (context switches)
    demoted: bool = False            # left FILTER for the fair-share pool
    stall_until: int = -1
    stall_idx: int = 0
    vruntime: float = 0.0            # fair-share accounting
    slice_left: Optional[int] = None # FILTER slice budget (ticks)
    queue_enter: int = 0
    queue_delay: int = 0

    @property
    def done(self) -> bool:
        return self.tokens_done >= self.n_tokens

    @property
    def service_demand(self) -> int:
        """Total ticks of lane time this request needs (prefill counts 1)."""
        return self.n_tokens + 1

    def remaining(self) -> int:
        r = self.n_tokens - self.tokens_done
        if not self.prefill_done:
            r += 1
        return r

    def requeue_reset(self, cold_extra: int = 0) -> "Request":
        """Reset every piece of scheduling state after a server failure
        so the request can re-enter dispatch from scratch (in-flight
        progress is lost with the server).  ``cold_extra`` removes a
        previously charged cold-start inflation — the new server makes
        its own warm/cold decision.  ``arrival`` is untouched: the
        re-run still counts against the original turnaround."""
        self.n_tokens -= cold_extra
        self.slot = None
        self.tokens_done = 0
        self.prefill_done = False
        self.first_start = None
        self.finish = None
        self.served_ticks = 0
        self.n_ctx = 0
        self.demoted = False
        self.stall_until = -1
        self.stall_idx = 0
        self.vruntime = 0.0
        self.slice_left = None
        self.queue_enter = 0
        self.queue_delay = 0
        return self

    @property
    def turnaround(self) -> Optional[int]:
        return None if self.finish is None else self.finish - self.arrival

    @property
    def rte(self) -> Optional[float]:
        """Run-Time Effectiveness (paper Eq. 1): service / turnaround."""
        if self.finish is None:
            return None
        return self.served_ticks / max(self.turnaround, 1)
