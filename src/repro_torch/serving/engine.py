"""Continuous-batching serving engine with pluggable (SFS/CFS/FIFO/SRTF)
lane scheduling — the paper's technique as a serving feature, in PyTorch.

The port of ``repro.serving.engine``.  One engine tick = one
gang-scheduled ``decode_step`` over the slot batch (the GPU analogue of an
OS scheduling tick).  The scheduler picks which slots are *active* each
tick; a request's first tick runs its prefill (B=1), whose cache is then
copied into the request's slot.  Per-request accounting (turnaround,
service ticks, RTE, lane reassignments) mirrors the paper's metrics.

``model=None`` runs the engine in synthetic mode (no model calls):
identical scheduling behaviour.  With a model, every tick runs the real
step on the model's device and copies the tick's new token ids to the
host once.  The dispatch-visible state (``outstanding``,
``runnable_count``, ``free_capacity``), the ``on_finish`` callback and the
``complete`` trace event are the cluster layer's hooks
(:mod:`repro_torch.serving.cluster`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.serving.request import Request
from repro_torch.serving.schedulers import Scheduler, make_scheduler


@dataclasses.dataclass
class EngineConfig:
    lanes: int = 4                   # concurrent decode lanes ("cores")
    n_slots: int = 16                # resident cache slots
    max_len: int = 256               # cache capacity per slot
    policy: str = "sfs"
    sched_kw: dict = dataclasses.field(default_factory=dict)

    def to_spec(self):
        """Equivalent :class:`~repro_torch.core.spec.ServerSpec` (lossless;
        round-trips through ``ServerSpec.to_engine_config()``)."""
        from repro_torch.core.spec import ServerSpec
        return ServerSpec.from_engine_config(self)


class Engine:
    def __init__(self, ecfg: EngineConfig,
                 model: Optional[Transformer] = None, *, device="cuda"):
        self.device = resolve_device(device)
        if model is not None and model.device != self.device:
            raise ValueError(f"model lies on {model.device}, engine on "
                             f"{self.device}")
        self.ecfg = ecfg
        self.model = model
        self.scheduler: Scheduler = make_scheduler(
            ecfg.policy, ecfg.lanes, **ecfg.sched_kw)
        self.t = 0
        self.free_slots = list(range(ecfg.n_slots))
        self.pending_slot: list[Request] = []    # admitted but no slot yet
        self.by_slot: dict[int, Request] = {}
        self.finished: list[Request] = []
        self.next_token: dict[int, int] = {}     # rid -> pending input token
        self.n_stalled = 0                       # parked on a stall event
        self.lane_busy_ticks = 0
        self.tick_log: list[tuple[int, int, int]] = []  # (t, n_active, qlen)
        # completion callback (req, finish_tick): the cluster layer feeds
        # its duration predictor here — only ever finished requests
        self.on_finish = None
        # model calls made, and this tick's prefill tokens (still on the
        # device until the tick's one copy to the host)
        self.n_prefills = 0
        self.n_decode_steps = 0
        self._prefill_tokens: list[tuple[int, torch.Tensor]] = []
        if model is not None:
            self.cache = model.init_cache(ecfg.n_slots, ecfg.max_len)

    # ------------------------------------------------------------------
    def submit(self, req: Request, prompt_tokens: Optional[np.ndarray]
               = None):
        req._prompt = (np.asarray(prompt_tokens)
                       if prompt_tokens is not None else None)
        if self.free_slots:
            req.slot = self.free_slots.pop()
            self.by_slot[req.slot] = req
            self.scheduler.on_arrival(req, self.t)
        else:
            self.pending_slot.append(req)

    def _admit_pending(self):
        while self.free_slots and self.pending_slot:
            req = self.pending_slot.pop(0)
            req.slot = self.free_slots.pop()
            self.by_slot[req.slot] = req
            self.scheduler.on_arrival(req, self.t)

    # -- cluster-dispatch state (repro_torch.core.dispatch.ServerView) -
    def outstanding(self) -> int:
        """Admitted but unfinished requests."""
        return len(self.by_slot) + len(self.pending_slot)

    def runnable_count(self) -> int:
        """Requests that could occupy a lane this tick (not stalled)."""
        if self.n_stalled == 0:          # hot path: no per-request scan
            return len(self.pending_slot) + len(self.by_slot)
        n = len(self.pending_slot)
        for r in self.by_slot.values():
            if r.stall_until < 0 or r.stall_until <= self.t:
                n += 1
        return n

    def free_capacity(self) -> int:
        """New requests this engine could start running right now —
        bounded by both free cache slots and idle lanes (pull dispatch)."""
        slots = len(self.free_slots) - len(self.pending_slot)
        lanes = self.ecfg.lanes - self.runnable_count()
        return max(0, min(slots, lanes))

    # ------------------------------------------------------------------
    def _run_prefill(self, req: Request):
        """Build this request's cache slot from its prompt (one tick)."""
        if self.model is None:
            return
        toks = req._prompt
        if toks is None:
            toks = np.zeros((req.prompt_len,), np.int64)
        toks = torch.as_tensor(np.asarray(toks, np.int64), device=self.device)
        cache1, logits = self.model.prefill(toks[None, :], self.ecfg.max_len)
        # copy the single-sequence cache into this slot, in place
        slot = req.slot
        for k, v in self.cache.items():
            if k == "pos":                       # [B]
                v[slot] = cache1[k][0]
            else:                                # [L, B, ...]
                v[:, slot] = cache1[k][:, 0].to(v.dtype)
        self._prefill_tokens.append((req.rid, logits[0, -1].argmax()))
        self.n_prefills += 1

    def _run_decode(self, reqs: Sequence[Request]):
        """Decode ``reqs`` in one step over all slots; returns
        {rid: next token}.  The tick's prefill tokens come to the host in
        the same single device-to-host copy."""
        if self.model is None or not (reqs or self._prefill_tokens):
            return {}
        parts = [tok.reshape(1) for _, tok in self._prefill_tokens]
        if reqs:
            B = self.ecfg.n_slots
            active = np.zeros((B,), bool)
            tokens = np.zeros((B,), np.int64)
            for r in reqs:
                active[r.slot] = True
                tokens[r.slot] = self.next_token.get(r.rid, 0)
            dev = self.device
            # updates self.cache in place (the reference donates the old
            # cache to XLA and takes the new one back)
            _, logits = self.model.decode_step(
                self.cache, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(active).to(dev))
            slots = torch.tensor([r.slot for r in reqs], device=dev)
            parts.append(logits[:, 0, :].argmax(dim=-1)[slots])
            self.n_decode_steps += 1
        ids = torch.cat(parts).tolist()          # the tick's one copy
        n_pre = len(self._prefill_tokens)
        for (rid, _), tok in zip(self._prefill_tokens, ids):
            self.next_token[rid] = tok
        self._prefill_tokens.clear()
        return {r.rid: tok for r, tok in zip(reqs, ids[n_pre:])}

    # ------------------------------------------------------------------
    def tick(self, arrivals: Sequence[Request] = ()):
        """Advance one engine tick."""
        t = self.t
        for req in arrivals:
            self.submit(req, getattr(req, "_prompt", None))
        self._admit_pending()

        # wake stalled requests (skipped entirely while nothing is parked)
        if self.n_stalled:
            for r in list(self.by_slot.values()):
                if r.stall_until == t:
                    r.stall_until = -1
                    self.n_stalled -= 1
                    self.scheduler.on_wake(r.rid, t)

        chosen = self.scheduler.select(t)
        chosen_reqs = [self.scheduler.reqs[rid] for rid in chosen]

        prefills = [r for r in chosen_reqs if not r.prefill_done]
        decodes = [r for r in chosen_reqs if r.prefill_done]

        for r in prefills:
            self._run_prefill(r)
            r.prefill_done = True

        toks = self._run_decode(decodes)
        for r in decodes:
            r.tokens_done += 1
            if r.rid in toks:
                self.next_token[r.rid] = toks[r.rid]

        self.lane_busy_ticks += len(chosen_reqs)
        self.tick_log.append((t, len(chosen_reqs),
                              self.scheduler.queue_len()))

        # end-of-tick bookkeeping: finish / stall / slice accounting
        for r in chosen_reqs:
            fin = r.done
            self.scheduler.on_tick_end(r.rid, t, fin)
            if fin:
                r.finish = t + 1
                self.finished.append(r)
                self.free_slots.append(r.slot)
                del self.by_slot[r.slot]
                r.slot = None
                self.next_token.pop(r.rid, None)
                sched = self.scheduler
                if sched.trace is not None:
                    sched.trace.emit(t + 1, "complete", r.rid,
                                     sched.trace_idx)
                if self.on_finish is not None:
                    self.on_finish(r, t + 1)
            elif (r.stall_idx < len(r.stall_events)
                  and r.tokens_done >= r.stall_events[r.stall_idx][0]
                  and r.prefill_done):
                dur = r.stall_events[r.stall_idx][1]
                r.stall_idx += 1
                r.stall_until = t + 1 + dur
                self.n_stalled += 1
                self.scheduler.on_stall(r.rid, t)
        self.t += 1

    def run(self, workload: Sequence[Request], max_ticks: int = 1_000_000,
            prompts: Optional[dict] = None) -> list[Request]:
        """Drive the engine over a workload (requests sorted by arrival)."""
        workload = sorted(workload, key=lambda r: r.arrival)
        i = 0
        n = len(workload)
        while len(self.finished) < n:
            if self.t > max_ticks:
                raise RuntimeError(f"exceeded {max_ticks} ticks "
                                   f"({len(self.finished)}/{n} done)")
            arrivals = []
            while i < n and workload[i].arrival <= self.t:
                r = workload[i]
                if prompts is not None and r.rid in prompts:
                    r._prompt = np.asarray(prompts[r.rid])
                arrivals.append(r)
                i += 1
            self.tick(arrivals)
        return sorted(self.finished, key=lambda r: r.rid)


# ---------------------------------------------------------------------------
# Result metrics (mirrors repro.core.metrics for cross-validation)
# ---------------------------------------------------------------------------


def turnarounds(reqs: Sequence[Request]) -> np.ndarray:
    return np.array([r.turnaround for r in reqs], dtype=np.float64)


def rtes(reqs: Sequence[Request]) -> np.ndarray:
    return np.array([r.rte for r in reqs], dtype=np.float64)


def summarize(reqs: Sequence[Request]) -> dict:
    ta = turnarounds(reqs)
    return {
        "n": len(reqs),
        "mean_turnaround": float(ta.mean()),
        "median_turnaround": float(np.median(ta)),
        "p99_turnaround": float(np.percentile(ta, 99)),
        "mean_rte": float(rtes(reqs).mean()),
        "frac_rte_095": float((rtes(reqs) >= 0.95).mean()),
        "total_ctx": int(sum(r.n_ctx for r in reqs)),
        "demoted_frac": float(np.mean([r.demoted for r in reqs])),
    }
