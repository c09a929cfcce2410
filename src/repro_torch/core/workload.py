"""FaaSBench workload generation and the tick family's workload stages.

A copy of ``repro.core.workload`` (the JAX package's module).

FaaSBench reproduces the paper's §VII methodology for the discrete-event
simulator (:mod:`repro_torch.core.simulator`):

* Function duration follows the multimodal distribution of Azure Day-1
  invocations (Table I of the paper).  We simulate *durations* directly
  rather than calibrating ``fib(N)`` — the mapping in Table I exists only to
  realize a target duration on real hardware.
* Inter-arrival times (IATs) are configurable: ``poisson`` (exponential),
  ``uniform``, or ``trace`` (lognormal bursts that mimic the transient
  overload spikes of Fig. 12).
* The ``io`` knob toggles a single leading I/O operation of U[10,100] ms on a
  configurable fraction of requests (§VIII-B "Handling I/O").

Loads are expressed as target per-core utilization rho; the generator solves
lambda = rho * c / E[service] and scales IATs accordingly.  Its
:class:`Request` (seconds, immutable) is the DES's; the tick family's
mutable serving request is :class:`repro_torch.serving.request.Request`.

Registered workload stages of the tick family (``WORKLOAD_REGISTRY``)
compose through the WorkloadSpec pipe grammar
(``"bimodal:n=800|zipf:funcs=16|flash:at=600,x=4"``): the first stage is
a *generator* (``generate(total_lanes) -> [serving Request]``) and every
later stage a *transform* (``apply(reqs, total_lanes) -> same list``,
mutated in place).  All stages operate on the mutable serving
:class:`~repro_torch.serving.request.Request`; transforms are
deterministic given their knobs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.spec import WORKLOAD_REGISTRY, TickWorkloadSpec

# ---------------------------------------------------------------------------
# Request model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Request:
    """A single function invocation.

    ``io_events`` is a tuple of ``(cpu_offset_s, io_duration_s)`` pairs: after
    the job has consumed ``cpu_offset_s`` seconds of CPU it blocks for
    ``io_duration_s`` seconds of I/O (off-CPU).
    """

    rid: int
    arrival: float                      # seconds since workload start
    service: float                      # total CPU demand, seconds
    io_events: tuple = ()               # ((cpu_offset, io_dur), ...)
    func_id: int = 0                    # which app/function this invokes —
                                        # the key duration predictors learn
                                        # on (repro.core.predict); 0 for
                                        # legacy anonymous workloads

    @property
    def total_io(self) -> float:
        return float(sum(d for _, d in self.io_events))

    @property
    def ideal_turnaround(self) -> float:
        """Turnaround on an idle, infinitely-parallel machine (IDEAL)."""
        return self.service + self.total_io


# ---------------------------------------------------------------------------
# Azure Table-I duration distribution
# ---------------------------------------------------------------------------

# (probability, lo_ms, hi_ms).  Table I covers 95.6 % of mass; the paper notes
# every missing range holds <1 % each — we place the remaining 4.4 % in the
# (400, 1550) ms gap, log-uniform, which matches Fig. 1's smooth CDF there.
#
# The >=1550 ms bucket is realized by fib(N) for N in {34, 35} (Table I),
# i.e. ~1.55-3.5 s of CPU — NOT the full Azure tail.  This cap is visible in
# the paper's own data: CFS p99.9 = 3.3 s under 50 % load (Fig. 8) can only
# happen if the longest benchmark functions are ~3 s.  The "17 % relatively
# longer functions" of the headline claim = this bucket.
AZURE_TABLE_I = (
    (0.406, 1.0, 50.0),
    (0.098, 50.0, 100.0),
    (0.068, 100.0, 200.0),
    (0.227, 200.0, 400.0),
    (0.044, 400.0, 1550.0),
    (0.157, 1550.0, 3_500.0),    # fib(34-35) realization of the >=1.55s bucket
)

# The raw Azure Day-1 tail (up to the 99.9th-pct 224 s) for Fig.-1 analysis.
AZURE_TABLE_I_RAW_TAIL = AZURE_TABLE_I[:-1] + ((0.157, 1550.0, 224_000.0),)


def _sample_durations(rng: np.random.Generator, n: int,
                      table: Sequence = AZURE_TABLE_I) -> np.ndarray:
    probs = np.array([p for p, _, _ in table], dtype=np.float64)
    probs = probs / probs.sum()
    bucket = rng.choice(len(table), size=n, p=probs)
    lo = np.array([b[1] for b in table])[bucket]
    hi = np.array([b[2] for b in table])[bucket]
    # log-uniform within a bucket: matches the heavy intra-bucket skew of the
    # Azure CDF far better than uniform.
    u = rng.random(n)
    ms = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    return ms / 1e3  # seconds


# ---------------------------------------------------------------------------
# Per-function duration model (duration-predictor workloads)
# ---------------------------------------------------------------------------


def function_table(n_functions: int, table: Sequence = AZURE_TABLE_I):
    """Partition a duration table into ``n_functions`` app models.

    Functions are apportioned to Table-I buckets by bucket mass (largest
    remainder, at least one per bucket), and the functions of a bucket
    split its [lo, hi) range into equal log-width sub-ranges.  Each
    function's invocations are log-uniform within its own narrow
    sub-range — stable per-function durations (what execution-history
    predictors exploit, per Przybylski et al.) while the *aggregate*
    duration distribution stays exactly the table's: bucket masses are
    unchanged, and uniform function choice over equal log-segments
    composes back to log-uniform within each bucket.

    Returns ``(lo_ms, hi_ms, bucket, offset)`` arrays: per-function
    sub-range and bucket, plus ``offset[b]`` = first func_id of bucket b.
    """
    k = len(table)
    if n_functions < k:
        raise ValueError(f"n_functions={n_functions} < {k} buckets — "
                         "need at least one function per bucket")
    probs = np.array([p for p, _, _ in table], dtype=np.float64)
    probs = probs / probs.sum()
    counts = np.ones(k, dtype=int)
    quota = probs * (n_functions - k)
    counts += quota.astype(int)
    frac = quota - quota.astype(int)
    for b in np.argsort(-frac)[:n_functions - counts.sum()]:
        counts[b] += 1
    lo_f, hi_f, bucket_f = [], [], []
    for b, (_, lo, hi) in enumerate(table):
        edges = np.exp(np.linspace(np.log(lo), np.log(hi), counts[b] + 1))
        lo_f += list(edges[:-1])
        hi_f += list(edges[1:])
        bucket_f += [b] * counts[b]
    offset = np.concatenate(([0], np.cumsum(counts)[:-1]))
    return (np.array(lo_f), np.array(hi_f), np.array(bucket_f, dtype=int),
            offset)


def _sample_durations_per_function(rng: np.random.Generator, n: int,
                                   table: Sequence, n_functions: int):
    """Sample ``(service_s, func_id)`` under the per-function model."""
    lo_f, hi_f, _, offset = function_table(n_functions, table)
    probs = np.array([p for p, _, _ in table], dtype=np.float64)
    probs = probs / probs.sum()
    counts = np.diff(np.concatenate((offset, [n_functions])))
    bucket = rng.choice(len(table), size=n, p=probs)
    func = offset[bucket] + (rng.random(n)
                             * counts[bucket]).astype(int)
    u = rng.random(n)
    ms = np.exp(np.log(lo_f[func])
                + u * (np.log(hi_f[func]) - np.log(lo_f[func])))
    return ms / 1e3, func


# ---------------------------------------------------------------------------
# FaaSBench generator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaaSBenchConfig:
    n_requests: int = 10_000
    cores: int = 12
    load: float = 1.0                    # target per-core utilization rho
    iat: str = "poisson"                 # poisson | uniform | trace
    duration_table: Sequence = AZURE_TABLE_I
    io_fraction: float = 0.0             # fraction of requests with an I/O op
    io_ms_range: tuple = (10.0, 100.0)
    seed: int = 0
    # per-function app model: partition the duration table into this many
    # functions (predictable per-function durations, same aggregate
    # distribution) and stamp func_id on each request.  0 = legacy
    # anonymous workload (func_id 0 everywhere, identical RNG stream).
    n_functions: int = 0
    # trace-IAT burstiness (Fig. 12): lognormal sigma and spike injection
    trace_sigma: float = 1.6
    n_spikes: int = 5
    spike_size: int = 120                # requests per spike
    spike_iat_s: float = 1e-3


def _spike_windows(rng: np.random.Generator, n: int, n_spikes: int,
                   spike_size: int) -> np.ndarray:
    """Start indices of non-overlapping spike windows inside ``range(n)``.

    Clamps the spike count/size to what fits (small smoke workloads used
    to crash ``rng.choice`` here), and guarantees disjoint windows: draw
    sorted distinct offsets from the index space with all window widths
    removed, then re-inflate by one window width per preceding spike.
    """
    size = spike_size
    if size <= 0 or n_spikes <= 0 or size > n:
        return np.empty(0, dtype=int)
    k = min(n_spikes, n // size)
    while k > 0 and n - k * size + 1 < k:
        k -= 1
    if k == 0:
        return np.empty(0, dtype=int)
    offsets = np.sort(rng.choice(n - k * size + 1, size=k, replace=False))
    return offsets + np.arange(k) * size


def generate(cfg: FaaSBenchConfig) -> list[Request]:
    """Generate a reproducible FaaS workload."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_requests
    if cfg.n_functions > 0:
        service, func_ids = _sample_durations_per_function(
            rng, n, cfg.duration_table, cfg.n_functions)
    else:
        service = _sample_durations(rng, n, cfg.duration_table)
        func_ids = np.zeros(n, dtype=int)
    mean_service = float(service.mean())

    # lambda = rho * c / E[S]  (Eq. 2 of the paper, solved for arrival rate)
    # NOTE: normalized below so the *empirical* offered load equals cfg.load
    # exactly — near rho = 1 the queueing behaviour is dominated by the
    # drift term, so sampling noise of a few percent changes the regime.
    lam = cfg.load * cfg.cores / mean_service
    mean_iat = 1.0 / lam

    spike_mask = np.zeros(n, dtype=bool)
    if cfg.iat == "poisson":
        iats = rng.exponential(mean_iat, size=n)
    elif cfg.iat == "uniform":
        iats = rng.uniform(0.0, 2.0 * mean_iat, size=n)
    elif cfg.iat == "trace":
        # lognormal IATs (bursty) + a few dense, disjoint spikes.  Spike
        # IATs stay pinned at spike_iat_s through the exact-load rescale
        # below — a spike whose density gets renormalized away is no
        # longer a transient-overload spike (Fig. 12).
        mu = math.log(mean_iat) - 0.5 * cfg.trace_sigma ** 2
        iats = rng.lognormal(mu, cfg.trace_sigma, size=n)
        for s in _spike_windows(rng, n, cfg.n_spikes, cfg.spike_size):
            spike_mask[s:s + cfg.spike_size] = True
        iats[spike_mask] = cfg.spike_iat_s
    else:
        raise ValueError(f"unknown iat kind: {cfg.iat!r}")

    # exact-load normalization: scale IATs so busy/(span*cores) == load,
    # where span is the first-to-last-arrival window (what offered_load
    # measures) — the first IAT only offsets the start time, so it is
    # excluded from the span budget.  Spike IATs are held fixed and the
    # remaining (non-spike) IATs absorb the whole rescale, unless the
    # spikes alone exceed the span budget (degenerate config: fall back
    # to scaling everything rather than emit a wrong total load).
    span_target = service.sum() / (cfg.load * cfg.cores)
    spike_tail = float(iats[1:][spike_mask[1:]].sum())
    plain_tail = float(iats[1:][~spike_mask[1:]].sum())
    if spike_mask.any() and plain_tail > 0 and span_target > spike_tail:
        scale = (span_target - spike_tail) / plain_tail
        iats = np.where(spike_mask, iats, iats * scale)
    else:
        tail = iats[1:].sum()
        iats = iats * (span_target / tail) if tail > 0 else iats
    arrivals = np.cumsum(iats)
    has_io = rng.random(n) < cfg.io_fraction
    io_dur = rng.uniform(cfg.io_ms_range[0], cfg.io_ms_range[1], size=n) / 1e3

    out = []
    for i in range(n):
        io = ((0.0, float(io_dur[i])),) if has_io[i] else ()
        out.append(Request(rid=i, arrival=float(arrivals[i]),
                           service=float(service[i]), io_events=io,
                           func_id=int(func_ids[i])))
    return out


def offered_load(reqs: Sequence[Request], cores: int) -> float:
    """Empirical rho of a generated workload (sanity check for tests)."""
    span = reqs[-1].arrival - reqs[0].arrival
    busy = sum(r.service for r in reqs)
    return busy / (span * cores) if span > 0 else float("inf")


# ---------------------------------------------------------------------------
# Registered workload stages (WORKLOAD_REGISTRY, repro_torch.core.spec)
# ---------------------------------------------------------------------------

# the legacy bimodal tick workload is just the first registered
# generator, not a special case
WORKLOAD_REGISTRY.register("bimodal")(TickWorkloadSpec)


@WORKLOAD_REGISTRY.register("zipf")
class ZipfPopularity:
    """Assign ``func_id`` by Zipf(s) popularity over ``funcs`` functions.

    Rank-1 is the most popular; weights are ``rank**-s`` normalized.
    Stresses warm-set keep-alive (popular functions stay warm, the tail
    cold-starts) and the per-function duration predictors.
    """

    def __init__(self, funcs: int = 16, s: float = 1.1, seed: int = 101):
        if funcs < 1:
            raise ValueError("zipf needs funcs >= 1")
        self.funcs, self.s, self.seed = int(funcs), float(s), int(seed)

    def apply(self, reqs, total_lanes):
        ranks = np.arange(1, self.funcs + 1, dtype=np.float64)
        p = ranks ** -self.s
        p /= p.sum()
        rng = np.random.default_rng(self.seed)
        fids = rng.choice(self.funcs, size=len(reqs), p=p)
        for r, f in zip(reqs, fids.tolist()):
            r.func_id = int(f)
        return reqs


@WORKLOAD_REGISTRY.register("drift")
class DurationDrift:
    """Duration-regime drift: from arrival time ``at`` on, every
    request's decode demand scales by ``x`` (the case that stresses
    history/class predictors — Przybylski et al.).  Front-end hints
    track the new demand so oracle parity is preserved."""

    def __init__(self, at: int = 0, x: float = 2.0):
        if x <= 0:
            raise ValueError("drift needs x > 0")
        self.at, self.x = int(at), float(x)

    def apply(self, reqs, total_lanes):
        for r in reqs:
            if r.arrival >= self.at:
                r.n_tokens = max(1, int(r.n_tokens * self.x))
                if r.eta_hint is not None:
                    r.eta_hint = r.n_tokens + 1
        return reqs


@WORKLOAD_REGISTRY.register("flash")
class FlashCrowd:
    """Flash crowd: arrivals inside ``[at, at+dur)`` are compressed
    ``x``-fold toward ``at`` and the tail shifts left to close the gap,
    so the same requests land ``x`` times as densely (a transient
    overload spike, Fig. 12 style) without changing total work."""

    def __init__(self, at: int = 0, x: float = 4.0, dur: int = 100):
        if x < 1:
            raise ValueError("flash needs x >= 1")
        if dur < 1:
            raise ValueError("flash needs dur >= 1")
        self.at, self.x, self.dur = int(at), float(x), int(dur)

    def apply(self, reqs, total_lanes):
        shift = int(self.dur - self.dur / self.x)
        for r in reqs:
            if self.at <= r.arrival < self.at + self.dur:
                r.arrival = self.at + int((r.arrival - self.at) / self.x)
            elif r.arrival >= self.at + self.dur:
                r.arrival -= shift
        return reqs


@WORKLOAD_REGISTRY.register("diurnal")
class DiurnalModulation:
    """Sinusoidal arrival-time warp with period ``period`` and
    amplitude ``amp`` (< 1 keeps the warp monotone: the instantaneous
    rate swings between ``1/(1+amp)`` and ``1/(1-amp)`` of nominal)."""

    def __init__(self, period: int = 500, amp: float = 0.5):
        if period < 1:
            raise ValueError("diurnal needs period >= 1")
        if not 0.0 <= amp < 1.0:
            raise ValueError("diurnal needs 0 <= amp < 1")
        self.period, self.amp = int(period), float(amp)

    def apply(self, reqs, total_lanes):
        w = 2.0 * math.pi / self.period
        for r in reqs:
            r.arrival = max(0, int(r.arrival
                                   + self.amp / w * math.sin(w * r.arrival)))
        return reqs
