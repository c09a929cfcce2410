"""Metrics for scheduler evaluation: RTE, percentiles, paper headline stats.

A copy of ``repro.core.metrics`` (the JAX package's module).  The
bucket statistics read plain arrays and serve the tick family too; the
rest reads the discrete-event simulator's ``SimResult``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.simulator import SimResult


def turnarounds(res: SimResult) -> np.ndarray:
    return np.array([s.turnaround for s in res.stats])


def rtes(res: SimResult) -> np.ndarray:
    return np.array([s.rte for s in res.stats])


def percentiles(x: np.ndarray, ps=(50, 90, 99, 99.9)) -> dict:
    """NaN-safe on empty input (np.percentile raises on []) — a filtered
    bucket or an empty sweep cell yields NaNs, not a crash."""
    x = np.asarray(x)
    if x.size == 0:
        return {p: float("nan") for p in ps}
    return {p: float(np.percentile(x, p)) for p in ps}


def cdf(x: np.ndarray, n: int = 200):
    """(xs, ys) suitable for plotting/inspection; empty in, empty out."""
    xs = np.sort(np.asarray(x))
    if xs.size == 0:
        return xs, np.array([], dtype=np.float64)
    ys = np.arange(1, len(xs) + 1) / len(xs)
    idx = np.linspace(0, len(xs) - 1, min(n, len(xs))).astype(int)
    return xs[idx], ys[idx]


def frac_rte_below(res: SimResult, thr: float) -> float:
    r = rtes(res)
    return float((r < thr).mean())


def frac_rte_atleast(res: SimResult, thr: float) -> float:
    r = rtes(res)
    return float((r >= thr).mean())


@dataclasses.dataclass
class HeadlineComparison:
    """The paper's headline claim format (§I): vs a baseline, the fraction of
    functions improved, their mean speedup, and the slowdown of the rest."""
    frac_improved: float
    mean_speedup_improved: float      # arithmetic mean, as in the paper
    geomean_speedup_improved: float
    frac_regressed: float
    mean_slowdown_regressed: float


def compare(treat: SimResult, base: SimResult,
            tol: float = 1.0) -> HeadlineComparison:
    """Per-request turnaround of ``treat`` (e.g. SFS) vs ``base`` (e.g. CFS)."""
    t = turnarounds(treat)
    b = turnarounds(base)
    assert len(t) == len(b)
    ratio = b / np.maximum(t, 1e-12)          # >1 => treat faster
    improved = ratio > tol
    regressed = ~improved
    sp = ratio[improved]
    sl = (1.0 / ratio)[regressed]
    return HeadlineComparison(
        frac_improved=float(improved.mean()),
        mean_speedup_improved=float(sp.mean()) if sp.size else 1.0,
        geomean_speedup_improved=float(np.exp(np.log(sp).mean()))
        if sp.size else 1.0,
        frac_regressed=float(regressed.mean()),
        mean_slowdown_regressed=float(sl.mean()) if sl.size else 1.0,
    )


# ---------------------------------------------------------------------------
# Per-duration-bucket breakdowns (cluster sweeps): the paper's headline is
# about *short* functions, so aggregate percentiles hide the effect — split
# by service demand instead.
# ---------------------------------------------------------------------------

DEFAULT_BUCKET_EDGES_S = (0.1, 1.0)     # short < 100 ms <= medium < 1 s <= long
# tick-engine edges (ticks = decode tokens): straddle the bimodal
# synthetic workload (short 2-8, long 30-80)
DEFAULT_BUCKET_EDGES_T = (10, 40)


def bucket_labels(edges: Sequence[float], unit: str = "s") -> list:
    edges = list(edges)
    labels = [f"<{edges[0]:g}{unit}"]
    labels += [f"{lo:g}-{hi:g}{unit}" for lo, hi in zip(edges, edges[1:])]
    labels.append(f">={edges[-1]:g}{unit}")
    return labels


def bucket_stats(service, turnaround, rte=None,
                 edges: Sequence[float] = DEFAULT_BUCKET_EDGES_S,
                 ps=(50, 99), unit: str = "s") -> dict:
    """Percentile turnaround (and mean RTE) per service-demand bucket.

    Works on plain arrays so both the DES (seconds) and the tick engine
    (ticks — pass matching ``edges``/``unit``) share it.
    """
    service = np.asarray(service, dtype=np.float64)
    turnaround = np.asarray(turnaround, dtype=np.float64)
    idx = np.digitize(service, np.asarray(edges, dtype=np.float64))
    out = {}
    for b, label in enumerate(bucket_labels(edges, unit)):
        m = idx == b
        row = {"n": int(m.sum())}
        for p in ps:
            row[f"p{p:g}"] = (float(np.percentile(turnaround[m], p))
                              if m.any() else float("nan"))
        if rte is not None and m.any():
            row["mean_rte"] = float(np.asarray(rte)[m].mean())
        out[label] = row
    return out


def result_bucket_stats(res: SimResult, **kw) -> dict:
    svc = np.array([s.service for s in res.stats])
    return bucket_stats(svc, turnarounds(res), rtes(res), **kw)


def mean_turnaround(res: SimResult) -> float:
    return float(turnarounds(res).mean())


def median_turnaround(res: SimResult) -> float:
    return float(np.median(turnarounds(res)))
