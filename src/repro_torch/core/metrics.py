"""Percentiles and per-service-bucket turnaround statistics.

The parts of ``repro.core.metrics`` (the JAX package's module) that read
plain arrays: ``percentiles``, ``bucket_labels``, ``bucket_stats`` and the
default bucket edges.  The rest of that module reads the DES simulator's
``SimResult``, which is not ported.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["DEFAULT_BUCKET_EDGES_S", "DEFAULT_BUCKET_EDGES_T",
           "bucket_labels", "bucket_stats", "percentiles"]


def percentiles(x: np.ndarray, ps=(50, 90, 99, 99.9)) -> dict:
    """NaN-safe on empty input (np.percentile raises on []) — a filtered
    bucket or an empty sweep cell yields NaNs, not a crash."""
    x = np.asarray(x)
    if x.size == 0:
        return {p: float("nan") for p in ps}
    return {p: float(np.percentile(x, p)) for p in ps}


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
