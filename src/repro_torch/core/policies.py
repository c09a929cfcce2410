"""Convenience constructors for the scheduling policies evaluated in the paper.

A copy of ``repro.core.policies`` (the JAX package's module).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.simulator import SimConfig

ALL_POLICIES = ("ideal", "srtf", "sfs", "cfs", "rr", "fifo")


def sfs(cores: int = 12, *, slice_s: Optional[float] = None,
        adaptive_window: int = 100, overload_factor: Optional[float] = 3.0,
        io_aware: bool = True, poll_interval_s: float = 0.004) -> SimConfig:
    """The paper's scheduler.  ``slice_s=None`` => adaptive S (§V-C)."""
    return SimConfig(cores=cores, policy="sfs", slice_s=slice_s,
                     adaptive_window=adaptive_window,
                     overload_factor=overload_factor, io_aware=io_aware,
                     poll_interval_s=poll_interval_s)


def cfs(cores: int = 12, *, latency_s: float = 0.024,
        min_gran_s: float = 0.003) -> SimConfig:
    return SimConfig(cores=cores, policy="cfs", cfs_latency_s=latency_s,
                     cfs_min_gran_s=min_gran_s)


def fifo(cores: int = 12) -> SimConfig:
    return SimConfig(cores=cores, policy="fifo")


def rr(cores: int = 12, *, quantum_s: float = 0.1) -> SimConfig:
    return SimConfig(cores=cores, policy="rr", rr_quantum_s=quantum_s)


def srtf(cores: int = 12) -> SimConfig:
    return SimConfig(cores=cores, policy="srtf")


def ideal(cores: int = 12) -> SimConfig:
    return SimConfig(cores=cores, policy="ideal")


def make(policy: str, cores: int = 12, **kw) -> SimConfig:
    return {"sfs": sfs, "cfs": cfs, "fifo": fifo, "rr": rr, "srtf": srtf,
            "ideal": ideal}[policy](cores, **kw)
