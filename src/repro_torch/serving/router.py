"""Front-tier router for multi-replica SFS serving.

A copy of ``repro.serving.router`` (the JAX package's module): a thin
veneer over :mod:`repro_torch.serving.cluster`, whose ``Cluster``
generalizes dispatch to pluggable policies (``hash`` — the router's
behaviour and still its default — ``least-outstanding``, ``pull``,
``sfs-aware``).  ``repro_torch.launch.serve --replicas N`` drives it over
engines that share one model.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.serving.cluster import Cluster, ClusterConfig
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request


class Router:
    """``Router(engines)`` == hash-policy Cluster."""

    def __init__(self, engines: Sequence[Engine], policy: str = "hash",
                 cfg: Optional[ClusterConfig] = None):
        self.engines = list(engines)
        if cfg is None:
            cfg = ClusterConfig(policy=policy)
        self.cluster = Cluster(self.engines, cfg)

    def outstanding(self, e: Engine) -> int:
        return e.outstanding()

    def route(self, req: Request) -> Optional[int]:
        return self.cluster.route(req)

    def run(self, workload: Sequence[Request],
            max_ticks: int = 1_000_000) -> list[Request]:
        """Lock-step tick all replicas over a shared arrival stream."""
        return self.cluster.run(workload, max_ticks=max_ticks)
