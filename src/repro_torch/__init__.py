"""PyTorch/CUDA port of the SFS serving stack.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and numpy, never JAX and nothing of ``repro``.  Its entry points
run on the CUDA card unless the caller asks for the CPU.

``run_experiment(ExperimentSpec(servers=..., workload=...))`` drives the
fleet-stepping backend (:mod:`repro_torch.serving.torch_cluster`), or with
``engine="tick"`` / ``"vector"`` the host backends
(:mod:`repro_torch.serving.cluster`,
:mod:`repro_torch.serving.vector_cluster`);
:mod:`repro_torch.launch.serve` drives one engine with a real model, or
N replicas of it behind a :class:`Router` (``--replicas N``);
:mod:`repro_torch.launch.train` trains one (:mod:`repro_torch.train`).
It exports the reference's public API (``repro.__all__``) beside the
host cluster and the router.
"""
from repro_torch.core.spec import (DispatchSpec, ExperimentResult,
                                   ExperimentSpec, PredictorSpec,
                                   SchedulerSpec, ServerSpec,
                                   TickWorkloadSpec, run_experiment)
from repro_torch.serving import Cluster, ClusterConfig, Router

__all__ = ["Cluster", "ClusterConfig", "DispatchSpec", "ExperimentResult",
           "ExperimentSpec", "PredictorSpec", "Router", "SchedulerSpec",
           "ServerSpec", "TickWorkloadSpec", "run_experiment"]
