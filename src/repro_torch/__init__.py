"""PyTorch/CUDA port of the SFS serving stack.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and numpy, never JAX and nothing of ``repro``.  Its entry points
run on the CUDA card unless the caller asks for the CPU.

``run_experiment(ExperimentSpec(servers=..., workload=...))`` drives the
fleet-stepping backend (:mod:`repro_torch.serving.torch_cluster`);
:mod:`repro_torch.launch.serve` drives one engine with a real model.
"""
from repro_torch.core.spec import ExperimentSpec, ServerSpec, run_experiment

__all__ = ["ExperimentSpec", "ServerSpec", "run_experiment"]
