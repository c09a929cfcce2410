"""repro_torch.core — the paper's contribution: SFS two-level scheduling.

The same public API as the JAX package's ``repro.core``:
  spec.ExperimentSpec / run_experiment — unified experiment-spec layer
  workload.FaaSBenchConfig / generate  — FaaSBench (§VII)
  simulator.SimConfig / simulate       — discrete-event multicore simulator
  simulator.ClusterSimConfig / simulate_cluster — multi-server mode
  dispatch.make_dispatch               — cluster dispatch policies
  predict.make_predictor / EtaPredictor — online duration prediction
  policies.{sfs,cfs,fifo,rr,srtf,ideal} — policy constructors
  metrics                              — RTE / turnaround / headline stats
"""
from repro_torch.core.workload import FaaSBenchConfig, Request, generate
from repro_torch.core.spec import (DispatchSpec, ExperimentResult,
                                   ExperimentSpec, PredictorSpec,
                                   SchedulerSpec, ServerSpec,
                                   TickWorkloadSpec, run_experiment)
from repro_torch.core.simulator import (ClusterSimConfig, ClusterSimResult,
                                        SimConfig, SimResult, JobStats,
                                        simulate, simulate_cluster)
from repro_torch.core.dispatch import make_dispatch, route_hinted
from repro_torch.core.predict import EtaPredictor, make_predictor
from repro_torch.core import dispatch, policies, predict, metrics, spec

__all__ = ["FaaSBenchConfig", "Request", "generate", "SimConfig",
           "SimResult", "JobStats", "simulate", "ClusterSimConfig",
           "ClusterSimResult", "simulate_cluster", "make_dispatch",
           "route_hinted", "EtaPredictor", "make_predictor",
           "DispatchSpec", "ExperimentResult", "ExperimentSpec",
           "PredictorSpec", "SchedulerSpec", "ServerSpec",
           "TickWorkloadSpec", "run_experiment",
           "dispatch", "policies", "predict", "metrics", "spec"]
