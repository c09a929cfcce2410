from repro_torch.serving.cluster import Cluster, ClusterConfig, ClusterFrontend
from repro_torch.serving.engine import Engine, EngineConfig, summarize
from repro_torch.serving.request import Request
from repro_torch.serving.router import Router
from repro_torch.serving.schedulers import make_scheduler
from repro_torch.serving.vector_cluster import VectorCluster

__all__ = ["Cluster", "ClusterConfig", "ClusterFrontend", "Engine",
           "EngineConfig", "Request", "Router", "VectorCluster",
           "make_scheduler", "summarize"]
