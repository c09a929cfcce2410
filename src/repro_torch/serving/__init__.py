from repro_torch.serving.engine import Engine, EngineConfig, summarize
from repro_torch.serving.request import Request
from repro_torch.serving.schedulers import make_scheduler

__all__ = ["Engine", "EngineConfig", "Request", "make_scheduler",
           "summarize"]
