from repro_torch.sharding.plan import (Plan, current_plan, param_specs,
                                       shard, shard_model, use_plan)

__all__ = ["Plan", "current_plan", "param_specs", "shard", "shard_model",
           "use_plan"]
