"""Training in the port: the optimizers, the train step with its three
gradient-accumulation modes, int8 error feedback, synthetic data,
checkpoints in the reference's layout, elastic re-mesh and a step
watchdog; a train state may be sharded by a ``repro_torch.sharding``
plan."""
