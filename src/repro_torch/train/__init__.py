"""Training in the port: the optimizers, the train step with its three
gradient-accumulation modes, int8 error feedback, synthetic data,
checkpoints in the reference's layout and a step watchdog."""
