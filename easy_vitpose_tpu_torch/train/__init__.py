"""Training: the dataset, losses, the optimizers (the fused clip + Adam, K8
and K9, and the optax chains), the step, full-state checkpoints, presets
and the epoch loop."""
