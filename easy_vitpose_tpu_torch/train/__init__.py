"""Training: losses, the fused clip + Adam optimizer (K8) and the step."""
