"""Training: the reference's optimizer, the step, the trainer and metrics."""
