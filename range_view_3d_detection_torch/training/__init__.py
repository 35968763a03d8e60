"""Training: optimizer and schedule, train state and steps, checkpoints."""
