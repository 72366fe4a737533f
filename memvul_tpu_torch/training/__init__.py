"""Training the memory model: optimizer, metrics, checkpoints, trainer."""
