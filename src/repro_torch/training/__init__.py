"""Training of the port: optimizer, train step, checkpoints."""
