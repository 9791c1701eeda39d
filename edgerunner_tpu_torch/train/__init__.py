"""Training of the port: optimizer, trainer and checkpoints."""
