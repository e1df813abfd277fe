"""Port twins of the JAX package's ``examples/`` drivers: run each with
``python -m repro_torch.examples.<name> [--device cpu]``."""
