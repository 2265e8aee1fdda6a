"""Optimizer and gradient compression of the PyTorch port (``adamw``,
``compress``): the JAX package's ``repro.optim``."""
