"""Training on the PyTorch port: the step (``step``) and the
fault-tolerant loop (``loop``), the JAX package's ``repro.train``."""
