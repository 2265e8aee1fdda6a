"""Serving on the PyTorch port: the batched LM engine."""
