"""The LM substrate of the PyTorch port: layers, the decoder-only model
and parameter interop with the JAX package's trees."""
