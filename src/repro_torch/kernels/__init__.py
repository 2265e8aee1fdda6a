"""Hand-written Hopper kernels of the PyTorch port."""
