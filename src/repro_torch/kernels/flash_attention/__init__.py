"""Flash attention forward as one CUDA kernel (Hopper), with its plain
PyTorch version."""
