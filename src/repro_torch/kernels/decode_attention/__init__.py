"""Flash-decode as one CUDA kernel (Hopper), with its plain PyTorch
version."""
