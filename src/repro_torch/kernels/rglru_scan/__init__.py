"""The RG-LRU linear recurrence as one CUDA kernel (Hopper), with its
plain PyTorch versions."""
