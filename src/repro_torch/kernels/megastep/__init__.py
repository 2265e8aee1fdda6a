"""Megastep: the fleet's inner chunk loop as one CUDA kernel (Hopper)."""
