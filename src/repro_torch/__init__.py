"""ASC-Hook on PyTorch + CUDA: the port of :mod:`repro` to one NVIDIA H100.

The JAX package (:mod:`repro`) is the reference; this package mirrors its
layout and names and never imports it (nor JAX).  Ported so far: image
preparation (scan, hybrid rewrite, trampolines), the fleet's untraced
executor for lanes with guest-kernel emulation off, its run-to-halt and
bounded-span drivers, and the CUDA megastep kernel they dispatch to.
"""
