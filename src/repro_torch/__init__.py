"""ASC-Hook on PyTorch + CUDA: the port of :mod:`repro` to one NVIDIA H100.

The JAX package (:mod:`repro`) is the reference; this package mirrors its
layout and names and never imports it (nor JAX).  Ported so far: image
preparation (scan, hybrid rewrite, trampolines), the whole fleet executor
— guest-kernel emulation (:mod:`repro_torch.emul`), syscall tracing and
seccomp-style policy (:mod:`repro_torch.trace`) — its run-to-halt and
bounded-span drivers, and the CUDA megastep kernel they dispatch to; and
the LM serving path for the decoders without experts, encoder, frontend
or xLSTM blocks (:mod:`repro_torch.configs`, :mod:`repro_torch.models`,
:mod:`repro_torch.serve`): attention runs on the card through the CUDA
flash-attention and flash-decode kernels, recurrentgemma's RG-LRU scan
through the CUDA rglru_scan kernel.  :mod:`repro_torch.numerics` rounds
the CPU route's f32 arithmetic as the JAX package's CPU backend does.
"""
