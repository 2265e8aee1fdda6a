"""ASC-Hook on PyTorch + CUDA: the port of :mod:`repro` to one NVIDIA H100.

The JAX package (:mod:`repro`) is the reference; this package mirrors its
layout and names and never imports it (nor JAX).  Ported so far: image
preparation (scan, hybrid rewrite, trampolines), the whole fleet executor
— guest-kernel emulation (:mod:`repro_torch.emul`), syscall tracing and
seccomp-style policy (:mod:`repro_torch.trace`) — its drivers, lane
sharding across cards (:mod:`repro_torch.parallel`), the fleet server
with durability and chaos (:mod:`repro_torch.serve`), and the CUDA
megastep kernel they dispatch to; and the LM serving path for every
model family the JAX package defines (:mod:`repro_torch.configs`,
:mod:`repro_torch.models`, :mod:`repro_torch.serve`): attention runs on
the card through the CUDA flash-attention and flash-decode kernels,
recurrentgemma's RG-LRU scan through the CUDA rglru_scan kernel, the
mLSTM through the CUDA mlstm_chunk kernels; the MoE's routing and
experts are PyTorch operations; and training (:mod:`repro_torch.data`,
:mod:`repro_torch.optim`, :mod:`repro_torch.train`,
``python -m repro_torch.launch.train``), which runs the models' plain
forms under autograd on every device, as the JAX package trains through
its XLA forms.  :mod:`repro_torch.numerics` rounds the CPU route's f32
arithmetic as the JAX package's CPU backend does, differentiably.
"""
