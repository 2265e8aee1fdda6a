"""Hand-written Hopper kernels of the PyTorch port.

No kernel has a backward (nor has any TPU kernel of the JAX package):
:func:`refuse_grad` makes each wrapper raise, rather than launch, when
autograd would record its output, so no detached kernel output ever
reaches a loss.  Training runs the models' plain forms
(:func:`repro_torch.models.layers.xla_route`).
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` when grad mode is on and any of ``tensors``
    requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: no backward kernel; train through the "
                           "XLA route (repro_torch.models.layers.xla_route)")
