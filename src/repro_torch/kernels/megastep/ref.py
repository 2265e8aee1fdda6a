"""The plain PyTorch version of the megastep chunk.

It is ``chunk`` iterations of the port's eager, lane-vectorised
:func:`repro_torch.core.fleet._step_core` — the line-by-line translation
of the JAX package's ``exec_lanes``.  The CPU path and the tests run it;
on the card it serves only to check the CUDA kernel.
"""
from __future__ import annotations

from ...core import fleet as F
from ...core.machine import MachineState


def megastep_chunk_ref(imgs: F.FleetImages, ids, s: MachineState, *,
                       chunk: int) -> MachineState:
    """``chunk`` masked steps.  ``s.mem`` is updated in place; the other
    leaves of the returned state are fresh tensors."""
    for _ in range(chunk):
        if not bool(F._alive(s).any()):
            break  # masked steps are the identity
        s = F._step_core(imgs, ids, s)
    return s
