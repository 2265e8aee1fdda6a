"""The plain PyTorch version of the megastep chunk.

It is ``chunk`` iterations of the port's eager, lane-vectorised
:func:`repro_torch.core.fleet._step_core` — the line-by-line translation
of the JAX package's ``exec_lanes``, guest-kernel service and trace
branch included.  The CPU path and the tests run it; on the card it
serves only to check the CUDA kernel.
"""
from __future__ import annotations

from typing import Optional

from ...core import fleet as F
from ...core.machine import MachineState


def megastep_chunk_ref(imgs: F.FleetImages, ids, s: MachineState,
                       tr: Optional[F.TraceState] = None, *, chunk: int):
    """``chunk`` masked steps.  The big planes (``mem``, ``k_ino_data``,
    ``tr.buf``, ``tr.hist``) are updated in place; the other leaves of the
    result are fresh tensors.  Returns the state, or ``(state, trace)``
    with a trace carry."""
    for _ in range(chunk):
        if not bool(F._alive(s).any()):
            break  # masked steps are the identity
        s, tr = F._step_core(imgs, ids, s, tr)
    return s if tr is None else (s, tr)
