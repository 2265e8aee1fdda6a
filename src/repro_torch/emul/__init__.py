"""Guest-kernel emulation: the carry layout (:mod:`.state`: the per-lane
fd table and in-memory filesystem, flat ``k_`` leaves of
``MachineState``) and the batched service and data mover
(:mod:`.engine`), which the fleet step and the megastep kernel share.
The JAX package's ``repro.emul`` exports, name for name."""
from . import engine, state
from .state import (ERRNOS, KERN_FIELDS, KernelState, fresh_kern,
                    fresh_kern_scalar, kern_of, path_key, with_kern)

__all__ = [
    "engine", "state", "ERRNOS", "KERN_FIELDS", "KernelState",
    "fresh_kern", "fresh_kern_scalar", "kern_of", "path_key", "with_kern",
]
