"""ASC-Hook core on PyTorch: the paper's mechanism on a simulated AArch64.

Public surface::

    from repro_torch.core import (
        HookConfig, Mechanism, prepare, programs, run_prepared,
        run_fleet_prepared, unstack_state,
    )
"""
from . import costmodel, fleet, isa, layout, programs
from .fleet import (FleetImages, fleet_counters, fleet_summary, pack_images,
                    run_fleet, run_fleet_span, stack_images, stack_states,
                    unstack_state)
from .hookcfg import HookConfig, PinnedSite, PolicyRule
from .image import Image, build_minilibc, build_process
from .machine import (HALT_BADMEM, HALT_EXIT, HALT_FUEL, HALT_KILL,
                      HALT_SEGV, HALT_TRAP, RUNNING, DecodedImage,
                      MachineState, decode_image, make_state, run_image)
from .rewriter import RewriteReport, rewrite_all_to_signal, rewrite_image
from .runtime import (Mechanism, PreparedProcess, hook_invocations,
                      initial_state, pack_fleet, prepare, run_fleet_prepared,
                      run_prepared)
from .scanner import SvcSite, census, scan_image

__all__ = [
    "DecodedImage", "FleetImages", "HALT_BADMEM", "HALT_EXIT", "HALT_FUEL",
    "HALT_KILL", "HALT_SEGV", "HALT_TRAP", "HookConfig", "Image",
    "MachineState", "Mechanism", "PinnedSite", "PolicyRule",
    "PreparedProcess", "RUNNING", "RewriteReport", "SvcSite",
    "build_minilibc", "build_process", "census", "costmodel",
    "decode_image", "fleet", "fleet_counters", "fleet_summary", "hook_invocations", "initial_state", "isa", "layout",
    "make_state", "pack_fleet", "pack_images", "prepare", "programs",
    "rewrite_all_to_signal", "rewrite_image", "run_fleet",
    "run_fleet_prepared", "run_fleet_span", "run_image", "run_prepared",
    "scan_image", "stack_images", "stack_states", "unstack_state",
]
