"""ASC-Hook core on PyTorch: the paper's mechanism on a simulated AArch64.

Public surface::

    from repro_torch.core import (
        HookConfig, Mechanism, prepare, programs, run_prepared,
        run_fleet_prepared, unstack_state,
    )
"""
from . import costmodel, fleet, isa, layout, programs
from .completeness import (C3Event, diagnose_c3, diagnose_c3_fleet,
                           run_with_c3)
from .fleet import (FleetImages, TraceState, admit_lanes, choose_bucket,
                    compact_ladder, fleet_counters, fleet_step,
                    fleet_step_traced, fleet_summary,
                    make_halted_states, pack_images, precompile_ladder,
                    restore_lanes, run_fleet, run_fleet_compact,
                    run_fleet_span, run_fleet_stream, set_image_row,
                    stack_images, stack_states, stack_traces, unstack_state,
                    unstack_trace, update_policy_rows)
from .hookcfg import HookConfig, PinnedSite, PolicyRule
from .image import Image, build_minilibc, build_process
from .machine import (HALT_BADMEM, HALT_EXIT, HALT_FUEL, HALT_KILL,
                      HALT_SEGV, HALT_TRAP, RUNNING, DecodedImage,
                      MachineState, decode_image, make_state, mem_read,
                      mem_read_block, mem_write, run_image, step)
from .rewriter import RewriteReport, rewrite_all_to_signal, rewrite_image
from .runtime import (FleetImageTable, Mechanism, PreparedProcess,
                      fleet_trace, hook_invocations, initial_state,
                      pack_fleet, precompile_compact, prepare,
                      run_fleet_prepared, run_prepared, update_fleet_policy)
from .scanner import SvcSite, census, scan_image

__all__ = [
    "C3Event", "DecodedImage", "FleetImageTable", "FleetImages",
    "HALT_BADMEM", "HALT_EXIT", "HALT_FUEL", "HALT_KILL", "HALT_SEGV",
    "HALT_TRAP", "HookConfig", "Image", "MachineState", "Mechanism",
    "PinnedSite", "PolicyRule", "PreparedProcess", "RUNNING",
    "RewriteReport", "SvcSite", "TraceState", "admit_lanes",
    "build_minilibc", "build_process", "census", "choose_bucket",
    "compact_ladder", "costmodel", "decode_image", "diagnose_c3",
    "diagnose_c3_fleet", "fleet", "fleet_counters", "fleet_step",
    "fleet_step_traced", "fleet_summary",
    "fleet_trace", "hook_invocations", "initial_state", "isa", "layout",
    "make_halted_states", "make_state", "mem_read", "mem_read_block",
    "mem_write", "pack_fleet", "pack_images", "precompile_compact",
    "precompile_ladder", "prepare", "programs", "restore_lanes",
    "rewrite_all_to_signal", "rewrite_image", "run_fleet",
    "run_fleet_compact", "run_fleet_prepared", "run_fleet_span",
    "run_fleet_stream", "run_image", "run_prepared", "run_with_c3",
    "scan_image", "set_image_row", "stack_images", "stack_states",
    "stack_traces", "step", "unstack_state", "unstack_trace",
    "update_fleet_policy", "update_policy_rows",
]
