"""Batched syscall tracing + seccomp-style policy (PyTorch port of
``repro.trace``).

* :mod:`repro_torch.trace.recorder` — per-lane double-buffered rings of
  executed syscalls, appended in the batched step (the CUDA megastep
  kernel on the card), decoded host-side into strace-like text, plus
  per-syscall x per-verdict histograms.
* :mod:`repro_torch.trace.policy` — per-lane ALLOW / DENY / EMULATE / KILL
  tables compiled from :class:`repro_torch.core.hookcfg.PolicyRule` lines.

Entry points: ``run_fleet(..., trace=...)``, ``run_fleet_span`` and
``runtime.run_fleet_prepared(trace=True)``; build the carry with
:func:`recorder.make_trace_state` or ``runtime.pack_fleet(trace=True)``.
The streaming pipeline (``repro.trace.stream``) is not ported yet.
"""
from ..core.fleet import (DEFAULT_TRACE_CAP, N_POLICY_SLOTS, N_VERDICTS,
                          POL_ALLOW, POL_DENY, POL_EMULATE, POL_KILL,
                          REC_WORDS, SLOT_UNKNOWN, TRACE_SYS, TraceState,
                          VERDICT_UNKNOWN)
from ..core.hookcfg import PolicyRule
from .policy import (ALLOW_ALL, Action, allow, compile_policy, deny,
                     emulate, kill, policy_rows, validate_rules)
from .recorder import (VERDICT_NAMES, TraceRecord, decode_rows,
                       format_record, format_strace, harvest, harvest_lane,
                       lane_histogram, make_trace_state)

__all__ = [
    "ALLOW_ALL", "Action", "DEFAULT_TRACE_CAP", "N_POLICY_SLOTS",
    "N_VERDICTS", "POL_ALLOW", "POL_DENY", "POL_EMULATE", "POL_KILL",
    "PolicyRule", "REC_WORDS", "SLOT_UNKNOWN", "TRACE_SYS", "TraceRecord",
    "TraceState", "VERDICT_NAMES", "VERDICT_UNKNOWN", "allow",
    "compile_policy", "decode_rows", "deny", "emulate", "format_record",
    "format_strace", "harvest", "harvest_lane", "kill", "lane_histogram",
    "make_trace_state", "policy_rows", "validate_rules",
]
