"""Batched syscall tracing + seccomp-style policy (PyTorch port of
``repro.trace``).

* :mod:`repro_torch.trace.recorder` — per-lane double-buffered rings of
  executed syscalls, appended in the batched step (the CUDA megastep
  kernel on the card), decoded host-side into strace-like text, plus
  per-syscall x per-verdict histograms.
* :mod:`repro_torch.trace.policy` — per-lane ALLOW / DENY / EMULATE / KILL
  tables compiled from :class:`repro_torch.core.hookcfg.PolicyRule` lines.
* :mod:`repro_torch.trace.stream` — the zero-drop streaming pipeline: ring
  halves flipped at span boundaries (:func:`repro_torch.core.fleet.
  flip_trace`) drain into a host-side :class:`TraceStream` with pluggable
  writers, so no record is overwritten at fixed ring capacity.

Entry points: ``run_fleet(..., trace=...)``, ``run_fleet_span``,
``run_fleet_stream`` and ``runtime.run_fleet_prepared(trace=True)``; build
the carry with :func:`recorder.make_trace_state` or
``runtime.pack_fleet(trace=True)``.
"""
from ..core.fleet import (DEFAULT_TRACE_CAP, N_POLICY_SLOTS, N_VERDICTS,
                          POL_ALLOW, POL_DENY, POL_EMULATE, POL_KILL,
                          REC_WORDS, SLOT_UNKNOWN, TRACE_SYS, TraceState,
                          VERDICT_UNKNOWN, flip_trace, run_fleet_stream,
                          stream_interval)
from ..core.hookcfg import PolicyRule
from .policy import (ALLOW_ALL, Action, allow, compile_policy, deny,
                     emulate, kill, policy_rows, validate_rules)
from .recorder import (VERDICT_NAMES, TraceRecord, decode_rows,
                       format_record, format_strace, harvest, harvest_lane,
                       lane_histogram, make_trace_state)
from .stream import (CallbackWriter, JSONLWriter, MemoryWriter, TraceStream,
                     make_writer)

__all__ = [
    "ALLOW_ALL", "Action", "CallbackWriter", "DEFAULT_TRACE_CAP",
    "JSONLWriter", "MemoryWriter", "N_POLICY_SLOTS", "N_VERDICTS",
    "POL_ALLOW", "POL_DENY", "POL_EMULATE", "POL_KILL", "PolicyRule",
    "REC_WORDS", "SLOT_UNKNOWN", "TRACE_SYS", "TraceRecord", "TraceState",
    "TraceStream", "VERDICT_NAMES", "VERDICT_UNKNOWN", "allow",
    "compile_policy", "decode_rows", "deny", "emulate", "flip_trace",
    "format_record", "format_strace", "harvest", "harvest_lane", "kill",
    "lane_histogram", "make_trace_state", "make_writer", "policy_rows",
    "run_fleet_stream", "stream_interval", "validate_rules",
]
