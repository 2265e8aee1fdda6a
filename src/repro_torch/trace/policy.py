"""Seccomp-style syscall policy: host-side rule compilation (PyTorch port).

A numpy-only copy of the JAX package's ``repro.trace.policy``.

The paper's hooks exist so tools can "modify or monitor application
behavior"; this module is the *modify* half.  A policy is an ordered list
of :class:`repro_torch.core.hookcfg.PolicyRule` lines — the same config-file
shape completeness strategy C3 appends to — compiled down to fixed-width
per-lane action/argument tables (one slot per modelled syscall plus the
catch-all UNKNOWN slot).  The fleet step resolves ``x8`` to a slot and
gates the ``sys_*`` branches on the looked-up action
(:func:`repro_torch.core.fleet._step_core` and the CUDA megastep kernel),
so enforcement never leaves the batched step.

Actions (also the recorded verdicts — see :mod:`repro_torch.trace.recorder`):

* ``ALLOW``   — the syscall executes normally (the default for every slot).
* ``DENY``    — the kernel branch is skipped, ``x0 = -arg`` (errno).
* ``EMULATE`` — skipped, ``x0 = arg`` (a constant, e.g. a virtual pid).
* ``KILL``    — the lane halts with ``HALT_KILL`` (seccomp's
  ``SECCOMP_RET_KILL``).

An empty policy compiles to all-ALLOW tables, under which traced machine
states are bit-identical to untraced runs (the parity suite enforces it).
"""
from __future__ import annotations

import enum
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from ..core.opspec import (N_POLICY_SLOTS, POL_ALLOW, POL_DENY,
                               POL_EMULATE, POL_KILL, SLOT_UNKNOWN, TRACE_SYS,
                               slot_of)
from ..core.hookcfg import PolicyRule


class Action(enum.IntEnum):
    ALLOW = POL_ALLOW
    DENY = POL_DENY
    EMULATE = POL_EMULATE
    KILL = POL_KILL


PolicyRows = Tuple[np.ndarray, np.ndarray]  # (int32[NSLOT], int64[NSLOT])


# -- rule constructors (sugar over hookcfg.PolicyRule) ------------------------

def allow(syscall_nr: int = -1) -> PolicyRule:
    return PolicyRule(syscall_nr=syscall_nr, action="allow")


def deny(syscall_nr: int = -1, errno: int = 1) -> PolicyRule:
    """DENY with ``-errno`` as the return value (default EPERM)."""
    return PolicyRule(syscall_nr=syscall_nr, action="deny", arg=errno)


def emulate(syscall_nr: int, value: int) -> PolicyRule:
    return PolicyRule(syscall_nr=syscall_nr, action="emulate", arg=value)


def kill(syscall_nr: int = -1) -> PolicyRule:
    return PolicyRule(syscall_nr=syscall_nr, action="kill")


# Slot resolution lives on the spec table (repro_torch.core.opspec.slot_of);
# keep the historical private name for in-module callers.
_slot_of = slot_of


# Any legal arm64 syscall number fits comfortably below this; a rule
# outside the range is a typo, not a request for the UNKNOWN class.
MAX_SYSCALL_NR = 1024

_ACTION_NAMES = frozenset(a.name.lower() for a in Action)


def validate_rules(rules: Optional[Iterable[PolicyRule]]) -> None:
    """Reject malformed policy lines up front, naming the offending rule.

    Raises ``ValueError`` for an action outside allow/deny/emulate/kill,
    a non-integer or out-of-range syscall number (< -1 or >=
    ``MAX_SYSCALL_NR``), or a non-integer arg — the failures that used to
    surface as opaque ``KeyError``/cast errors inside table compilation
    at admission time.  An unmodelled-but-plausible number is NOT an
    error: it selects the UNKNOWN slot (the -ENOSYS fall-through class),
    which is a documented feature.
    """
    for r in rules or ():
        if (not isinstance(r.action, str)
                or r.action.lower() not in _ACTION_NAMES):
            raise ValueError(
                f"bad policy action {r.action!r} in rule {r!r}: expected "
                f"one of {sorted(_ACTION_NAMES)}")
        if (not isinstance(r.syscall_nr, int)
                or isinstance(r.syscall_nr, bool)
                or not -1 <= r.syscall_nr < MAX_SYSCALL_NR):
            raise ValueError(
                f"bad syscall_nr {r.syscall_nr!r} in rule {r!r}: expected "
                f"an int in [-1, {MAX_SYSCALL_NR}) (-1 = every syscall)")
        if not isinstance(r.arg, int) or isinstance(r.arg, bool):
            raise ValueError(
                f"bad arg {r.arg!r} in rule {r!r}: expected an int "
                f"(errno for deny, return constant for emulate)")


def compile_policy(rules: Optional[Iterable[PolicyRule]]) -> PolicyRows:
    """Rules -> ``(action_row, arg_row)`` slot tables, last match wins.

    ``syscall_nr == -1`` sets every slot (the default-action line);
    a number outside the modelled set selects the UNKNOWN slot, i.e. the
    whole -ENOSYS fall-through class at once.  Malformed rules raise
    ``ValueError`` via :func:`validate_rules`.
    """
    # materialise first: validation + compilation each iterate, and a
    # one-shot iterable that survived validation must not compile to a
    # silent all-ALLOW table
    rules = list(rules) if rules is not None else None
    validate_rules(rules)
    action_row = np.full(N_POLICY_SLOTS, POL_ALLOW, np.int32)
    arg_row = np.zeros(N_POLICY_SLOTS, np.int64)
    for r in rules or ():
        act = Action[r.action.upper()]
        sel = (slice(None) if r.syscall_nr < 0
               else slice(_slot_of(r.syscall_nr), _slot_of(r.syscall_nr) + 1))
        action_row[sel] = int(act)
        arg_row[sel] = int(r.arg)
    return action_row, arg_row


ALLOW_ALL: PolicyRows = compile_policy(None)


def policy_rows(policies: Sequence[Optional[Iterable[PolicyRule]]]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-lane rule lists into ``[B, NSLOT]`` tables (None entries
    take the all-ALLOW default)."""
    rows = [compile_policy(p) if p is not None else ALLOW_ALL
            for p in policies]
    return (np.stack([r[0] for r in rows]),
            np.stack([r[1] for r in rows]))
