"""Completeness strategy C3: the trap → config → re-execute flow (Figure 4)
(PyTorch port of the JAX package's ``repro.core.completeness``).

When an *indirect* jump lands between the replaced pair, only ``br x8``
executes and x8 still holds the syscall number (< 600).  Addresses
``[0, 4096)`` are unmapped, so the jump faults.  The discrimination rule is
the paper's: the fault is ours iff ``pc == x8`` and ``pc < MAX_SYSCALL_NR``
— which cannot be confused with a NULL-pointer dereference or any other
program fault.  The handler then walks ``x30`` back to the ``blr``, reads its
destination register to recover the svc address, maps it to (library, offset)
via the maps table, appends it to the config file, and the application is
re-executed; run two uses R3 for that site.

The rule runs on host values; the machine states it reads may lie on the
card, and are copied to the host once per call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import isa
from . import layout as L
from . import machine as M
from .hookcfg import HookConfig
from .isa import Asm, Op
from .runtime import Mechanism, PreparedProcess, prepare, run_prepared


@dataclasses.dataclass
class C3Event:
    syscall_nr: int
    svc_addr: int
    lib: str
    offset: int


def _diagnose_values(pp: PreparedProcess, halted: int, fault_pc: int,
                     regs: Sequence[int]) -> Optional[C3Event]:
    """The discrimination rule on plain host values (shared by the scalar
    and the fleet entry points, so the two cannot drift)."""
    if halted != M.HALT_SEGV:
        return None
    pc = fault_pc
    x8 = int(regs[8])
    if pc != x8 or pc >= L.MAX_SYSCALL_NR:  # not our fault signature
        return None
    # "most indirect jumps use BLR, which saves the return address in x30"
    x30 = int(regs[30])
    if x30 - 4 < 0 or x30 - 4 >= L.CODE_LIMIT or (x30 - 4) % 4 != 0:
        return None
    blr_word = pp.image.word_at(x30 - 4)
    d = isa.decode(blr_word)
    if d.op != Op.BLR:
        return None
    svc_addr = int(regs[d.rn])
    sec = pp.image.section_of(svc_addr)
    if sec is None:
        return None
    return C3Event(syscall_nr=x8, svc_addr=svc_addr,
                   lib=sec.name, offset=svc_addr - sec.base)


def _fault_words(states: M.MachineState) -> np.ndarray:
    """``[..., 33]`` host words per lane: halted, fault_pc, x0..x30 — one
    device-to-host copy for a scalar state or a whole fleet."""
    return torch.cat([states.halted.unsqueeze(-1),
                      states.fault_pc.unsqueeze(-1), states.regs],
                     -1).cpu().numpy()


def diagnose_c3(pp: PreparedProcess, state: M.MachineState) -> Optional[C3Event]:
    """Apply the paper's signal-handler analysis to a faulted machine."""
    w = _fault_words(state)
    return _diagnose_values(pp, int(w[0]), int(w[1]), w[2:])


def diagnose_c3_fleet(pps: Sequence[Optional[PreparedProcess]],
                      states: M.MachineState, *,
                      halted: Optional[np.ndarray] = None
                      ) -> List[Optional[C3Event]]:
    """Batch C3 diagnosis over a fleet state: lane ``i`` gets exactly the
    verdict :func:`diagnose_c3` would give for ``pps[i]``.

    One device-to-host copy for the whole fleet (halt, pc and register
    words together) instead of a read per lane; ``None`` entries in
    ``pps`` (empty server slots) diagnose as ``None``.  A caller that
    already holds the halt words on the host (the server's harvest)
    passes them as ``halted``; they take the place of the copied ones.
    """
    w = _fault_words(states)
    if halted is not None:
        w[:, 0] = np.asarray(halted)
    out: List[Optional[C3Event]] = []
    for i, pp in enumerate(pps):
        if pp is None:
            out.append(None)
            continue
        out.append(_diagnose_values(pp, int(w[i, 0]), int(w[i, 1]),
                                    w[i, 2:]))
    return out


def run_with_c3(app_builder: Callable[[], Asm], *,
                cfg: Optional[HookConfig] = None,
                virtualize: bool = False,
                fuel: int = 2_000_000,
                max_restarts: int = 4,
                device=None,
                ) -> Tuple[M.MachineState, PreparedProcess, List[C3Event], int]:
    """Run under ASC-Hook with the full two-run completeness loop.

    Returns (final state, final prepared process, C3 events, #executions).
    Every execution is :func:`run_prepared` on ``device`` (``None`` means
    the card).
    """
    cfg = cfg or HookConfig()
    events: List[C3Event] = []
    for attempt in range(1, max_restarts + 1):
        pp = prepare(app_builder(), Mechanism.ASC, virtualize=virtualize, cfg=cfg)
        state = run_prepared(pp, fuel=fuel, device=device)
        ev = diagnose_c3(pp, state)
        if ev is None:
            return state, pp, events, attempt
        # append to the "config file" and re-execute (Figure 4)
        if not cfg.enable_c3:
            return state, pp, events, attempt
        cfg.pin(lib=ev.lib, offset=ev.offset, syscall_nr=ev.syscall_nr)
        events.append(ev)
    return state, pp, events, max_restarts
