"""The census reference: preparation, initial states and a run to halt,
all on the host, from the frozen copy of the port's plain pieces.

:func:`prepare` is the port's ``core.runtime.prepare`` (scan, rewrite,
trampolines, hook library, signal handler, decode), :func:`initial_state`
its ``initial_state``, and :func:`run_to_halt` steps the lane-vectorised
plain step until no lane is alive, then marks the lanes out of fuel, as
the port's drivers do.  Nothing here is taken from the program under
test: the reference builds its own images and states from the census's
description.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .core import fleet as F
from .core import machine as M
from .core import programs
from .core.hookcfg import HookConfig
from .core.image import Image, build_process
from .core.rewriter import RewriteReport, rewrite_all_to_signal, rewrite_image
from .core.trampoline import build_hook_library, build_signal_handler


class Mechanism(enum.Enum):
    NONE = "none"
    LD_PRELOAD = "ld_preload"
    SIGNAL = "signal"
    PTRACE = "ptrace"
    ASC = "asc"


@dataclasses.dataclass
class Prepared:
    image: Image
    decoded: M.DecodedImage
    entry: int
    sig_handler: int
    mechanism: Mechanism
    report: Optional[RewriteReport]
    virtualize: bool
    cfg: HookConfig


def build_program(name: str, args: Sequence) -> "programs.Asm":
    """The guest program ``programs.<name>(*args)``."""
    return getattr(programs, name)(*args)


def prepare(app, mechanism: Mechanism, *, virtualize: bool,
            cfg: HookConfig) -> Prepared:
    preload = virtualize if mechanism is Mechanism.LD_PRELOAD else None
    image = build_process(app, preload_virt=preload)
    report = None
    sig_handler = 0
    if mechanism in (Mechanism.ASC, Mechanism.SIGNAL):
        hook = build_hook_library(virtualize_getpid=virtualize)
        image.add_asm("hooklib.so", hook, rewrite=False)
        hook_entry = image.sym("hooklib.so:hook_entry")
        if mechanism is Mechanism.ASC:
            report = rewrite_image(image, hook_entry, cfg)
            needs_handler = report.needs_signal
        else:
            report = rewrite_all_to_signal(image, cfg)
            needs_handler = True
        if needs_handler:
            handler = build_signal_handler()
            image.add_asm("sighandler", handler, rewrite=False,
                          symbols={"hook_entry": hook_entry})
            sig_handler = image.sym("sighandler:sig_handler")
    return Prepared(image=image, decoded=M.decode_image(image.words),
                    entry=image.sym("app:main"), sig_handler=sig_handler,
                    mechanism=mechanism, report=report, virtualize=virtualize,
                    cfg=cfg)


def initial_state(pp: Prepared, *, fuel: int,
                  regs: Dict[int, int]) -> M.MachineState:
    st = M.make_state(pp.entry, fuel=fuel, device="cpu")
    for i, v in regs.items():
        st.regs[i] = v
    st.sig_handler.fill_(pp.sig_handler)
    st.ptrace.fill_(1 if pp.mechanism is Mechanism.PTRACE else 0)
    st.virt_getpid.fill_(
        1 if (pp.mechanism is Mechanism.PTRACE and pp.virtualize) else 0)
    st.k_enabled.fill_(1 if pp.cfg.emul_enabled else 0)
    return st


def pack(pps: Sequence[Prepared], states: Sequence[M.MachineState]):
    """(images, ids, stacked states): one decode table a distinct image."""
    rows: Dict[bytes, int] = {}
    uniq: List[M.DecodedImage] = []
    ids = np.zeros(len(pps), np.int32)
    for i, pp in enumerate(pps):
        d = hashlib.sha1(np.ascontiguousarray(pp.image.words)
                         .tobytes()).digest()
        if d not in rows:
            rows[d] = len(uniq)
            uniq.append(pp.decoded)
        ids[i] = rows[d]
    return (F.pack_images(F.stack_images(uniq)), torch.from_numpy(ids),
            F.stack_states(states))


def run_to_halt(imgs, ids, s: M.MachineState, *,
                check_every: int = 64) -> M.MachineState:
    """Step every lane until none is alive; lanes out of fuel end as
    ``HALT_FUEL``.  A halted lane's step is the identity, so testing
    liveness every ``check_every`` steps changes no result."""
    while bool(F._alive(s).any()):
        for _ in range(check_every):
            s, _ = F._step_core(imgs, ids, s, None)
    return F._patch_fuel(s)
