"""Three-level trampolines + hook library + signal handler (paper §3.2).

* **L1** — 16-byte slots in ``[4096, 65536)``: ``movz/movk/movk x8, #L2`` and
  ``br x8``.  3840 slots, exactly the paper's budget.  The sole job of this
  level is to leave the precious low-address window as fast as possible.
* **L2** — per-site, anywhere: materialise the return address (svc+4) in x8,
  push it, re-execute the displaced x8 assignment, direct-branch to L3.
  (Deviation noted in DESIGN.md: we push before re-executing — equivalent,
  and lets x8 double as the address scratch.)
* **L3** — shared, one copy: save context, call the hook, either take the
  hook's virtualised return value from the MAILBOX or perform the real
  ``svc``, restore context, pop the return address into x16 (the
  architecturally veneer-clobberable IP0 register) and ``br x16``.

The hook library and signal handler live in non-rewritten sections — the
simulation of the paper's ``dlmopen`` separate-namespace trick: their own
``svc`` instructions are executed, not intercepted, so the hook can perform
the original syscall without recursing into itself.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from . import isa
from . import layout as L
from .image import (HANDLER_BASE, HOOK_BASE, PAGE_TRAMP_BASE, TRAMP_BASE, Image)
from .isa import Asm
from .scanner import SvcSite

L2_BYTES = 32  # 6 instructions, padded


def build_l3(base: int, hook_entry: int) -> Asm:
    a = Asm(base)
    a.label("l3")
    # save context (10 pairs; x16 deliberately excluded — veneer scratch)
    a.emit(isa.stp_pre(0, 1, isa.SP, -16))
    a.emit(isa.stp_pre(2, 3, isa.SP, -16))
    a.emit(isa.stp_pre(4, 5, isa.SP, -16))
    a.emit(isa.stp_pre(6, 7, isa.SP, -16))
    a.emit(isa.stp_pre(8, 9, isa.SP, -16))
    a.emit(isa.stp_pre(10, 11, isa.SP, -16))
    a.emit(isa.stp_pre(12, 13, isa.SP, -16))
    a.emit(isa.stp_pre(14, 15, isa.SP, -16))
    a.emit(isa.stp_pre(17, 18, isa.SP, -16))
    a.emit(isa.stp_pre(30, isa.XZR, isa.SP, -16))
    # user hook: x8 still holds the syscall number (L2 restored it)
    a.bl_to("hook_entry")
    a.cbz_to(0, "do_real")
    # virtualised: hook left the return value in the MAILBOX
    a.emit(isa.movz(16, L.MAILBOX & 0xFFFF), isa.movk(16, L.MAILBOX >> 16, 1))
    a.emit(isa.ldr_imm(16, 16))
    a.emit(isa.str_imm(16, isa.SP, 144))  # overwrite saved x0
    a.b_to("restore")
    a.label("do_real")
    a.emit(isa.ldr_imm(8, isa.SP, 80))
    a.emit(isa.ldr_imm(0, isa.SP, 144))
    a.emit(isa.ldr_imm(1, isa.SP, 152))
    a.emit(isa.ldr_imm(2, isa.SP, 128))
    a.emit(isa.ldr_imm(3, isa.SP, 136))
    a.emit(isa.ldr_imm(4, isa.SP, 112))
    a.emit(isa.ldr_imm(5, isa.SP, 120))
    a.emit(isa.svc(0))  # the real system call — L3 is never rewritten
    a.emit(isa.str_imm(0, isa.SP, 144))
    a.label("restore")
    a.emit(isa.ldp_post(30, 16, isa.SP, 16))
    a.emit(isa.ldp_post(17, 18, isa.SP, 16))
    a.emit(isa.ldp_post(14, 15, isa.SP, 16))
    a.emit(isa.ldp_post(12, 13, isa.SP, 16))
    a.emit(isa.ldp_post(10, 11, isa.SP, 16))
    a.emit(isa.ldp_post(8, 9, isa.SP, 16))
    a.emit(isa.ldp_post(6, 7, isa.SP, 16))
    a.emit(isa.ldp_post(4, 5, isa.SP, 16))
    a.emit(isa.ldp_post(2, 3, isa.SP, 16))
    a.emit(isa.ldp_post(0, 1, isa.SP, 16))
    a.emit(isa.ldr_post(16, isa.SP, 16))  # pop return address
    a.emit(isa.br(16))
    a._hook_entry = hook_entry  # resolved at assemble time via symbols
    return a


def l2_words(site: SvcSite, l3_addr: int, l2_addr: int) -> List[int]:
    ra = site.return_addr
    words = isa.mov_imm48(8, ra)
    words.append(isa.str_pre(8, isa.SP, -16))
    assert site.x8_word is not None
    words.append(site.x8_word)  # re-execute the displaced assignment
    off = l3_addr - (l2_addr + 4 * len(words))
    words.append(isa.b(off))
    while len(words) < L2_BYTES // 4:
        words.append(isa.nop())
    return words


def l1_words(l2_addr: int) -> List[int]:
    return isa.mov_imm48(8, l2_addr) + [isa.br(8)]


@dataclasses.dataclass
class TrampolineSet:
    l3_addr: int
    l1_map: Dict[int, int]        # svc_addr -> L1 slot address
    l2_map: Dict[int, int]        # svc_addr -> L2 address
    page_map: Dict[int, int]      # svc_addr -> R2 page-trampoline address
    l1_used: int
    bytes_used: int


class TrampolineBuilder:
    """Allocates L1 slots, the L2 pool and R2 page trampolines in an image."""

    def __init__(self, image: Image, hook_entry: int, *, max_l1_slots: int = L.L1_SLOTS):
        self.image = image
        self.max_l1_slots = min(max_l1_slots, L.L1_SLOTS)
        self.l1_next = 0
        self.l2_next = None  # after L3
        self.page_next = PAGE_TRAMP_BASE
        l3 = build_l3(TRAMP_BASE, hook_entry)
        image.add_asm("asc.l3", l3, rewrite=False, symbols={"hook_entry": hook_entry})
        self.l3_addr = TRAMP_BASE
        self.l2_next = TRAMP_BASE + l3.size_bytes()
        self.l2_next = (self.l2_next + L2_BYTES - 1) // L2_BYTES * L2_BYTES
        self.l2_words_acc: List[int] = []
        self.ts = TrampolineSet(self.l3_addr, {}, {}, {}, 0, l3.size_bytes())

    def add_r1(self, site: SvcSite) -> Optional[int]:
        """First replacement method: L1 slot + L2. Returns L1 addr or None."""
        if self.l1_next >= self.max_l1_slots:
            return None
        l1_addr = L.L1_BASE + L.L1_SLOT_BYTES * self.l1_next
        l2_addr = self.l2_next
        w2 = l2_words(site, self.l3_addr, l2_addr)
        self.image.add_section(f"asc.l2@{site.svc_addr:#x}", l2_addr, w2, rewrite=False)
        self.image.add_section(f"asc.l1@{site.svc_addr:#x}", l1_addr,
                               l1_words(l2_addr), rewrite=False)
        self.l1_next += 1
        self.l2_next += L2_BYTES
        self.ts.l1_map[site.svc_addr] = l1_addr
        self.ts.l2_map[site.svc_addr] = l2_addr
        self.ts.l1_used = self.l1_next
        self.ts.bytes_used += L.L1_SLOT_BYTES + L2_BYTES
        return l1_addr

    def add_r2(self, site: SvcSite) -> int:
        """Second method: page-aligned single-level trampoline for adrp."""
        page = self.page_next
        assert page % 4096 == 0
        w2 = l2_words(site, self.l3_addr, page)
        self.image.add_section(f"asc.page@{site.svc_addr:#x}", page, w2, rewrite=False)
        self.page_next += 4096  # the paper's "significant memory waste"
        self.ts.page_map[site.svc_addr] = page
        self.ts.bytes_used += 4096
        return page


def build_hook_library(virtualize_getpid: bool) -> Asm:
    """The user hook, loaded into its own namespace (never rewritten).

    Protocol: on entry x8 = syscall number, full caller context saved by L3
    (or the sigframe).  Returns x0=0 to run the real syscall, or x0=1 with a
    virtualised return value stored in the MAILBOX (the paper's Table 3 uses
    a getpid hook returning a virtual value, skipping the kernel).
    Side effect: bumps the COUNTER word so tests can verify interception.
    """
    a = Asm(HOOK_BASE)
    a.label("hook_entry")
    a.emit(isa.movz(10, L.COUNTER & 0xFFFF), isa.movk(10, L.COUNTER >> 16, 1))
    a.emit(isa.ldr_imm(11, 10), isa.addi(11, 11, 1), isa.str_imm(11, 10))
    if virtualize_getpid:
        a.emit(isa.subsi(isa.XZR, 8, L.SYS_GETPID))  # cmp x8, #getpid
        a.b_to("passthrough", cond="ne")
        a.emit(isa.movz(10, L.MAILBOX & 0xFFFF), isa.movk(10, L.MAILBOX >> 16, 1))
        a.emit(isa.movz(11, L.VIRT_PID))
        a.emit(isa.str_imm(11, 10))
        a.emit(isa.movz(0, 1))
        a.emit(isa.ret())
        a.label("passthrough")
    a.emit(isa.movz(0, 0))
    a.emit(isa.ret())
    return a


def build_signal_handler() -> Asm:
    """SIGTRAP/SIGILL handler used by R3 sites and the pure-signal mechanism.

    ABI (modelled kernel): x0 = signo, x1 = sigframe (x0..x30, sp, pc, nzcv).
    Restores the faulting site's syscall context from the frame, runs the
    hook, performs (or virtualises) the syscall, writes the return value into
    the frame's x0 slot, and rt_sigreturn's.
    """
    a = Asm(HANDLER_BASE)
    a.label("sig_handler")
    a.emit(isa.mov_r(9, 1))            # x9 = frame
    a.emit(isa.ldr_imm(8, 9, 64))      # x8 = frame.x8 (syscall nr) for the hook
    a.bl_to("hook_entry")
    a.cbz_to(0, "do_real")
    a.emit(isa.movz(10, L.MAILBOX & 0xFFFF), isa.movk(10, L.MAILBOX >> 16, 1))
    a.emit(isa.ldr_imm(10, 10))
    a.emit(isa.str_imm(10, 9, 0))      # frame.x0 = virtualised value
    a.b_to("done")
    a.label("do_real")
    a.emit(isa.ldr_imm(8, 9, 64))
    a.emit(isa.ldr_imm(0, 9, 0))
    a.emit(isa.ldr_imm(1, 9, 8))
    a.emit(isa.ldr_imm(2, 9, 16))
    a.emit(isa.ldr_imm(3, 9, 24))
    a.emit(isa.ldr_imm(4, 9, 32))
    a.emit(isa.ldr_imm(5, 9, 40))
    a.emit(isa.svc(0))                 # handler section is never rewritten
    a.emit(isa.str_imm(0, 9, 0))
    a.label("done")
    a.emit(isa.movz(8, L.SYS_RT_SIGRETURN, sf=0))
    a.emit(isa.svc(0))
    a.emit(isa.hlt(1))                 # unreachable
    return a
