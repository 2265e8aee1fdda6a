"""AArch64 subset: encoder, decoder, tiny two-pass assembler.

This is the instruction set surface that ASC-Hook touches: the syscall ABI
(MOVZ/MOVK into x8, SVC), the rewrite instructions (MOVZ/MOVK/ADRP + BR,
BRK/illegal), the trampoline bodies (STP/LDP/STR/LDR, BL/BLR/RET/B/CBZ),
and enough ALU/branch surface to write realistic workloads (loops, argument
setup, flag-setting compares).

Encodings follow the Arm ARM (DDI 0487). All register-width handling is
64-bit (``sf=1``) except MOVZ/MOVK with ``w`` destination, which we encode as
32-bit to mirror what compilers actually emit for ``mov w8, #NR``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Tuple, Union

WORD = 4  # AArch64 instructions are fixed 4 bytes — the root of challenge #1.

XZR = 31  # reg 31 = zero register for data-processing operands
SP = 31  # ... and the stack pointer for memory/add-imm operands
LR = 30


class Op(enum.IntEnum):
    """Pre-decoded op classes for the JAX machine's ``lax.switch``."""

    ILLEGAL = 0  # undefined encoding -> SIGILL
    NULLPAGE = 1  # synthetic: fetch from unmapped [0, 0x1000) -> SIGSEGV
    MOVZ = 2
    MOVK = 3
    MOVN = 4
    ADRP = 5
    ADR = 6
    ADDI = 7
    SUBI = 8
    SUBSI = 9
    ADDR = 10
    SUBR = 11
    SUBSR = 12
    ORRR = 13
    ANDR = 14
    EORR = 15
    MADD = 16
    LDRI = 17
    STRI = 18
    LDRPOST = 19
    STRPRE = 20
    STP = 21
    LDP = 22
    STPPRE = 23
    LDPPOST = 24
    B = 25
    BL = 26
    BR = 27
    BLR = 28
    RET = 29
    CBZ = 30
    CBNZ = 31
    BCOND = 32
    SVC = 33
    BRK = 34
    NOP = 35
    LDRB = 36
    STRB = 37
    HLT = 38
    LSLI = 39  # UBFM-based immediate shift, encoded/decoded as its own class
    N_OPS = 40


# Condition codes for B.cond.
COND = {
    "eq": 0, "ne": 1, "cs": 2, "cc": 3, "mi": 4, "pl": 5, "vs": 6, "vc": 7,
    "hi": 8, "ls": 9, "ge": 10, "lt": 11, "gt": 12, "le": 13, "al": 14,
}


@dataclasses.dataclass(frozen=True)
class Decoded:
    """One pre-decoded instruction (SoA-friendly)."""

    op: int
    rd: int = 0
    rn: int = 0
    rm: int = 0
    imm: int = 0  # sign-extended where applicable, byte offsets pre-scaled
    sh: int = 0  # hw shift for MOVZ/K/N (in bits), shift amount for LSLI
    cond: int = 0
    sf: int = 1  # 0 => 32-bit destination (w regs) for MOV-family


def _u(x: int, bits: int) -> int:
    assert 0 <= x < (1 << bits), (x, bits)
    return x


def _s(x: int, bits: int) -> int:
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
    assert lo <= x < hi, (x, bits)
    return x & ((1 << bits) - 1)


def sext(x: int, bits: int) -> int:
    x &= (1 << bits) - 1
    if x & (1 << (bits - 1)):
        x -= 1 << bits
    return x


# ---------------------------------------------------------------------------
# Encoders. Each returns a 32-bit instruction word.
# ---------------------------------------------------------------------------

def movz(rd: int, imm16: int, hw: int = 0, sf: int = 1) -> int:
    base = 0xD2800000 if sf else 0x52800000
    return base | (_u(hw, 2) << 21) | (_u(imm16, 16) << 5) | _u(rd, 5)


def movk(rd: int, imm16: int, hw: int = 0, sf: int = 1) -> int:
    base = 0xF2800000 if sf else 0x72800000
    return base | (_u(hw, 2) << 21) | (_u(imm16, 16) << 5) | _u(rd, 5)


def movn(rd: int, imm16: int, hw: int = 0, sf: int = 1) -> int:
    base = 0x92800000 if sf else 0x12800000
    return base | (_u(hw, 2) << 21) | (_u(imm16, 16) << 5) | _u(rd, 5)


def adrp(rd: int, page_delta: int) -> int:
    """page_delta: signed number of 4 KiB pages relative to pc's page."""
    imm = _s(page_delta, 21)
    immlo, immhi = imm & 0x3, (imm >> 2) & 0x7FFFF
    return 0x90000000 | (immlo << 29) | (immhi << 5) | _u(rd, 5)


def adr(rd: int, byte_delta: int) -> int:
    imm = _s(byte_delta, 21)
    immlo, immhi = imm & 0x3, (imm >> 2) & 0x7FFFF
    return 0x10000000 | (immlo << 29) | (immhi << 5) | _u(rd, 5)


def addi(rd: int, rn: int, imm12: int) -> int:
    return 0x91000000 | (_u(imm12, 12) << 10) | (_u(rn, 5) << 5) | _u(rd, 5)


def subi(rd: int, rn: int, imm12: int) -> int:
    return 0xD1000000 | (_u(imm12, 12) << 10) | (_u(rn, 5) << 5) | _u(rd, 5)


def subsi(rd: int, rn: int, imm12: int) -> int:
    return 0xF1000000 | (_u(imm12, 12) << 10) | (_u(rn, 5) << 5) | _u(rd, 5)


def cmpi(rn: int, imm12: int) -> int:
    return subsi(XZR, rn, imm12)


def add_r(rd: int, rn: int, rm: int) -> int:
    return 0x8B000000 | (_u(rm, 5) << 16) | (_u(rn, 5) << 5) | _u(rd, 5)


def sub_r(rd: int, rn: int, rm: int) -> int:
    return 0xCB000000 | (_u(rm, 5) << 16) | (_u(rn, 5) << 5) | _u(rd, 5)


def subs_r(rd: int, rn: int, rm: int) -> int:
    return 0xEB000000 | (_u(rm, 5) << 16) | (_u(rn, 5) << 5) | _u(rd, 5)


def cmp_r(rn: int, rm: int) -> int:
    return subs_r(XZR, rn, rm)


def orr_r(rd: int, rn: int, rm: int) -> int:
    return 0xAA000000 | (_u(rm, 5) << 16) | (_u(rn, 5) << 5) | _u(rd, 5)


def mov_r(rd: int, rm: int) -> int:
    return orr_r(rd, XZR, rm)


def and_r(rd: int, rn: int, rm: int) -> int:
    return 0x8A000000 | (_u(rm, 5) << 16) | (_u(rn, 5) << 5) | _u(rd, 5)


def eor_r(rd: int, rn: int, rm: int) -> int:
    return 0xCA000000 | (_u(rm, 5) << 16) | (_u(rn, 5) << 5) | _u(rd, 5)


def madd(rd: int, rn: int, rm: int, ra: int = XZR) -> int:
    return 0x9B000000 | (_u(rm, 5) << 16) | (_u(ra, 5) << 10) | (_u(rn, 5) << 5) | _u(rd, 5)


def lsli(rd: int, rn: int, shift: int) -> int:
    """LSL (immediate), 64-bit: UBFM rd, rn, #(-shift % 64), #(63-shift)."""
    assert 0 < shift < 64
    immr, imms = (64 - shift) % 64, 63 - shift
    return 0xD3400000 | (immr << 16) | (imms << 10) | (_u(rn, 5) << 5) | _u(rd, 5)


def ldr_imm(rt: int, rn: int, byte_off: int = 0) -> int:
    assert byte_off % 8 == 0 and byte_off >= 0
    return 0xF9400000 | (_u(byte_off // 8, 12) << 10) | (_u(rn, 5) << 5) | _u(rt, 5)


def str_imm(rt: int, rn: int, byte_off: int = 0) -> int:
    assert byte_off % 8 == 0 and byte_off >= 0
    return 0xF9000000 | (_u(byte_off // 8, 12) << 10) | (_u(rn, 5) << 5) | _u(rt, 5)


def ldr_post(rt: int, rn: int, simm9: int) -> int:
    return 0xF8400400 | (_s(simm9, 9) << 12) | (_u(rn, 5) << 5) | _u(rt, 5)


def str_pre(rt: int, rn: int, simm9: int) -> int:
    return 0xF8000C00 | (_s(simm9, 9) << 12) | (_u(rn, 5) << 5) | _u(rt, 5)


def stp(rt: int, rt2: int, rn: int, byte_off: int = 0) -> int:
    assert byte_off % 8 == 0
    return 0xA9000000 | (_s(byte_off // 8, 7) << 15) | (_u(rt2, 5) << 10) | (_u(rn, 5) << 5) | _u(rt, 5)


def ldp(rt: int, rt2: int, rn: int, byte_off: int = 0) -> int:
    assert byte_off % 8 == 0
    return 0xA9400000 | (_s(byte_off // 8, 7) << 15) | (_u(rt2, 5) << 10) | (_u(rn, 5) << 5) | _u(rt, 5)


def stp_pre(rt: int, rt2: int, rn: int, byte_off: int) -> int:
    assert byte_off % 8 == 0
    return 0xA9800000 | (_s(byte_off // 8, 7) << 15) | (_u(rt2, 5) << 10) | (_u(rn, 5) << 5) | _u(rt, 5)


def ldp_post(rt: int, rt2: int, rn: int, byte_off: int) -> int:
    assert byte_off % 8 == 0
    return 0xA8C00000 | (_s(byte_off // 8, 7) << 15) | (_u(rt2, 5) << 10) | (_u(rn, 5) << 5) | _u(rt, 5)


def ldrb(rt: int, rn: int, byte_off: int = 0) -> int:
    return 0x39400000 | (_u(byte_off, 12) << 10) | (_u(rn, 5) << 5) | _u(rt, 5)


def strb(rt: int, rn: int, byte_off: int = 0) -> int:
    return 0x39000000 | (_u(byte_off, 12) << 10) | (_u(rn, 5) << 5) | _u(rt, 5)


def b(byte_off: int) -> int:
    assert byte_off % 4 == 0
    return 0x14000000 | _s(byte_off // 4, 26)


def bl(byte_off: int) -> int:
    assert byte_off % 4 == 0
    return 0x94000000 | _s(byte_off // 4, 26)


def br(rn: int) -> int:
    return 0xD61F0000 | (_u(rn, 5) << 5)


def blr(rn: int) -> int:
    return 0xD63F0000 | (_u(rn, 5) << 5)


def ret(rn: int = LR) -> int:
    return 0xD65F0000 | (_u(rn, 5) << 5)


def cbz(rt: int, byte_off: int) -> int:
    assert byte_off % 4 == 0
    return 0xB4000000 | (_s(byte_off // 4, 19) << 5) | _u(rt, 5)


def cbnz(rt: int, byte_off: int) -> int:
    assert byte_off % 4 == 0
    return 0xB5000000 | (_s(byte_off // 4, 19) << 5) | _u(rt, 5)


def b_cond(cond: Union[str, int], byte_off: int) -> int:
    c = COND[cond] if isinstance(cond, str) else cond
    assert byte_off % 4 == 0
    return 0x54000000 | (_s(byte_off // 4, 19) << 5) | _u(c, 4)


def svc(imm16: int = 0) -> int:
    return 0xD4000001 | (_u(imm16, 16) << 5)


def brk(imm16: int = 0) -> int:
    return 0xD4200000 | (_u(imm16, 16) << 5)


def hlt(imm16: int = 0) -> int:
    return 0xD4400000 | (_u(imm16, 16) << 5)


NOP_WORD = 0xD503201F
# A guaranteed-undefined encoding (used as the paper's "illegal instruction"
# replacement alternative to brk).
UDF_WORD = 0x00000000


def nop() -> int:
    return NOP_WORD


def mov_imm48(rd: int, value: int) -> List[int]:
    """movz/movk/movk sequence loading a 48-bit immediate — the L1 pattern."""
    assert 0 <= value < (1 << 48), value
    return [
        movz(rd, value & 0xFFFF, 0),
        movk(rd, (value >> 16) & 0xFFFF, 1),
        movk(rd, (value >> 32) & 0xFFFF, 2),
    ]


# ---------------------------------------------------------------------------
# Decoder: word -> Decoded. Linear-scan disassembly applies this to every
# 4-byte word of every executable section (the paper uses GNU libopcodes).
# ---------------------------------------------------------------------------

def decode(word: int) -> Decoded:
    w = word & 0xFFFFFFFF
    if w == NOP_WORD:
        return Decoded(Op.NOP)
    top9 = w >> 23

    # Move wide (immediate): sf oc 100101 hw imm16 rd
    if (w & 0x1F800000) == 0x12800000:
        sf = (w >> 31) & 1
        opc = (w >> 29) & 0x3
        hw = (w >> 21) & 0x3
        imm16 = (w >> 5) & 0xFFFF
        rd = w & 0x1F
        op = {0: Op.MOVN, 2: Op.MOVZ, 3: Op.MOVK}.get(opc)
        if op is None:
            return Decoded(Op.ILLEGAL)
        return Decoded(op, rd=rd, imm=imm16, sh=16 * hw, sf=sf)

    # ADR/ADRP
    if (w & 0x1F000000) == 0x10000000:
        rd = w & 0x1F
        immlo = (w >> 29) & 0x3
        immhi = (w >> 5) & 0x7FFFF
        imm = sext((immhi << 2) | immlo, 21)
        if w >> 31:
            return Decoded(Op.ADRP, rd=rd, imm=imm << 12)
        return Decoded(Op.ADR, rd=rd, imm=imm)

    # Add/sub immediate (64-bit only in our subset)
    if (w & 0x1FC00000) == 0x11000000 and (w >> 31):
        kind = (w >> 29) & 0x3  # 0=add,1=adds,2=sub,3=subs
        imm12 = (w >> 10) & 0xFFF
        rn, rd = (w >> 5) & 0x1F, w & 0x1F
        op = {0: Op.ADDI, 2: Op.SUBI, 3: Op.SUBSI}.get(kind)
        if op is None:
            return Decoded(Op.ILLEGAL)
        return Decoded(op, rd=rd, rn=rn, imm=imm12)

    # LSL immediate (UBFM 64-bit with our fixed pattern)
    if (w & 0xFFC00000) == 0xD3400000:
        immr = (w >> 16) & 0x3F
        imms = (w >> 10) & 0x3F
        if imms != 63 and immr == ((imms + 1) % 64):
            return Decoded(Op.LSLI, rd=w & 0x1F, rn=(w >> 5) & 0x1F, sh=63 - imms)
        return Decoded(Op.ILLEGAL)

    # Shifted-register ALU (shift amount 0 only, 64-bit)
    for base, op in ((0x8B000000, Op.ADDR), (0xCB000000, Op.SUBR),
                     (0xEB000000, Op.SUBSR), (0xAA000000, Op.ORRR),
                     (0x8A000000, Op.ANDR), (0xCA000000, Op.EORR)):
        if (w & 0xFFE0FC00) == base:
            return Decoded(op, rd=w & 0x1F, rn=(w >> 5) & 0x1F, rm=(w >> 16) & 0x1F)

    # MADD (64-bit)
    if (w & 0xFFE08000) == 0x9B000000:
        return Decoded(Op.MADD, rd=w & 0x1F, rn=(w >> 5) & 0x1F,
                       rm=(w >> 16) & 0x1F, imm=(w >> 10) & 0x1F)  # imm=ra

    # Loads/stores (64-bit unsigned imm)
    if (w & 0xFFC00000) == 0xF9400000:
        return Decoded(Op.LDRI, rd=w & 0x1F, rn=(w >> 5) & 0x1F, imm=((w >> 10) & 0xFFF) * 8)
    if (w & 0xFFC00000) == 0xF9000000:
        return Decoded(Op.STRI, rd=w & 0x1F, rn=(w >> 5) & 0x1F, imm=((w >> 10) & 0xFFF) * 8)
    if (w & 0xFFE00C00) == 0xF8400400:
        return Decoded(Op.LDRPOST, rd=w & 0x1F, rn=(w >> 5) & 0x1F, imm=sext(w >> 12, 9))
    if (w & 0xFFE00C00) == 0xF8000C00:
        return Decoded(Op.STRPRE, rd=w & 0x1F, rn=(w >> 5) & 0x1F, imm=sext(w >> 12, 9))

    # Byte loads/stores
    if (w & 0xFFC00000) == 0x39400000:
        return Decoded(Op.LDRB, rd=w & 0x1F, rn=(w >> 5) & 0x1F, imm=(w >> 10) & 0xFFF)
    if (w & 0xFFC00000) == 0x39000000:
        return Decoded(Op.STRB, rd=w & 0x1F, rn=(w >> 5) & 0x1F, imm=(w >> 10) & 0xFFF)

    # Register pairs
    for base, op in ((0xA9000000, Op.STP), (0xA9400000, Op.LDP),
                     (0xA9800000, Op.STPPRE), (0xA8C00000, Op.LDPPOST)):
        if (w & 0xFFC00000) == base:
            return Decoded(op, rd=w & 0x1F, rn=(w >> 5) & 0x1F,
                           rm=(w >> 10) & 0x1F, imm=sext(w >> 15, 7) * 8)  # rm=rt2

    # Branches
    if (w & 0xFC000000) == 0x14000000:
        return Decoded(Op.B, imm=sext(w, 26) * 4)
    if (w & 0xFC000000) == 0x94000000:
        return Decoded(Op.BL, imm=sext(w, 26) * 4)
    if (w & 0xFFFFFC1F) == 0xD61F0000:
        return Decoded(Op.BR, rn=(w >> 5) & 0x1F)
    if (w & 0xFFFFFC1F) == 0xD63F0000:
        return Decoded(Op.BLR, rn=(w >> 5) & 0x1F)
    if (w & 0xFFFFFC1F) == 0xD65F0000:
        return Decoded(Op.RET, rn=(w >> 5) & 0x1F)
    if (w & 0xFF000000) == 0xB4000000:
        return Decoded(Op.CBZ, rd=w & 0x1F, imm=sext(w >> 5, 19) * 4)
    if (w & 0xFF000000) == 0xB5000000:
        return Decoded(Op.CBNZ, rd=w & 0x1F, imm=sext(w >> 5, 19) * 4)
    if (w & 0xFF000010) == 0x54000000:
        return Decoded(Op.BCOND, cond=w & 0xF, imm=sext(w >> 5, 19) * 4)

    # Exceptions
    if (w & 0xFFE0001F) == 0xD4000001:
        return Decoded(Op.SVC, imm=(w >> 5) & 0xFFFF)
    if (w & 0xFFE0001F) == 0xD4200000:
        return Decoded(Op.BRK, imm=(w >> 5) & 0xFFFF)
    if (w & 0xFFE0001F) == 0xD4400000:
        return Decoded(Op.HLT, imm=(w >> 5) & 0xFFFF)

    return Decoded(Op.ILLEGAL)


def is_svc(word: int) -> bool:
    return decode(word).op == Op.SVC


def is_x8_assign(word: int) -> bool:
    """Is this an assignment to x8/w8 that the rewriter may displace?

    The syscall ABI materialises the syscall number in x8; compilers emit
    ``mov w8, #NR`` (MOVZ) in virtually all cases.  Register moves and loads
    into x8 also qualify (they are position-independent, so re-executing them
    in the L2 trampoline is safe).  PC-relative producers (ADR/ADRP/LDR
    literal) would change meaning when re-executed at the trampoline's PC and
    are rejected — such sites fall back to the signal path (strategy C1).
    """
    d = decode(word)
    if d.op in (Op.MOVZ, Op.MOVN) and d.rd == 8:
        return True
    if d.op in (Op.ORRR, Op.ADDR, Op.SUBR, Op.ANDR, Op.EORR, Op.MADD) and d.rd == 8:
        return True
    if d.op in (Op.LDRI, Op.LDRPOST, Op.LDRB) and d.rd == 8 and d.rn != 8:
        return True
    return False


# ---------------------------------------------------------------------------
# Two-pass assembler with labels and external symbols.
# ---------------------------------------------------------------------------

class Asm:
    """Tiny two-pass assembler.

    Usage::

        a = Asm(base=0x10000)
        a.label("loop")
        a.emit(isa.subsi(19, 19, 1))
        a.b_to("loop", cond="ne")
        words = a.assemble(symbols={"getpid": 0x20000})
    """

    def __init__(self, base: int):
        self.base = base
        self.items: List[Tuple[str, object]] = []  # ("word", int) | ("fix", (kind, target, args))
        self.labels: Dict[str, int] = {}

    # -- building blocks ----------------------------------------------------
    def emit(self, *words: int) -> "Asm":
        for w in words:
            self.items.append(("word", w))
        return self

    def label(self, name: str) -> "Asm":
        self.labels[name] = len(self.items)
        return self

    def here(self) -> int:
        return self.base + WORD * len(self.items)

    def b_to(self, target: str, cond: str | None = None) -> "Asm":
        self.items.append(("fix", ("bcond" if cond else "b", target, cond)))
        return self

    def bl_to(self, target: str) -> "Asm":
        self.items.append(("fix", ("bl", target, None)))
        return self

    def cbz_to(self, rt: int, target: str) -> "Asm":
        self.items.append(("fix", ("cbz", target, rt)))
        return self

    def cbnz_to(self, rt: int, target: str) -> "Asm":
        self.items.append(("fix", ("cbnz", target, rt)))
        return self

    def adr_to(self, rd: int, target: str) -> "Asm":
        self.items.append(("fix", ("adr", target, rd)))
        return self

    def mov48_sym(self, rd: int, target: str, delta: int = 0) -> "Asm":
        """movz/movk/movk rd, #(addr_of(target) + delta) — resolved at link."""
        for part in ("mov48_0", "mov48_1", "mov48_2"):
            self.items.append(("fix", (part, target, (rd, delta))))
        return self

    # -- assembly ------------------------------------------------------------
    def _addr_of(self, name: str, symbols: Dict[str, int]) -> int:
        if name in self.labels:
            return self.base + WORD * self.labels[name]
        if name in symbols:
            return symbols[name]
        raise KeyError(f"unresolved symbol {name!r}")

    def assemble(self, symbols: Dict[str, int] | None = None) -> List[int]:
        symbols = symbols or {}
        out: List[int] = []
        for i, (kind, payload) in enumerate(self.items):
            pc = self.base + WORD * i
            if kind == "word":
                out.append(payload)  # type: ignore[arg-type]
                continue
            fk, target, arg = payload  # type: ignore[misc]
            taddr = self._addr_of(target, symbols)
            off = taddr - pc
            if fk == "b":
                out.append(b(off))
            elif fk == "bl":
                out.append(bl(off))
            elif fk == "bcond":
                out.append(b_cond(arg, off))
            elif fk == "cbz":
                out.append(cbz(arg, off))
            elif fk == "cbnz":
                out.append(cbnz(arg, off))
            elif fk == "adr":
                out.append(adr(arg, off))
            elif fk in ("mov48_0", "mov48_1", "mov48_2"):
                rd, delta = arg
                value = taddr + delta
                part = int(fk[-1])
                if part == 0:
                    out.append(movz(rd, value & 0xFFFF, 0))
                else:
                    out.append(movk(rd, (value >> (16 * part)) & 0xFFFF, part))
            else:  # pragma: no cover
                raise ValueError(fk)
        return out

    def size_bytes(self) -> int:
        return WORD * len(self.items)
