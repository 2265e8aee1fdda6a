"""The shared op-spec table: one declarative row per opcode (PyTorch port).

The rows, class enums and syscall table are the JAX package's, unchanged.
What differs is where the columns live: :data:`TABLES_NP` holds them as
numpy arrays, and :func:`spec_tables` puts the same columns on a device as
tensors.  The port's executors — the lane-vectorised plain version in
:mod:`repro_torch.core.fleet` and the CUDA megastep kernel, which receives
the columns as a device-pointer table — index the same arrays, so a new
opcode or syscall family stays one row here.

This module is a pure table: it imports only the ISA enum, the layout and
the cost model, so :mod:`machine` and :mod:`fleet` import it without a
cycle.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import costmodel as cm
from . import layout as L
from .isa import Op

# ---------------------------------------------------------------------------
# per-op class enums (the column value spaces)
# ---------------------------------------------------------------------------

# ALU / primary-write value classes: which expression feeds register slot A.
(A_NONE, A_MOVZ, A_MOVN, A_MOVK, A_ADRP, A_ADR, A_ADD_I, A_SUB_I, A_ADD_R,
 A_SUB_R, A_ORR, A_AND, A_EOR, A_MADD, A_LSL, A_LOAD, A_LOAD_B,
 A_LINK) = range(18)

# Flag-setting classes (NZCV from a subtract).
F_NONE, F_SUBS_I, F_SUBS_R = range(3)

# Memory-effect classes.
(M_NONE, M_LOAD, M_STORE, M_LOAD_P, M_STORE_P, M_LOAD_BYTE,
 M_STORE_BYTE) = range(7)

# Program-counter classes (the halt transitions ride on these: P_STAY parks
# the pc on a halting op, P_TRAP delivers a signal or HALT_TRAPs).
(P_NEXT, P_REL, P_IND, P_CBZ, P_CBNZ, P_BCOND, P_STAY, P_TRAP,
 P_SVC) = range(9)


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One opcode's complete semantics, declaratively.

    ``alu`` selects the primary register-write expression (A_NONE = no
    write); ``wb_sp``/``wb_lr`` steer where it lands (rd-as-SP for
    add/sub-immediate, the link register for calls).  ``flags`` is the
    NZCV update class, ``mem`` the memory effect, ``addr_post`` /
    ``wb_base`` the addressing mode (post-index vs offset, base
    write-back).  ``pc`` is the control-flow class; ``segv``/``exit_``
    mark the direct halt transitions and ``signo`` the delivered signal
    for trap-class ops.  ``cost`` is the base cycle cost.
    """

    alu: int = A_NONE
    wb_sp: bool = False
    wb_lr: bool = False
    flags: int = F_NONE
    mem: int = M_NONE
    addr_post: bool = False
    wb_base: bool = False
    pc: int = P_NEXT
    segv: bool = False
    exit_: bool = False
    signo: int = 0
    cost: int = cm.COST_ALU


SPECS = {
    Op.ILLEGAL: OpSpec(pc=P_TRAP, signo=L.SIGILL),
    Op.NULLPAGE: OpSpec(pc=P_STAY, segv=True),
    Op.MOVZ: OpSpec(alu=A_MOVZ),
    Op.MOVK: OpSpec(alu=A_MOVK),
    Op.MOVN: OpSpec(alu=A_MOVN),
    Op.ADRP: OpSpec(alu=A_ADRP),
    Op.ADR: OpSpec(alu=A_ADR),
    Op.ADDI: OpSpec(alu=A_ADD_I, wb_sp=True),
    Op.SUBI: OpSpec(alu=A_SUB_I, wb_sp=True),
    Op.SUBSI: OpSpec(alu=A_SUB_I, flags=F_SUBS_I),
    Op.ADDR: OpSpec(alu=A_ADD_R),
    Op.SUBR: OpSpec(alu=A_SUB_R),
    Op.SUBSR: OpSpec(alu=A_SUB_R, flags=F_SUBS_R),
    Op.ORRR: OpSpec(alu=A_ORR),
    Op.ANDR: OpSpec(alu=A_AND),
    Op.EORR: OpSpec(alu=A_EOR),
    Op.MADD: OpSpec(alu=A_MADD),
    Op.LDRI: OpSpec(alu=A_LOAD, mem=M_LOAD, cost=cm.COST_MEM),
    Op.STRI: OpSpec(mem=M_STORE, cost=cm.COST_MEM),
    Op.LDRPOST: OpSpec(alu=A_LOAD, mem=M_LOAD, addr_post=True,
                       wb_base=True, cost=cm.COST_MEM),
    Op.STRPRE: OpSpec(mem=M_STORE, wb_base=True, cost=cm.COST_MEM),
    Op.STP: OpSpec(mem=M_STORE_P, cost=cm.COST_MEM),
    Op.LDP: OpSpec(alu=A_LOAD, mem=M_LOAD_P, cost=cm.COST_MEM),
    Op.STPPRE: OpSpec(mem=M_STORE_P, wb_base=True, cost=cm.COST_MEM),
    Op.LDPPOST: OpSpec(alu=A_LOAD, mem=M_LOAD_P, addr_post=True,
                       wb_base=True, cost=cm.COST_MEM),
    Op.B: OpSpec(pc=P_REL, cost=cm.COST_BRANCH),
    Op.BL: OpSpec(alu=A_LINK, wb_lr=True, pc=P_REL, cost=cm.COST_CALL),
    Op.BR: OpSpec(pc=P_IND, cost=cm.COST_INDIRECT),
    Op.BLR: OpSpec(alu=A_LINK, wb_lr=True, pc=P_IND, cost=cm.COST_INDIRECT),
    Op.RET: OpSpec(pc=P_IND, cost=cm.COST_CALL),
    Op.CBZ: OpSpec(pc=P_CBZ, cost=cm.COST_BRANCH),
    Op.CBNZ: OpSpec(pc=P_CBNZ, cost=cm.COST_BRANCH),
    Op.BCOND: OpSpec(pc=P_BCOND, cost=cm.COST_BRANCH),
    Op.SVC: OpSpec(pc=P_SVC),
    Op.BRK: OpSpec(pc=P_TRAP, signo=L.SIGTRAP),
    Op.NOP: OpSpec(),
    Op.LDRB: OpSpec(alu=A_LOAD_B, mem=M_LOAD_BYTE, cost=cm.COST_MEM),
    Op.STRB: OpSpec(mem=M_STORE_BYTE, cost=cm.COST_MEM),
    Op.HLT: OpSpec(pc=P_STAY, exit_=True),
    Op.LSLI: OpSpec(alu=A_LSL),
}
assert len(SPECS) == int(Op.N_OPS), "every opcode needs a spec row"


def _col(field, dtype):
    return np.asarray([getattr(SPECS[Op(i)], field)
                       for i in range(int(Op.N_OPS))], dtype)


# Host-side (numpy) columns, indexed by Op value.
ALU_NP = _col("alu", np.int32)
WB_SP_NP = _col("wb_sp", bool)
WB_LR_NP = _col("wb_lr", bool)
FLAGS_NP = _col("flags", np.int32)
MEM_NP = _col("mem", np.int32)
ADDR_POST_NP = _col("addr_post", bool)
WB_BASE_NP = _col("wb_base", bool)
PC_NP = _col("pc", np.int32)
SEGV_NP = _col("segv", bool)
EXIT_NP = _col("exit_", bool)
SIGNO_NP = _col("signo", np.int64)
COST_TABLE_NP = _col("cost", np.int64)


# ---------------------------------------------------------------------------
# condition codes: one bitmask word per cond instead of 14 predicate trees
# ---------------------------------------------------------------------------

def _cond_mask() -> np.ndarray:
    """``COND_MASK[cond]`` has bit ``nzcv`` set iff the condition holds at
    that flag state — the Arm ARM's 16 predicates folded into sixteen
    16-bit constants (conds 14/15 are AL).  The pick is then one tiny
    gather + shift, shared by every executor."""
    masks = np.zeros(16, np.int64)
    for nzcv in range(16):
        n, z = bool(nzcv & 8), bool(nzcv & 4)
        c, v = bool(nzcv & 2), bool(nzcv & 1)
        preds = (z, not z, c, not c, n, not n, v, not v,
                 c and not z, not (c and not z), n == v, n != v,
                 (not z) and n == v, not ((not z) and n == v), True, True)
        for i, p in enumerate(preds):
            if p:
                masks[i] |= np.int64(1) << nzcv
    return masks


COND_MASK_NP = _cond_mask()

# ---------------------------------------------------------------------------
# the column bundle
# ---------------------------------------------------------------------------

class SpecTables(NamedTuple):
    """Every spec column an executor gathers per step, as one bundle —
    numpy arrays (:data:`TABLES_NP`) or tensors on a device
    (:func:`spec_tables`).  Dtypes: int32 class columns, bool flag
    columns, int64 ``SIGNO`` / ``COST_TABLE`` / ``COND_MASK``; every column
    is ``[N_OPS]`` except ``COND_MASK`` (``[16]``)."""

    ALU: object
    WB_SP: object
    WB_LR: object
    FLAGS: object
    MEM: object
    ADDR_POST: object
    WB_BASE: object
    PC: object
    SEGV: object
    EXIT: object
    SIGNO: object
    COST_TABLE: object
    COND_MASK: object


TABLES_NP = SpecTables(
    ALU=ALU_NP, WB_SP=WB_SP_NP, WB_LR=WB_LR_NP, FLAGS=FLAGS_NP, MEM=MEM_NP,
    ADDR_POST=ADDR_POST_NP, WB_BASE=WB_BASE_NP, PC=PC_NP, SEGV=SEGV_NP,
    EXIT=EXIT_NP, SIGNO=SIGNO_NP, COST_TABLE=COST_TABLE_NP,
    COND_MASK=COND_MASK_NP)


def spec_tables(device) -> SpecTables:
    """The 13 columns as tensors on ``device`` (same dtypes as numpy)."""
    return SpecTables(*(torch.as_tensor(a).to(device) for a in TABLES_NP))


def cond_holds(nzcv, cond, mask_lut):
    """Batched B.cond predicate from the ``COND_MASK`` column ``mask_lut``
    (a tensor on the lanes' device).  Only the low four bits of ``nzcv``
    participate."""
    mask = mask_lut[cond.clamp(0, 15).long()]
    return ((mask >> (nzcv & 15)) & 1) != 0


# ---------------------------------------------------------------------------
# the syscall table: one row per modelled syscall family
# ---------------------------------------------------------------------------

# Kernel-branch kinds.  K_CONST returns ``const`` (the whole family of
# "succeed with a fixed value" syscalls); everything not in the table falls
# through to -ENOSYS and the UNKNOWN policy slot.  The K_OPENAT..K_IOCTL
# kinds are serviced by the guest-kernel emulation subsystem
# (:mod:`repro.emul`) on lanes with ``k_enabled`` set; on legacy lanes
# (``k_enabled == 0``) K_OPENAT/K_CLOSE fall back to their historical
# constant returns and the remaining emulated kinds to -ENOSYS, which is
# exactly the pre-emulation surface.
(K_IO_READ, K_IO_WRITE, K_GETPID, K_EXIT, K_SIGRETURN, K_CONST,
 K_OPENAT, K_CLOSE, K_LSEEK, K_DUP, K_FSTAT, K_PIPE2, K_GETRANDOM,
 K_IOCTL) = range(14)


@dataclasses.dataclass(frozen=True)
class SyscallSpec:
    """One modelled syscall: its arm64 number, kernel-branch kind and (for
    K_CONST rows, or the disabled-emulation fallback of K_OPENAT/K_CLOSE)
    the constant return value.  ``emul`` marks rows serviced by the
    guest-kernel emulation branch — the rows an EMULATE policy verdict can
    route into instead of substituting a constant.  Row order fixes the
    policy / histogram slot numbering, so append new families at the end.
    """

    name: str
    nr: int
    kind: int
    const: int = 0
    emul: bool = False


SYSCALLS = (
    SyscallSpec("read", L.SYS_READ, K_IO_READ, emul=True),
    SyscallSpec("write", L.SYS_WRITE, K_IO_WRITE, emul=True),
    SyscallSpec("getpid", L.SYS_GETPID, K_GETPID),
    SyscallSpec("exit", L.SYS_EXIT, K_EXIT),
    SyscallSpec("rt_sigreturn", L.SYS_RT_SIGRETURN, K_SIGRETURN),
    SyscallSpec("openat", L.SYS_OPENAT, K_OPENAT, const=3, emul=True),
    SyscallSpec("close", L.SYS_CLOSE, K_CLOSE, const=0, emul=True),
    SyscallSpec("lseek", L.SYS_LSEEK, K_LSEEK, emul=True),
    SyscallSpec("dup", L.SYS_DUP, K_DUP, emul=True),
    SyscallSpec("fstat", L.SYS_FSTAT, K_FSTAT, emul=True),
    SyscallSpec("pipe2", L.SYS_PIPE2, K_PIPE2, emul=True),
    SyscallSpec("getrandom", L.SYS_GETRANDOM, K_GETRANDOM, emul=True),
    SyscallSpec("ioctl", L.SYS_IOCTL, K_IOCTL, emul=True),
)

# Policy table slots: one per table row, plus the catch-all UNKNOWN slot
# every other number (the sys_enosys fall-through) resolves to.
TRACE_SYS = tuple(s.nr for s in SYSCALLS)
SLOT_UNKNOWN = len(SYSCALLS)
N_POLICY_SLOTS = len(SYSCALLS) + 1

# Per-slot actions (seccomp-style); also the recorded verdict codes, with
# UNKNOWN marking an ALLOWed syscall that fell through to -ENOSYS.
POL_ALLOW, POL_DENY, POL_EMULATE, POL_KILL = 0, 1, 2, 3
VERDICT_UNKNOWN = 4
N_VERDICTS = 5


def slot_of(nr: int) -> int:
    """Policy/histogram slot for a syscall number (UNKNOWN if unmodelled)."""
    return TRACE_SYS.index(nr) if nr in TRACE_SYS else SLOT_UNKNOWN


# The syscall rows as three columns, for executors that take the table as
# operands (the CUDA megastep kernel walks these exactly like the plain
# version walks SYSCALLS).
SYS_NR_NP = np.asarray([s.nr for s in SYSCALLS], np.int64)
SYS_KIND_NP = np.asarray([s.kind for s in SYSCALLS], np.int64)
SYS_CONST_NP = np.asarray([s.const for s in SYSCALLS], np.int64)
SYS_EMUL_NP = np.asarray([s.emul for s in SYSCALLS], np.int64)
