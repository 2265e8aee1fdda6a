"""The simulated AArch64 machine's carry types (PyTorch port).

Programs are decoded once, host-side, into structure-of-arrays field
tables covering the whole executable region ``[0, CODE_LIMIT)``
(:func:`decode_image`).  A machine state is a :class:`MachineState` of
int64 tensors with the JAX package's 34 leaves, in the same order.  There
is no separate scalar interpreter: :func:`run_image` lifts one process to
a width-1 fleet and runs the fleet path (:mod:`repro_torch.core.fleet`),
and :func:`step` runs one instruction through the fleet's executor body
with the live mask forced on, as the JAX package's scalar ``step`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import layout as L
from .isa import Op, decode

I64 = torch.int64

# halted codes
RUNNING = 0
HALT_EXIT = 1
HALT_SEGV = 2
HALT_TRAP = 3  # brk/illegal with no handler registered
HALT_FUEL = 4
HALT_BADMEM = 5
HALT_KILL = 6  # terminated by a seccomp-style KILL policy (fleet/serve only)

SIGFRAME_WORDS = 34  # x0..x30, sp, pc, nzcv
_SIGFRAME_IDX = (L.SIGFRAME - L.DATA_BASE) // 8


class DecodedImage(NamedTuple):
    """SoA decode tables over [0, CODE_LIMIT) (CPU tensors)."""

    op: torch.Tensor   # int32[CODE_WORDS]
    rd: torch.Tensor
    rn: torch.Tensor
    rm: torch.Tensor
    sh: torch.Tensor
    cond: torch.Tensor
    sf: torch.Tensor
    imm: torch.Tensor  # int64[CODE_WORDS]


class MachineState(NamedTuple):
    """One process (0-d leaves, ``regs [31]``, ``mem [MEM_WORDS]``) or a
    fleet (a leading lane axis on every leaf).  All leaves are int64."""

    regs: torch.Tensor  # int64[31]
    sp: torch.Tensor
    pc: torch.Tensor
    nzcv: torch.Tensor  # int64 bitfield N=8 Z=4 C=2 V=1
    mem: torch.Tensor   # int64[MEM_WORDS]
    cycles: torch.Tensor
    icount: torch.Tensor
    fuel: torch.Tensor
    halted: torch.Tensor
    exit_code: torch.Tensor
    fault_pc: torch.Tensor
    sig_handler: torch.Tensor  # 0 = none
    in_signal: torch.Tensor
    ptrace: torch.Tensor
    virt_getpid: torch.Tensor
    hook_count: torch.Tensor   # tracer-side hook invocations (ptrace mode)
    pid: torch.Tensor
    in_off: torch.Tensor       # modelled input-stream position (read)
    out_count: torch.Tensor    # modelled output effects (write)
    out_sum: torch.Tensor
    enosys_count: torch.Tensor  # syscalls that fell through to -ENOSYS
    emul_served: torch.Tensor   # syscalls serviced by the guest kernel
    # -- guest-kernel emulation carry (layout in repro_torch.emul.state) ---
    k_enabled: torch.Tensor    # per-lane emulation gate (0 = legacy stubs)
    k_rng: torch.Tensor
    k_fd_ofd: torch.Tensor     # int64[MAX_FDS]
    k_ofd_kind: torch.Tensor   # int64[MAX_FDS]
    k_ofd_ino: torch.Tensor    # int64[MAX_FDS]
    k_ofd_off: torch.Tensor    # int64[MAX_FDS]
    k_ofd_flags: torch.Tensor  # int64[MAX_FDS]
    k_ofd_ref: torch.Tensor    # int64[MAX_FDS]
    k_ino_kind: torch.Tensor   # int64[MAX_INODES]
    k_ino_name: torch.Tensor   # int64[MAX_INODES]
    k_ino_size: torch.Tensor   # int64[MAX_INODES]
    k_ino_data: torch.Tensor   # int64[MAX_INODES * FILE_WORDS]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    Never falls back to the CPU: with no card, the caller has to ask for
    ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the CPU")
    return dev


def decode_image(code_words: np.ndarray) -> DecodedImage:
    """Host-side linear decode of the full executable region."""
    assert code_words.shape == (L.CODE_WORDS,)
    op = np.full(L.CODE_WORDS, int(Op.ILLEGAL), np.int32)
    rd = np.zeros(L.CODE_WORDS, np.int32)
    rn = np.zeros(L.CODE_WORDS, np.int32)
    rm = np.zeros(L.CODE_WORDS, np.int32)
    sh = np.zeros(L.CODE_WORDS, np.int32)
    cond = np.zeros(L.CODE_WORDS, np.int32)
    sf = np.ones(L.CODE_WORDS, np.int32)
    imm = np.zeros(L.CODE_WORDS, np.int64)
    for i in range(L.CODE_WORDS):
        w = int(code_words[i])
        if i < L.NULL_END // 4:
            op[i] = int(Op.NULLPAGE)  # the unmapped null page
            continue
        if w == 0:
            continue  # stays ILLEGAL (also the paper's "illegal instruction")
        d = decode(w)
        op[i], rd[i], rn[i], rm[i] = int(d.op), d.rd, d.rn, d.rm
        sh[i], cond[i], sf[i], imm[i] = d.sh, d.cond, d.sf, d.imm
    return DecodedImage(*(torch.from_numpy(a)
                          for a in (op, rd, rn, rm, sh, cond, sf, imm)))


def make_state(entry_pc: int, fuel: int = 2_000_000,
               device="cpu") -> MachineState:
    """A fresh scalar state at ``entry_pc`` (every leaf its own buffer)."""
    from ..emul import state as emul_state

    def z():
        return torch.zeros((), dtype=I64, device=device)

    def full(v):
        return torch.full((), v, dtype=I64, device=device)

    return MachineState(
        regs=torch.zeros(31, dtype=I64, device=device),
        sp=full(L.STACK_TOP),
        pc=full(entry_pc),
        nzcv=z(),
        mem=torch.zeros(L.MEM_WORDS, dtype=I64, device=device),
        cycles=z(), icount=z(), fuel=full(fuel),
        halted=z(), exit_code=z(), fault_pc=z(),
        sig_handler=z(), in_signal=z(), ptrace=z(), virt_getpid=z(),
        hook_count=z(), pid=full(L.PID), in_off=z(), out_count=z(),
        out_sum=z(), enosys_count=z(), emul_served=z(),
        **emul_state.fresh_kern_scalar(device=device),
    )


def run_image(img: DecodedImage, state: MachineState, *,
              device=None) -> MachineState:
    """Run one process to halt (or out of fuel): a width-1 fleet run.

    ``device=None`` means the card (see :func:`resolve_device`)."""
    from . import fleet as F  # deferred: fleet imports this module

    out = F.run_fleet([img], F.stack_states([state]), device=device)
    return F.unstack_state(out, 0)


def step(img: DecodedImage, s: MachineState) -> MachineState:
    """One instruction, unconditionally: the state is lifted to a width-1
    fleet and run through the fleet's executor body
    (:func:`repro_torch.core.fleet.exec_lanes`) with the live-lane mask
    forced all-true, so a halted or out-of-fuel state still steps, as in
    the JAX package's scalar ``step``.  Runs the plain executor on the
    state's device; returns a new state and leaves ``s`` intact."""
    from . import fleet as F  # deferred: fleet imports this module

    dev = s.pc.device
    pc = int(s.pc)
    i = min(max(pc >> 2, 0), L.CODE_WORDS - 1)
    ok_fetch = 0 <= pc < L.CODE_LIMIT and pc % 4 == 0
    fields = tuple(t[i:i + 1].to(dev) for t in img)
    if not ok_fetch:
        fields = (torch.full((1,), int(Op.NULLPAGE), dtype=torch.int32,
                             device=dev),) + fields[1:]
    lifted = MachineState(*(x[None].clone() for x in s))
    out, _ = F.exec_lanes(fields, lifted, None,
                          act=torch.ones((1,), dtype=torch.bool, device=dev))
    return MachineState(*(x[0] for x in out))


# -- host-side convenience ----------------------------------------------------

def _word_index(addr: int) -> int:
    if addr % 8 or not L.DATA_BASE <= addr < L.MEM_LIMIT:
        raise ValueError(f"address {addr:#x}: not an aligned data word")
    return (addr - L.DATA_BASE) // 8


def mem_read(state: MachineState, addr: int) -> int:
    """One memory word of a scalar state."""
    return int(state.mem[_word_index(addr)])


def mem_read_block(state: MachineState, addr: int, nwords: int) -> np.ndarray:
    """``nwords`` consecutive words in one device-to-host copy (a host
    array of its own)."""
    i0 = _word_index(addr)
    if nwords < 0 or i0 + nwords > L.MEM_WORDS:
        raise ValueError(f"{nwords} words from {addr:#x} leave memory")
    return state.mem[i0:i0 + nwords].cpu().numpy().copy()


def mem_write(state: MachineState, addr: int, value: int) -> MachineState:
    """A new state with one memory word set; ``state`` is left intact."""
    mem = state.mem.clone()
    mem[_word_index(addr)] = value
    return state._replace(mem=mem)
