"""Batched fleet execution engine: N simulated processes (PyTorch port).

The step is natively batched over lanes (:func:`exec_lanes`): one fetch
gather per decode table, register reads as one ``gather``, all register,
ALU and branch semantics as masked selects, and memory traffic as at most
two word gathers and two word stores per step, plus the 34-word sigframe
window and the syscall I/O fill/sum, which only lanes that need them pay
for.  This lane-vectorised eager step is the plain PyTorch version of the
CUDA megastep kernel (:mod:`repro_torch.kernels.megastep`); on the card
every chunk of steps runs in that kernel instead.

What this slice ports: the untraced executor for lanes whose guest-kernel
emulation is off (``k_enabled == 0``, i.e. prepared with
``HookConfig(emul_enabled=False)``).  Tracing, lane sharding, compaction
and the emulation service are later slices; their entry points raise
``NotImplementedError``.

Carry semantics: the ``[B, MEM_WORDS]`` memory plane is updated in place
(it is never copied per step); the drivers update every leaf of the carry
they are given in place, as the JAX package's entry points donate theirs.
Per lane, results are bit-identical to the JAX package's fleet engine.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from . import costmodel as cm
from . import layout as L
from . import opspec
from .isa import Op
from .machine import (HALT_BADMEM, HALT_EXIT, HALT_FUEL, HALT_SEGV,
                      HALT_TRAP, RUNNING, SIGFRAME_WORDS, DecodedImage,
                      MachineState, _SIGFRAME_IDX, resolve_device)

I64 = torch.int64
I32 = torch.int32

_MAX_IO_WORDS = 4096
_COUNTER_IDX = (L.COUNTER - L.DATA_BASE) // 8

DEFAULT_CHUNK = 8

_EMUL_HINT = ("guest-kernel emulation (k_enabled != 0) is not ported yet "
              "(emulation slice, K3); prepare the processes with "
              "cfg=HookConfig(emul_enabled=False)")
_TRACE_HINT = "traced fleets (trace=...) are not ported yet (trace slice, K2)"


# ---------------------------------------------------------------------------
# stacking helpers
# ---------------------------------------------------------------------------

def stack_images(imgs: Sequence[DecodedImage]) -> DecodedImage:
    """Stack decode tables along a new leading axis -> [G, CODE_WORDS]."""
    return DecodedImage(*(torch.stack(xs) for xs in zip(*imgs)))


class FleetImages(NamedTuple):
    """Fleet-side decode tables: the seven small fields of ``DecodedImage``
    packed into one int64 word per instruction, so a fetch is two gathers
    (packed + imm) instead of eight.  Field layout (low to high):
    op:6  rd:5  rn:5  rm:5  sh:6  cond:4  sf:1."""

    packed: torch.Tensor  # int64[G, CODE_WORDS]
    imm: torch.Tensor     # int64[G, CODE_WORDS]


def pack_images(imgs) -> FleetImages:
    """DecodedImage stack [G, CODE_WORDS] (or list of scalar images) ->
    :class:`FleetImages`."""
    if isinstance(imgs, FleetImages):
        return imgs
    if not isinstance(imgs, DecodedImage):
        imgs = stack_images(list(imgs))
    f = [x.to(I64) for x in
         (imgs.op, imgs.rd, imgs.rn, imgs.rm, imgs.sh, imgs.cond, imgs.sf)]
    packed = (f[0] | (f[1] << 6) | (f[2] << 11) | (f[3] << 16)
              | (f[4] << 22) | (f[5] << 28) | (f[6] << 32))
    return FleetImages(packed=packed, imm=imgs.imm.to(I64))


def stack_states(states: Sequence[MachineState]) -> MachineState:
    """Stack machine states along a new leading lane axis -> [B, ...]."""
    return MachineState(*(torch.stack(xs) for xs in zip(*states)))


def unstack_state(states: MachineState, lane: int) -> MachineState:
    """Extract one lane of a batched state (views into the fleet's leaves)."""
    return MachineState(*(x[lane] for x in states))


def states_to(states: MachineState, device) -> MachineState:
    return MachineState(*(x.to(device) for x in states))


def images_to(imgs: FleetImages, device) -> FleetImages:
    return FleetImages(*(x.to(device) for x in imgs))


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> opspec.SpecTables:
    return opspec.spec_tables(device)


def tables_for(device) -> opspec.SpecTables:
    """The spec columns on ``device`` (built once per device)."""
    return _tables(torch.device(device))


# ---------------------------------------------------------------------------
# the batched step
# ---------------------------------------------------------------------------

def _mem_ok_v(addr):
    return (addr >= L.DATA_BASE) & (addr < L.MEM_LIMIT) & ((addr & 7) == 0)


def _widx_v(addr):
    # arithmetic shift: a negative offset clips to word 0, as in JAX
    return ((addr - L.DATA_BASE) >> 3).clamp(0, L.MEM_WORDS - 1)


def _select(pairs, default):
    """``jnp.select``: the value of the FIRST true condition per lane.  A
    ``torch.where`` chain reaches that by applying the pairs in reverse."""
    out = default
    for cond, val in reversed(pairs):
        out = torch.where(cond, val, out)
    return out


def _fetch(img: FleetImages, ids: torch.Tensor, pc0: torch.Tensor):
    """Fetch + decode for every lane: two gathers (packed fields + imm),
    then bit-unpack.  Returns the per-lane field tuple ``(op, rd, rn, rm,
    sh, cond, sf, imm)`` that :func:`exec_lanes` consumes."""
    ok_fetch = (pc0 >= 0) & (pc0 < L.CODE_LIMIT) & ((pc0 & 3) == 0)
    idx = (pc0 >> 2).clamp(0, L.CODE_WORDS - 1)
    g = ids.long()
    w = img.packed[g, idx]
    imm = img.imm[g, idx]
    op = torch.where(ok_fetch, (w & 63).to(I32),
                     torch.full_like(w, int(Op.NULLPAGE), dtype=I32))
    rd = ((w >> 6) & 31).to(I32)
    rn = ((w >> 11) & 31).to(I32)
    rm = ((w >> 16) & 31).to(I32)
    sh = ((w >> 22) & 63).to(I32)
    cond = ((w >> 28) & 15).to(I32)
    sf = ((w >> 32) & 1).to(I32)
    return op, rd, rn, rm, sh, cond, sf, imm


def exec_lanes(fields, s: MachineState) -> MachineState:
    """Execute one decoded instruction per live lane, generated from the
    op-spec table — a line-by-line translation of the JAX package's
    ``fleet.exec_lanes`` for untraced lanes with emulation off.

    ``s.mem`` is updated in place and shared with the returned state;
    every other leaf the step changes is a fresh tensor.
    """
    tbl = tables_for(s.pc.device)
    op, rd, rn, rm, sh, cond, sf, imm = fields
    B = s.pc.shape[0]
    dev = s.pc.device
    lanes = torch.arange(B, device=dev)
    regs0, sp0, pc0, nzcv0, mem = s.regs, s.sp, s.pc, s.nzcv, s.mem

    act = _alive(s)
    sh64 = sh.to(I64)
    # JAX gathers clamp an out-of-range index; decoded ops are < N_OPS
    opi = op.long().clamp(0, int(Op.N_OPS) - 1)

    # -- spec-column gathers: the per-lane op classes ------------------------
    aluc = tbl.ALU[opi]
    flagc = tbl.FLAGS[opi]
    memc = tbl.MEM[opi]
    pcc = tbl.PC[opi]

    def c(col, v):
        return (col == v) & act

    m_svc = c(pcc, opspec.P_SVC)
    m_null = tbl.SEGV[opi] & act
    m_hlt = tbl.EXIT[opi] & act
    dlv = c(pcc, opspec.P_TRAP)
    ld_single = c(memc, opspec.M_LOAD)
    st_single = c(memc, opspec.M_STORE)
    ld_pair = c(memc, opspec.M_LOAD_P)
    st_pair = c(memc, opspec.M_STORE_P)
    byte_op = c(memc, opspec.M_LOAD_BYTE) | c(memc, opspec.M_STORE_BYTE)

    # -- register reads (reg 31 is XZR for _rr, SP for _rsp) -----------------
    zero = torch.zeros((B,), dtype=I64, device=dev)
    ra = imm.clamp(0, 31).to(I32)  # madd packs ra into imm
    ridx = torch.stack([rn.clamp(max=30), rm.clamp(max=30),
                        rd.clamp(max=30), ra.clamp(max=30)], dim=1).long()
    rvals = torch.gather(regs0, 1, ridx)  # one gather, [B, 4]
    rn_raw, rm_raw, rd_raw, ra_raw = rvals.unbind(1)
    rn_rr = torch.where(rn == 31, zero, rn_raw)
    rn_rsp = torch.where(rn == 31, sp0, rn_raw)
    rm_rr = torch.where(rm == 31, zero, rm_raw)
    rd_rr = torch.where(rd == 31, zero, rd_raw)
    ra_rr = torch.where(ra == 31, zero, ra_raw)
    x0, x1, x2, x8 = regs0[:, 0], regs0[:, 1], regs0[:, 2], regs0[:, 8]

    # -- memory addressing: <=2 word gathers, <=2 word stores per step -------
    post_index = tbl.ADDR_POST[opi] & act
    addr_a = torch.where(post_index, rn_rsp, rn_rsp + imm)
    eff1 = torch.where(byte_op, addr_a & ~7, addr_a)
    ok1 = torch.where(byte_op,
                      (addr_a >= L.DATA_BASE) & (addr_a < L.MEM_LIMIT),
                      _mem_ok_v(eff1))
    addr2 = addr_a + 8
    ok2 = _mem_ok_v(addr2)
    g1, g2 = _widx_v(eff1), _widx_v(addr2)
    # reads come from the pre-store memory
    v1 = mem[lanes, g1]
    v2 = mem[lanes, g2]

    byte_shift = (addr_a & 7) * 8
    byte_val = (v1 >> byte_shift) & 0xFF
    strb_word = ((v1 & ~(torch.full_like(v1, 0xFF) << byte_shift))
                 | ((rd_rr & 0xFF) << byte_shift))

    ld1 = torch.where(ok1, v1, zero)   # ldri/ldrpost/ldp/ldppost first word
    ld2 = torch.where(ok2, v2, zero)   # ldp/ldppost second word

    # -- ALU / mov / load value for the primary register write --------------
    piece = imm << sh64
    movk_v = (rd_rr & ~(torch.full_like(imm, 0xFFFF) << sh64)) | piece
    mov_v = _select([(c(aluc, opspec.A_MOVZ), piece),
                     (c(aluc, opspec.A_MOVN), ~piece),
                     (c(aluc, opspec.A_MOVK), movk_v)], zero)
    mov_v = torch.where(sf == 1, mov_v, mov_v & 0xFFFFFFFF)

    slotA_val = _select(
        [(c(aluc, opspec.A_MOVZ) | c(aluc, opspec.A_MOVN)
          | c(aluc, opspec.A_MOVK), mov_v),
         (c(aluc, opspec.A_ADRP), (pc0 & ~0xFFF) + imm),
         (c(aluc, opspec.A_ADR), pc0 + imm),
         (c(aluc, opspec.A_ADD_I), rn_rsp + imm),
         (c(aluc, opspec.A_SUB_I), rn_rsp - imm),
         (c(aluc, opspec.A_ADD_R), rn_rr + rm_rr),
         (c(aluc, opspec.A_SUB_R), rn_rr - rm_rr),
         (c(aluc, opspec.A_ORR), rn_rr | rm_rr),
         (c(aluc, opspec.A_AND), rn_rr & rm_rr),
         (c(aluc, opspec.A_EOR), rn_rr ^ rm_rr),
         (c(aluc, opspec.A_MADD), rn_rr * rm_rr + ra_rr),
         (c(aluc, opspec.A_LSL), rn_rr << sh64),
         (c(aluc, opspec.A_LOAD), ld1),
         (c(aluc, opspec.A_LOAD_B), byte_val),
         (c(aluc, opspec.A_LINK), pc0 + 4)],
        zero)
    slotA_en = (aluc != opspec.A_NONE) & act
    slotA_idx = torch.where(tbl.WB_LR[opi], torch.full_like(rd, 30), rd)
    slotA_sp = tbl.WB_SP[opi] & act  # _wsp ops: rd == 31 targets SP

    # -- flags ---------------------------------------------------------------
    f_imm = flagc == opspec.F_SUBS_I
    subs = (flagc != opspec.F_NONE) & act
    fa = torch.where(f_imm, rn_rsp, rn_rr)
    fb = torch.where(f_imm, imm, rm_rr)
    res = fa - fb
    flag_n = (res < 0).to(I64) * 8
    flag_z = (res == 0).to(I64) * 4
    # unsigned compare: flipping the sign bits maps uint64 order onto int64
    # order (torch's uint64 support is incomplete)
    sign = torch.iinfo(I64).min
    flag_c = ((fa ^ sign) >= (fb ^ sign)).to(I64) * 2
    flag_v = (((fa ^ fb) & (fa ^ res)) < 0).to(I64)
    nzcv = torch.where(subs, flag_n + flag_z + flag_c + flag_v, nzcv0)

    # -- syscalls (emulation off: the legacy stub surface) ------------------
    nr = x8
    in_pt = s.ptrace != 0
    svc_exec = m_svc
    false_b = torch.zeros((B,), dtype=torch.bool, device=dev)
    sys_read = sys_write = sys_getpid = sys_exit = sys_sigret = false_b
    sys_const, known = false_b, false_b
    const_val = zero
    for spec in opspec.SYSCALLS:
        hit = svc_exec & (nr == spec.nr)
        if spec.kind == opspec.K_IO_READ:
            sys_read = sys_read | hit
        elif spec.kind == opspec.K_IO_WRITE:
            sys_write = sys_write | hit
        elif spec.kind == opspec.K_GETPID:
            sys_getpid = sys_getpid | hit
        elif spec.kind == opspec.K_EXIT:
            sys_exit = sys_exit | hit
        elif spec.kind == opspec.K_SIGRETURN:
            sys_sigret = sys_sigret | hit
        elif spec.kind in (opspec.K_CONST, opspec.K_OPENAT, opspec.K_CLOSE):
            # openat/close keep their historical constant stubs (3, 0)
            sys_const = sys_const | hit
            const_val = torch.where(hit, torch.full_like(zero, spec.const),
                                    const_val)
        else:
            continue  # the other emulated kinds fall through to -ENOSYS
        known = known | hit
    sys_enosys = svc_exec & ~known

    io_buf, io_n = x1, x2
    io_k = (io_n >> 3).clamp(0, _MAX_IO_WORDS)
    io_ok = (_mem_ok_v(io_buf) & (io_buf + io_n <= L.MEM_LIMIT)
             & (io_n >= 0) & ((io_n & 7) == 0))
    io_start = _widx_v(io_buf)
    io_do = (sys_read | sys_write) & io_ok

    virt = in_pt & (s.virt_getpid != 0)
    svc_x0 = _select(
        [(sys_read | sys_write,
          torch.where(io_ok, io_n, torch.full_like(zero, -14))),
         (sys_getpid,
          torch.where(virt, torch.full_like(zero, L.VIRT_PID), s.pid)),
         (sys_const, const_val),
         (sys_enosys, torch.full_like(zero, -38))],
        zero)
    svc_x0_en = svc_exec & ~(sys_exit | sys_sigret)

    # -- signal delivery / sigreturn (static 34-word frame window) -----------
    can_sig = dlv & (s.sig_handler != 0) & (s.in_signal == 0)
    trap_fail = dlv & ~can_sig
    signo = tbl.SIGNO[opi]
    frame_out = torch.cat(
        [regs0, sp0[:, None], pc0[:, None], nzcv0[:, None]], dim=1)

    # -- memory writes -------------------------------------------------------
    # JAX parks disabled stores at out-of-range indices and drops them;
    # torch index_put_ has no drop mode, so only enabled entries are
    # indexed.  A pair store whose second word faults keeps its first.
    st_byte = c(memc, opspec.M_STORE_BYTE)
    st1_en = (st_single | st_pair | st_byte) & ok1
    st2_en = st_pair & ok2
    st1_val = torch.where(byte_op, strb_word, rd_rr)
    mem[lanes[st1_en], g1[st1_en]] = st1_val[st1_en]
    mem[lanes[st2_en], g2[st2_en]] = rm_rr[st2_en]

    sig_win = slice(_SIGFRAME_IDX, _SIGFRAME_IDX + SIGFRAME_WORDS)
    if bool(can_sig.any()):
        mem[can_sig, sig_win] = frame_out[can_sig]

    # Syscall I/O fill/sum over words [io_start, io_start + io_k) of each
    # io lane — the net effect of the JAX engine's clamped 512-word windows
    # (io_ok keeps the span inside the lane).  The write sum reads memory
    # after this step's stores and sigframe push.
    io_sum = zero
    if bool(io_do.any()):
        io_l = io_do.nonzero().squeeze(1)
        j = torch.arange(_MAX_IO_WORDS, dtype=I64, device=dev)
        within = j[None, :] < io_k[io_l, None]
        pos = io_start[io_l, None] + j[None, :]
        cur = mem[io_l[:, None], pos.clamp(max=L.MEM_WORDS - 1)]
        rd_l = sys_read[io_l, None]
        io_sum = zero.clone()
        io_sum[io_l] = torch.where(within & ~rd_l, cur,
                                   torch.zeros_like(cur)).sum(1)
        fill = s.in_off[io_l, None] + j[None, :] * 8
        wr = within & rd_l
        rows = io_l[:, None].expand_as(pos)
        mem[rows[wr], pos[wr]] = fill[wr]

    # Sigreturn frame read from the FINAL memory (a sigreturn lane writes
    # nothing in its own step, so this is its pre-step frame).
    frame_in = torch.zeros((B, SIGFRAME_WORDS), dtype=I64, device=dev)
    if bool(sys_sigret.any()):
        frame_in[sys_sigret] = mem[sys_sigret, sig_win]

    # -- register writes (slot order mirrors the scalar handler order) ------
    col = torch.arange(31, device=dev)[None, :]

    def apply_slot(regs, en, idxv, val, sp, sp_ok):
        hit = en[:, None] & (idxv[:, None] == col)  # idx 31 never matches
        regs = torch.where(hit, val[:, None], regs)
        sp = torch.where(en & sp_ok & (idxv == 31), val, sp)
        return regs, sp

    regs, sp = apply_slot(regs0, slotA_en, slotA_idx, slotA_val, sp0,
                          slotA_sp)
    regs, sp = apply_slot(regs, ld_pair, rm, ld2, sp, false_b)
    wb = tbl.WB_BASE[opi] & act
    regs, sp = apply_slot(regs, wb, rn, rn_rsp + imm, sp, ~false_b)

    regs[:, 0] = torch.where(svc_x0_en, svc_x0, regs[:, 0])
    regs[:, 0] = torch.where(can_sig, signo, regs[:, 0])
    regs[:, 1] = torch.where(can_sig, torch.full_like(zero, L.SIGFRAME),
                             regs[:, 1])
    sp = torch.where(can_sig, torch.full_like(zero, L.SIGSTACK_TOP), sp)

    regs = torch.where(sys_sigret[:, None], frame_in[:, :31], regs)
    sp = torch.where(sys_sigret, frame_in[:, 31], sp)
    nzcv = torch.where(sys_sigret, frame_in[:, 33], nzcv)

    # -- program counter -----------------------------------------------------
    br_target = pc0 + imm
    pc4 = pc0 + 4
    taken_bc = opspec.cond_holds(nzcv0, cond, tbl.COND_MASK)  # OLD flags
    svc_pc = torch.where(sys_exit, pc0,
                         torch.where(sys_sigret, frame_in[:, 32] + 4, pc4))
    pc_new = _select(
        [(c(pcc, opspec.P_REL), br_target),
         (c(pcc, opspec.P_IND), rn_rr),
         (c(pcc, opspec.P_CBZ), torch.where(rd_rr == 0, br_target, pc4)),
         (c(pcc, opspec.P_CBNZ), torch.where(rd_rr != 0, br_target, pc4)),
         (c(pcc, opspec.P_BCOND), torch.where(taken_bc, br_target, pc4)),
         (c(pcc, opspec.P_STAY), pc0),
         (dlv, torch.where(can_sig, s.sig_handler, pc0)),
         (m_svc, svc_pc)],
        pc4)
    pc = torch.where(act, pc_new, pc0)

    # -- faults / halts ------------------------------------------------------
    bad_single = (ld_single | st_single) & ~ok1
    bad_pair = (ld_pair | st_pair) & ~(ok1 & ok2)
    bad_byte = byte_op & ~ok1
    mem_bad = bad_single | bad_pair | bad_byte

    def code(v):
        return torch.full_like(zero, v)

    halted = s.halted
    halted = torch.where(m_null, code(HALT_SEGV), halted)
    halted = torch.where(mem_bad, code(HALT_BADMEM), halted)
    halted = torch.where(m_hlt | sys_exit, code(HALT_EXIT), halted)
    halted = torch.where(trap_fail, code(HALT_TRAP), halted)
    exit_code = torch.where(m_hlt | sys_exit, x0, s.exit_code)
    fault_pc = torch.where(m_null | mem_bad | trap_fail, pc0, s.fault_pc)

    # -- bookkeeping ---------------------------------------------------------
    cycles = s.cycles + torch.where(act, tbl.COST_TABLE[opi], zero)
    cycles = cycles + torch.where(m_svc, code(cm.KERNEL_CROSS), zero)
    cycles = cycles + torch.where(m_svc & in_pt, code(2 * cm.PTRACE_STOP),
                                  zero)
    # torch // floors like JAX's (io_n may be negative)
    cycles = cycles + torch.where(sys_read | sys_write,
                                  io_n // cm.IO_BYTES_PER_CYCLE, zero)
    cycles = cycles + torch.where(can_sig, code(cm.SIGNAL_DELIVERY), zero)
    icount = s.icount + act.to(I64)
    hook_count = s.hook_count + (m_svc & in_pt).to(I64)
    in_off = s.in_off + torch.where(sys_read & io_ok, io_n, zero)
    out_count = s.out_count + torch.where(sys_write & io_ok, io_n, zero)
    out_sum = s.out_sum + torch.where(sys_write & io_ok, io_sum, zero)
    in_signal = torch.where(can_sig, code(1),
                            torch.where(sys_sigret, zero, s.in_signal))
    enosys_count = s.enosys_count + sys_enosys.to(I64)

    return s._replace(
        regs=regs, sp=sp, pc=pc, nzcv=nzcv, mem=mem, cycles=cycles,
        icount=icount, halted=halted, exit_code=exit_code, fault_pc=fault_pc,
        in_signal=in_signal, hook_count=hook_count, in_off=in_off,
        out_count=out_count, out_sum=out_sum,
        enosys_count=enosys_count)


def _step_core(img: FleetImages, ids: torch.Tensor,
               s: MachineState) -> MachineState:
    """One masked step for every lane (the identity on halted and
    out-of-fuel lanes): fetch/decode, then the spec-generated executor
    body.  Unlike the JAX package's, it takes and returns no trace."""
    return exec_lanes(_fetch(img, ids, s.pc), s)


# ---------------------------------------------------------------------------
# the fleet drivers
# ---------------------------------------------------------------------------

def _alive(s: MachineState):
    return (s.halted == RUNNING) & (s.icount < s.fuel)


def _patch_fuel(s: MachineState) -> MachineState:
    return s._replace(halted=torch.where(
        (s.halted == RUNNING) & (s.icount >= s.fuel),
        torch.full_like(s.halted, HALT_FUEL), s.halted))


# Both JAX engine names dispatch to the one chunk dispatcher here (the
# megastep wrapper): the JAX package guarantees xla == pallas bit for bit,
# so configs that name either keep their meaning.
ENGINES = ("xla", "pallas")


def _check_engine(engine: str, *, shard: bool = False) -> str:
    if engine not in ENGINES:
        raise ValueError(
            f"unknown fleet engine {engine!r}: expected one of {ENGINES}")
    if shard:
        raise NotImplementedError(
            "shard=True is not ported yet (lane-sharding slice)")
    return engine


def _fleet_inputs(imgs, states, img_ids, device):
    dev = resolve_device(device)
    imgs = images_to(pack_images(imgs), dev)
    if not isinstance(states, MachineState):  # list/tuple of scalar states
        states = stack_states(states)
    states = states_to(states, dev)
    n_lanes = int(states.pc.shape[0])
    if img_ids is None:
        if int(imgs.packed.shape[0]) != n_lanes:
            raise ValueError("img_ids required when #images != #lanes")
        img_ids = torch.arange(n_lanes)
    elif not isinstance(img_ids, torch.Tensor):
        img_ids = torch.as_tensor(np.asarray(img_ids))
    return imgs, img_ids.to(dev, I32), states


def run_fleet(imgs, states, img_ids=None, *, chunk: int = DEFAULT_CHUNK,
              shard: bool = False, trace=None, engine: str = "xla",
              device=None) -> MachineState:
    """Run every lane to halt (or out of fuel, patched to ``HALT_FUEL``).

    ``imgs``: decode tables (``FleetImages``, a stacked ``DecodedImage`` or
    a list of scalar images); ``states``: a batched ``MachineState`` or a
    list of scalar states; ``img_ids`` maps lanes to image rows (default
    the identity).  Every chunk of ``chunk`` steps is one call of the
    megastep wrapper — the CUDA kernel on the card, its plain version on
    the CPU.  Results are invariant to ``chunk``.

    ``device=None`` means the card; inputs are moved there and the carry
    is updated in place.  ``trace`` and ``shard`` are later slices and
    raise."""
    _check_engine(engine, shard=shard)
    if trace is not None:
        raise NotImplementedError(_TRACE_HINT)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    from ..kernels.megastep import ops as mops  # lazy: kernel layer
    imgs, img_ids, states = _fleet_inputs(imgs, states, img_ids, device)
    return mops.run(imgs, img_ids, states, chunk=int(chunk))


def run_fleet_span(imgs, states, img_ids, *, steps: int,
                   chunk: int = DEFAULT_CHUNK, trace=None,
                   engine: str = "xla", device=None) -> MachineState:
    """One bounded generation: up to ``steps`` masked steps (rounded up to
    a whole number of chunks), early exit when every lane halts.  Lanes
    out of fuel stay ``RUNNING`` (no ``HALT_FUEL`` patch)."""
    _check_engine(engine)
    if trace is not None:
        raise NotImplementedError(_TRACE_HINT)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    from ..kernels.megastep import ops as mops  # lazy: kernel layer
    imgs, img_ids, states = _fleet_inputs(imgs, states, img_ids, device)
    return mops.span(imgs, img_ids, states, chunk=int(chunk),
                     span=-(-steps // chunk))


# ---------------------------------------------------------------------------
# bulk host-side readback
# ---------------------------------------------------------------------------

def fleet_counters(states: MachineState) -> np.ndarray:
    """Per-lane hook-invocation totals (COUNTER word + ptrace-side
    hook_count), one device transfer per array."""
    counter = states.mem[:, _COUNTER_IDX].cpu().numpy()
    return counter + states.hook_count.cpu().numpy()


def fleet_summary(states: MachineState) -> List[dict]:
    """Host-side per-lane result rows, one device->host transfer per
    field."""
    fields = {k: getattr(states, k).cpu().numpy() for k in
              ("halted", "exit_code", "cycles", "icount", "out_count",
               "out_sum", "enosys_count", "emul_served")}
    hooks = fleet_counters(states)
    n = fields["halted"].shape[0]
    return [dict({k: int(v[i]) for k, v in fields.items()},
                 hooks=int(hooks[i])) for i in range(n)]
