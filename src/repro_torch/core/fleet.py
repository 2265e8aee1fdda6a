"""Batched fleet execution engine: N simulated processes (PyTorch port).

The step is natively batched over lanes (:func:`exec_lanes`): one fetch
gather per decode table, register reads as one ``gather``, all register,
ALU and branch semantics as masked selects, and memory traffic as at most
two word gathers and two word stores per step, plus the 34-word sigframe
window and the syscall I/O fill/sum, which only lanes that need them pay
for.  This lane-vectorised eager step is the plain PyTorch version of the
CUDA megastep kernel (:mod:`repro_torch.kernels.megastep`); on the card
every chunk of steps runs in that kernel instead.

Ported: the whole executor — lanes with the guest-kernel emulation on
(the ``HookConfig`` default) or off, untraced or with the syscall trace
ring and seccomp-style policy carry (:class:`TraceState`).  Lane
sharding, compaction and streaming are later slices; their entry points
raise ``NotImplementedError``.

Carry semantics: the big planes (``mem``, ``k_ino_data``, the trace ring
and histogram) are updated in place (never copied per step); the drivers
update every leaf of the carry they are given in place, as the JAX
package's entry points donate theirs.  Per lane, results are
bit-identical to the JAX package's fleet engine.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import costmodel as cm
from . import layout as L
from . import opspec
from .isa import Op
from .machine import (HALT_BADMEM, HALT_EXIT, HALT_FUEL, HALT_KILL,
                      HALT_SEGV, HALT_TRAP, RUNNING, SIGFRAME_WORDS,
                      DecodedImage, MachineState, _SIGFRAME_IDX,
                      resolve_device)
from ..emul import engine as emul_engine

I64 = torch.int64
I32 = torch.int32

_MAX_IO_WORDS = 4096
_COUNTER_IDX = (L.COUNTER - L.DATA_BASE) // 8

DEFAULT_CHUNK = 8


# ---------------------------------------------------------------------------
# syscall tracing + policy carry (the device side of repro_torch.trace)
# ---------------------------------------------------------------------------

# Record layout: one ring row per executed svc.
REC_WORDS = 8
REC_STEP, REC_PC, REC_NR, REC_X0, REC_X1, REC_X2, REC_RET, REC_VERDICT = \
    range(REC_WORDS)

TRACE_SYS = opspec.TRACE_SYS
SLOT_UNKNOWN = opspec.SLOT_UNKNOWN
N_POLICY_SLOTS = opspec.N_POLICY_SLOTS
POL_ALLOW, POL_DENY = opspec.POL_ALLOW, opspec.POL_DENY
POL_EMULATE, POL_KILL = opspec.POL_EMULATE, opspec.POL_KILL
VERDICT_UNKNOWN = opspec.VERDICT_UNKNOWN
N_VERDICTS = opspec.N_VERDICTS

DEFAULT_TRACE_CAP = 64


class TraceState(NamedTuple):
    """Per-lane syscall trace ring + policy tables (the JAX package's
    ``TraceState``, same 10 leaves in the same order).

    Lane ``b`` appends into half ``hot[b]`` of its double buffer at row
    ``(count[b] - base[b]) % CAP``; a never-flipped carry (``hot == base
    == 0``) is the classic single ring, and ``count`` keeps the lifetime
    total, so the host decoder knows how many records were dropped.
    ``hist`` counts policy-slot x verdict pairs; the ``*_count`` leaves
    count verdicts."""

    buf: torch.Tensor         # int64[B, 2, CAP, REC_WORDS]: hot/cold halves
    count: torch.Tensor       # int64[B]: records ever produced per lane
    hot: torch.Tensor         # int64[B]: the half currently appended to
    base: torch.Tensor        # int64[B]: lifetime count at the last flip
    hist: torch.Tensor        # int64[B, N_POLICY_SLOTS, N_VERDICTS]
    pol_action: torch.Tensor  # int32[B, N_POLICY_SLOTS]
    pol_arg: torch.Tensor     # int64[B, N_POLICY_SLOTS]: errno / constant
    deny_count: torch.Tensor  # int64[B]: DENY verdicts per lane
    emul_count: torch.Tensor  # int64[B]: EMULATE verdicts per lane
    kill_count: torch.Tensor  # int64[B]: KILL verdicts per lane (0 or 1)


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


def stack_traces(traces: Sequence[TraceState]) -> TraceState:
    """Stack per-lane trace carries along a new leading lane axis."""
    return TraceState(*(torch.stack(xs) for xs in zip(*traces)))


def unstack_trace(trace: TraceState, lane: int) -> TraceState:
    """Extract one lane of a trace carry (views into the fleet's leaves)."""
    return TraceState(*(x[lane] for x in trace))


def traces_to(trace: TraceState, device) -> TraceState:
    return TraceState(*(x.to(device) for x in trace))


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


_select = emul_engine.select  # jnp.select: the FIRST true condition wins


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


def exec_lanes(fields, s: MachineState, tr: Optional[TraceState] = None):
    """Execute one decoded instruction per live lane, generated from the
    op-spec table — a line-by-line translation of the JAX package's
    ``fleet.exec_lanes``: the ALU, memory, branch and signal semantics,
    the syscall rows, the guest-kernel service (:mod:`repro_torch.emul`)
    on lanes with ``k_enabled != 0`` and, with a trace carry ``tr``, the
    policy gate, the record ring, the histogram and the verdict counters.

    Returns ``(state, trace)`` (``trace`` is None when ``tr`` is).  The
    big planes — ``s.mem``, ``s.k_ino_data``, ``tr.buf`` and ``tr.hist`` —
    are updated in place and shared with the result; every other leaf the
    step changes is a fresh tensor.
    """
    traced = tr is not None
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

    def full(v):
        return torch.full_like(zero, v)

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

    # -- syscalls ------------------------------------------------------------
    nr = x8
    in_pt = s.ptrace != 0
    en = s.k_enabled != 0  # per-lane guest-kernel gate (0 = legacy stubs)
    false_b = torch.zeros((B,), dtype=torch.bool, device=dev)
    if traced:
        # Seccomp-style gate: resolve nr to a per-lane policy action; only
        # ALLOW lanes (and EMULATE lanes routed into the guest kernel)
        # reach the sys_* branches.  A later row wins, as in the JAX chain.
        action = tr.pol_action[:, SLOT_UNKNOWN]
        pol_arg = tr.pol_arg[:, SLOT_UNKNOWN]
        pol_slot = full(SLOT_UNKNOWN)
        emulable = false_b
        for i, spec in enumerate(opspec.SYSCALLS):
            hit = nr == spec.nr
            action = torch.where(hit, tr.pol_action[:, i], action)
            pol_arg = torch.where(hit, tr.pol_arg[:, i], pol_arg)
            pol_slot = torch.where(hit, full(i), pol_slot)
            if spec.emul:
                emulable = emulable | hit
        pol_deny = m_svc & (action == POL_DENY)
        pol_emul = m_svc & (action == POL_EMULATE)
        pol_kill = m_svc & (action == POL_KILL)
        # EMULATE on a guest-kernel-backed nr routes into the emulation
        # service; on anything else it returns the policy constant.
        emul_route = pol_emul & emulable & en
        pol_emul_const = pol_emul & ~(emulable & en)
        svc_exec = m_svc & ((action == POL_ALLOW) | emul_route)
    else:
        svc_exec = m_svc

    # Per-kind masks from the spec's syscall rows.  Guest-kernel kinds
    # split on ``en``: enabled lanes take the fd-table service, disabled
    # lanes keep the legacy semantics (openat/close return their constant
    # stubs, the other emulated kinds fall through to -ENOSYS).
    sys_read = sys_write = sys_getpid = sys_exit = sys_sigret = false_b
    sys_const, known = false_b, false_b
    const_val = zero
    emul_only = {k: false_b for k in (
        opspec.K_LSEEK, opspec.K_DUP, opspec.K_FSTAT, opspec.K_PIPE2,
        opspec.K_GETRANDOM, opspec.K_IOCTL)}
    sys_open = sys_close = false_b
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
        elif spec.kind in (opspec.K_OPENAT, opspec.K_CLOSE):
            if spec.kind == opspec.K_OPENAT:
                sys_open = sys_open | (hit & en)
            else:
                sys_close = sys_close | (hit & en)
            sys_const = sys_const | (hit & ~en)
            const_val = torch.where(hit & ~en, full(spec.const), const_val)
        elif spec.kind in emul_only:
            emul_only[spec.kind] = emul_only[spec.kind] | (hit & en)
            known = known | (hit & en)  # disabled lanes: -ENOSYS
            continue
        else:  # K_CONST
            sys_const = sys_const | hit
            const_val = torch.where(hit, full(spec.const), const_val)
        known = known | hit
    sys_lseek = emul_only[opspec.K_LSEEK]
    sys_dup = emul_only[opspec.K_DUP]
    sys_fstat = emul_only[opspec.K_FSTAT]
    sys_pipe = emul_only[opspec.K_PIPE2]
    sys_rand = emul_only[opspec.K_GETRANDOM]
    sys_ioctl = emul_only[opspec.K_IOCTL]
    sys_enosys = svc_exec & ~known

    io_buf, io_n = x1, x2
    io_k = (io_n >> 3).clamp(0, _MAX_IO_WORDS)
    io_ok = (_mem_ok_v(io_buf) & (io_buf + io_n <= L.MEM_LIMIT)
             & (io_n >= 0) & ((io_n & 7) == 0))
    io_start = _widx_v(io_buf)

    # First path word for openat lanes, read from the pre-store memory.
    path_w = torch.where(sys_open, mem[lanes, _widx_v(x1)], zero)

    # -- guest-kernel service (control plane) -------------------------------
    # Skipped on steps where no lane executes an emulated operation and no
    # enabled lane reads or writes: neutral() is bit-identical there (the
    # JAX package's batch-uniform cond).
    emul_op = (sys_open | sys_close | sys_lseek | sys_dup | sys_fstat
               | sys_pipe | sys_rand | sys_ioctl)
    if bool((emul_op | ((sys_read | sys_write) & en)).any()):
        eff = emul_engine.service(
            s, en=en, x0=x0, x1=x1, x2=x2, path_w=path_w,
            io_ok=io_ok, io_n=io_n,
            sys_open=sys_open, sys_close=sys_close, sys_lseek=sys_lseek,
            sys_dup=sys_dup, sys_fstat=sys_fstat, sys_pipe=sys_pipe,
            sys_rand=sys_rand, sys_ioctl=sys_ioctl,
            sys_read=sys_read, sys_write=sys_write)
    else:
        eff = emul_engine.neutral(s, sys_read, sys_write)
    io_do = (eff.rd_stream | eff.wr_stream) & io_ok

    virt = in_pt & (s.virt_getpid != 0)
    svc_x0 = _select(
        [(eff.rd_stream | eff.wr_stream,
          torch.where(io_ok, io_n, full(-14))),
         (eff.is_ret, eff.ret),
         (sys_getpid, torch.where(virt, full(L.VIRT_PID), s.pid)),
         (sys_const, const_val),
         (sys_enosys, full(-38))],
        zero)
    svc_x0_en = svc_exec & ~(sys_exit | sys_sigret)
    if traced:
        # DENY returns -errno, non-routable EMULATE the policy constant;
        # both skip the kernel branch and fall through to pc+4.
        svc_x0 = _select([(pol_deny, -pol_arg), (pol_emul_const, pol_arg)],
                         svc_x0)
        svc_x0_en = svc_x0_en | pol_deny | pol_emul_const

    # -- signal delivery / sigreturn (static 34-word frame window) -----------
    can_sig = dlv & (s.sig_handler != 0) & (s.in_signal == 0)
    trap_fail = dlv & ~can_sig
    signo = tbl.SIGNO[opi]
    frame_out = torch.cat(
        [regs0, sp0[:, None], pc0[:, None], nzcv0[:, None]], dim=1)

    # -- memory writes, in the JAX order --------------------------------------
    # stores, sigframe push, emul result words, stream I/O, data mover.
    # JAX parks disabled writes at out-of-range indices and drops them;
    # torch index_put_ has no drop mode, so only live entries are indexed.
    # A pair store whose second word faults keeps its first.
    st_byte = c(memc, opspec.M_STORE_BYTE)
    st1_en = (st_single | st_pair | st_byte) & ok1
    st2_en = st_pair & ok2
    st1_val = torch.where(byte_op, strb_word, rd_rr)
    mem[lanes[st1_en], g1[st1_en]] = st1_val[st1_en]
    mem[lanes[st2_en], g2[st2_en]] = rm_rr[st2_en]

    sig_win = slice(_SIGFRAME_IDX, _SIGFRAME_IDX + SIGFRAME_WORDS)
    if bool(can_sig.any()):
        mem[can_sig, sig_win] = frame_out[can_sig]

    mem_flat = mem.view(-1)
    live = eff.scat_idx < L.MEM_WORDS * B  # parked entries sit past the end
    mem_flat[eff.scat_idx[live]] = eff.scat_val[live]

    # Stream I/O fill/sum over words [io_start, io_start + io_k) of each
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

    # Guest-kernel bulk data (file/pipe/proc reads and writes, getrandom
    # fills); /proc rows come from the pre-step counters.
    k_ino_data = eff.kern.ino_data
    if bool(eff.fio_do.any()):
        emul_engine.run_data_loop(mem_flat, k_ino_data.view(-1),
                                  emul_engine.proc_rows(s).reshape(-1), eff)

    # Sigreturn frame read from the FINAL memory (a sigreturn lane writes
    # nothing in its own step, so this is its pre-step frame).
    frame_in = torch.zeros((B, SIGFRAME_WORDS), dtype=I64, device=dev)
    if bool(sys_sigret.any()):
        frame_in[sys_sigret] = mem[sys_sigret, sig_win]

    # -- register writes (slot order mirrors the scalar handler order) ------
    col = torch.arange(31, device=dev)[None, :]

    def apply_slot(regs, en_, idxv, val, sp, sp_ok):
        hit = en_[:, None] & (idxv[:, None] == col)  # idx 31 never matches
        regs = torch.where(hit, val[:, None], regs)
        sp = torch.where(en_ & sp_ok & (idxv == 31), val, sp)
        return regs, sp

    regs, sp = apply_slot(regs0, slotA_en, slotA_idx, slotA_val, sp0,
                          slotA_sp)
    regs, sp = apply_slot(regs, ld_pair, rm, ld2, sp, false_b)
    wb = tbl.WB_BASE[opi] & act
    regs, sp = apply_slot(regs, wb, rn, rn_rsp + imm, sp, ~false_b)

    regs[:, 0] = torch.where(svc_x0_en, svc_x0, regs[:, 0])
    regs[:, 0] = torch.where(can_sig, signo, regs[:, 0])
    regs[:, 1] = torch.where(can_sig, full(L.SIGFRAME), regs[:, 1])
    sp = torch.where(can_sig, full(L.SIGSTACK_TOP), sp)

    regs = torch.where(sys_sigret[:, None], frame_in[:, :31], regs)
    sp = torch.where(sys_sigret, frame_in[:, 31], sp)
    nzcv = torch.where(sys_sigret, frame_in[:, 33], nzcv)

    # -- program counter -----------------------------------------------------
    br_target = pc0 + imm
    pc4 = pc0 + 4
    taken_bc = opspec.cond_holds(nzcv0, cond, tbl.COND_MASK)  # OLD flags
    svc_pc = torch.where(sys_exit, pc0,
                         torch.where(sys_sigret, frame_in[:, 32] + 4, pc4))
    if traced:
        svc_pc = torch.where(pol_kill, pc0, svc_pc)  # KILL parks like exit
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

    halted = s.halted
    halted = torch.where(m_null, full(HALT_SEGV), halted)
    halted = torch.where(mem_bad, full(HALT_BADMEM), halted)
    halted = torch.where(m_hlt | sys_exit, full(HALT_EXIT), halted)
    halted = torch.where(trap_fail, full(HALT_TRAP), halted)
    exit_code = torch.where(m_hlt | sys_exit, x0, s.exit_code)
    fault_pc = torch.where(m_null | mem_bad | trap_fail, pc0, s.fault_pc)
    if traced:
        halted = torch.where(pol_kill, full(HALT_KILL), halted)
        fault_pc = torch.where(pol_kill, pc0, fault_pc)

    # -- bookkeeping ---------------------------------------------------------
    cycles = s.cycles + torch.where(act, tbl.COST_TABLE[opi], zero)
    cycles = cycles + torch.where(m_svc, full(cm.KERNEL_CROSS), zero)
    cycles = cycles + torch.where(m_svc & in_pt, full(2 * cm.PTRACE_STOP),
                                  zero)
    # torch // floors like JAX's (io_n may be negative)
    cycles = cycles + torch.where(sys_read | sys_write,
                                  io_n // cm.IO_BYTES_PER_CYCLE, zero)
    cycles = cycles + torch.where(can_sig, full(cm.SIGNAL_DELIVERY), zero)
    icount = s.icount + act.to(I64)
    hook_count = s.hook_count + (m_svc & in_pt).to(I64)
    # stream effects follow the service routing: on legacy lanes
    # rd_stream/wr_stream are the raw masks
    in_off = s.in_off + torch.where(eff.rd_stream & io_ok, io_n, zero)
    out_count = s.out_count + torch.where(eff.wr_stream & io_ok, io_n, zero)
    out_sum = s.out_sum + torch.where(eff.wr_stream & io_ok, io_sum, zero)
    in_signal = torch.where(can_sig, full(1),
                            torch.where(sys_sigret, zero, s.in_signal))
    enosys_count = s.enosys_count + sys_enosys.to(I64)
    emul_served = s.emul_served + eff.served.to(I64)

    # -- trace record append (traced path only) ------------------------------
    if traced:
        cap = tr.buf.shape[2]
        if bool(m_svc.any()):
            ret = _select(
                [(pol_deny, -pol_arg), (pol_emul_const, pol_arg),
                 (pol_kill, zero), (sys_exit, x0),
                 (sys_sigret, frame_in[:, 0])],
                svc_x0)  # routed EMULATE lanes: svc_x0 is the emulated ret
            verdict = _select(
                [(pol_deny, full(POL_DENY)), (pol_emul, full(POL_EMULATE)),
                 (pol_kill, full(POL_KILL)),
                 (sys_enosys, full(VERDICT_UNKNOWN))],
                zero)  # POL_ALLOW
            # JAX's % floors (count < base on a scrambled carry); so does
            # torch.remainder
            pos = (lanes * (2 * cap) + tr.hot * cap
                   + torch.remainder(tr.count - tr.base, cap))
            rows = torch.stack([s.icount, pc0, nr, x0, x1, x2, ret, verdict],
                               dim=1)
            _scatter_drop(tr.buf.view(B * 2 * cap, REC_WORDS), pos, m_svc,
                          rows)
            hpos = (lanes * (N_POLICY_SLOTS * N_VERDICTS)
                    + pol_slot * N_VERDICTS + verdict)
            hflat = tr.hist.view(-1)
            hflat[hpos[m_svc]] += 1
        tr = tr._replace(
            count=tr.count + m_svc.to(I64),
            deny_count=tr.deny_count + pol_deny.to(I64),
            emul_count=tr.emul_count + pol_emul.to(I64),
            kill_count=tr.kill_count + pol_kill.to(I64))

    kern = eff.kern
    return s._replace(
        regs=regs, sp=sp, pc=pc, nzcv=nzcv, mem=mem, cycles=cycles,
        icount=icount, halted=halted, exit_code=exit_code, fault_pc=fault_pc,
        in_signal=in_signal, hook_count=hook_count, in_off=in_off,
        out_count=out_count, out_sum=out_sum, enosys_count=enosys_count,
        emul_served=emul_served,
        k_rng=kern.rng, k_fd_ofd=kern.fd_ofd, k_ofd_kind=kern.ofd_kind,
        k_ofd_ino=kern.ofd_ino, k_ofd_off=kern.ofd_off,
        k_ofd_flags=kern.ofd_flags, k_ofd_ref=kern.ofd_ref,
        k_ino_kind=kern.ino_kind, k_ino_name=kern.ino_name,
        k_ino_size=kern.ino_size, k_ino_data=k_ino_data), tr


def _scatter_drop(flat: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                  rows: torch.Tensor) -> None:
    """``flat[idx[b]] = rows[b]`` where ``mask[b]``, with JAX's
    ``mode="drop"`` indexing: a negative index counts from the end, and
    one still out of range is dropped."""
    n = flat.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    live = mask & (idx >= 0) & (idx < n)
    flat[idx[live]] = rows[live]


def _step_core(img: FleetImages, ids: torch.Tensor, s: MachineState,
               tr: Optional[TraceState] = None):
    """One masked step for every lane (the identity on halted and
    out-of-fuel lanes): fetch/decode, then the spec-generated executor
    body.  Returns ``(state, trace)``, as the JAX package's does."""
    return exec_lanes(_fetch(img, ids, s.pc), s, tr)


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
              shard: bool = False, trace: Optional[TraceState] = None,
              engine: str = "xla", device=None):
    """Run every lane to halt (or out of fuel, patched to ``HALT_FUEL``).

    ``imgs``: decode tables (``FleetImages``, a stacked ``DecodedImage`` or
    a list of scalar images); ``states``: a batched ``MachineState`` or a
    list of scalar states; ``img_ids`` maps lanes to image rows (default
    the identity).  Every chunk of ``chunk`` steps is one call of the
    megastep wrapper — the CUDA kernel on the card, its plain version on
    the CPU.  Results are invariant to ``chunk``.

    With ``trace`` (a :class:`TraceState`) every executed svc appends a
    ring record and the per-lane policy tables gate the syscall branches;
    returns ``(states, trace)``.  Under all-ALLOW policies the machine
    states equal an untraced run's.

    ``device=None`` means the card; inputs are moved there and the carry
    is updated in place.  ``shard`` is a later slice and raises."""
    _check_engine(engine, shard=shard)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    from ..kernels.megastep import ops as mops  # lazy: kernel layer
    imgs, img_ids, states = _fleet_inputs(imgs, states, img_ids, device)
    if trace is None:
        return mops.run(imgs, img_ids, states, chunk=int(chunk))
    return mops.run(imgs, img_ids, states, traces_to(trace, states.pc.device),
                    chunk=int(chunk))


def run_fleet_span(imgs, states, img_ids, *, steps: int,
                   chunk: int = DEFAULT_CHUNK,
                   trace: Optional[TraceState] = None,
                   engine: str = "xla", device=None):
    """One bounded generation: up to ``steps`` masked steps (rounded up to
    a whole number of chunks), early exit when every lane halts.  Lanes
    out of fuel stay ``RUNNING`` (no ``HALT_FUEL`` patch).  With ``trace``
    returns ``(states, trace)``, as :func:`run_fleet`."""
    _check_engine(engine)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    from ..kernels.megastep import ops as mops  # lazy: kernel layer
    imgs, img_ids, states = _fleet_inputs(imgs, states, img_ids, device)
    if trace is not None:
        trace = traces_to(trace, states.pc.device)
    return mops.span(imgs, img_ids, states, trace, chunk=int(chunk),
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
