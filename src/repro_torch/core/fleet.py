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
ring and seccomp-style policy carry (:class:`TraceState`) — and the
drivers around it: run to halt (:func:`run_fleet`), bounded spans
(:func:`run_fleet_span`), lane admission and restore into a running
fleet (:func:`admit_lanes`, :func:`restore_lanes`, :func:`set_image_row`,
:func:`update_policy_rows`), streamed trace harvest
(:func:`run_fleet_stream`), live-lane compaction
(:func:`run_fleet_compact`) and the durable server's carry digests and
snapshot packing (:func:`carry_digest`, :func:`pack_carry`).  With
``shard=True`` a run splits its lanes over the devices of
:mod:`repro_torch.parallel.sharding`'s mesh, one slice a device, run in
lockstep (one chunk on every slice, then one liveness test over all
lanes) and written back into the carry: the same chunks, the same
leaves.  On one device, or when the devices do not divide the lanes, it
runs whole, as the JAX package does.

Carry semantics: the big planes (``mem``, ``k_ino_data``, the trace ring
and histogram) are updated in place (never copied per step); the drivers
update every leaf of the carry they are given in place, as the JAX
package's entry points donate theirs.  The kernel's arguments hold raw
pointers to the carry's leaves, so every span builds them anew: a carry
changed between spans (admission, restore, a new image row, a flip) is
always the one the next span runs.  Per lane, results are bit-identical
to the JAX package's fleet engine.
"""
from __future__ import annotations

import functools
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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
from ..emul import state as emul_state
from ..parallel import sharding as SH

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


def exec_lanes(fields, s: MachineState, tr: Optional[TraceState] = None,
               act: Optional[torch.Tensor] = None):
    """Execute one decoded instruction per live lane, generated from the
    op-spec table — a line-by-line translation of the JAX package's
    ``fleet.exec_lanes``: the ALU, memory, branch and signal semantics,
    the syscall rows, the guest-kernel service (:mod:`repro_torch.emul`)
    on lanes with ``k_enabled != 0`` and, with a trace carry ``tr``, the
    policy gate, the record ring, the histogram and the verdict counters.
    ``act`` overrides the live-lane mask (the scalar
    :func:`repro_torch.core.machine.step` forces it all-true); the fleet
    drivers leave the default halted/fuel gate.

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

    act = _alive(s) if act is None else act
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
    if engine == "pallas" and shard:
        # the JAX package's rule, kept so that configs mean the same here
        raise ValueError(
            "engine='pallas' does not compose with shard=True "
            "(the megastep kernel is single-device); use engine='xla' "
            "for sharded fleets")
    return engine


def _mesh(shard: bool, device) -> Optional[SH.FleetMesh]:
    """The mesh a ``shard=True`` run on ``device`` splits its lanes over
    (:func:`sharding.fleet_devices`), else None."""
    return SH.fleet_mesh(SH.fleet_devices(device)) if shard else None


def _drive(imgs, ids, states, trace, *, chunk: int, span=None, mesh=None):
    """Chunks of the megastep wrapper on the carry, in place, until no
    lane is alive (``span=None``: then ``HALT_FUEL`` is patched) or after
    ``span`` chunks.  With a ``mesh`` that partitions the lanes
    (:func:`sharding.shard_fleet`) the slices run in lockstep, each on its
    own device, and are written back into the carry."""
    from ..kernels.megastep import ops as mops  # lazy: kernel layer
    parts = (imgs, ids, states, trace)
    if mesh is not None:
        parts = SH.shard_fleet(imgs, ids, states, mesh, trace=trace)
    if isinstance(parts[2], SH.Shards):
        tr = parts[3] if trace is not None else (None,) * mesh.size
        mops.lockstep(list(zip(*parts[:3], tr)), chunk=chunk, span=span)
        SH.gather_lanes(parts[2], states)
        if trace is not None:
            SH.gather_lanes(parts[3], trace)
    else:
        mops.lockstep([(imgs, ids, states, trace)], chunk=chunk, span=span)
    if span is None:
        states.halted.copy_(_patch_fuel(states).halted)
    return states if trace is None else (states, trace)


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
    is updated in place.  ``shard=True`` splits the lanes over the
    devices (:func:`sharding.fleet_devices`: every visible card, or the
    one ``device`` names) when their count divides the lane count, runs
    the slices in lockstep and gathers them into the carry; the result is
    the same."""
    _check_engine(engine, shard=shard)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    imgs, img_ids, states = _fleet_inputs(imgs, states, img_ids, device)
    if trace is not None:
        trace = traces_to(trace, states.pc.device)
    return _drive(imgs, img_ids, states, trace, chunk=int(chunk),
                  mesh=_mesh(shard, device))


def run_fleet_span(imgs, states, img_ids, *, steps: int,
                   chunk: int = DEFAULT_CHUNK,
                   trace: Optional[TraceState] = None,
                   engine: str = "xla", device=None):
    """One bounded generation: up to ``steps`` masked steps (rounded up to
    a whole number of chunks), early exit when every lane halts.  Lanes
    out of fuel stay ``RUNNING`` (no ``HALT_FUEL`` patch).  With ``trace``
    returns ``(states, trace)``, as :func:`run_fleet`."""
    return _run_span(imgs, states, img_ids, steps=steps, chunk=chunk,
                     trace=trace, engine=engine, device=device)


def _run_span(imgs, states, img_ids, *, steps: int, chunk: int, trace,
              engine: str, device, mesh=None):
    """:func:`run_fleet_span`, its lanes split over ``mesh`` (a sharded
    server's generation)."""
    _check_engine(engine, shard=mesh is not None)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    imgs, img_ids, states = _fleet_inputs(imgs, states, img_ids, device)
    if trace is not None:
        trace = traces_to(trace, states.pc.device)
    return _drive(imgs, img_ids, states, trace, chunk=int(chunk),
                  span=-(-steps // chunk), mesh=mesh)


def finish_halt_codes(halted: np.ndarray, icount: np.ndarray,
                      fuel: np.ndarray) -> np.ndarray:
    """Host-side HALT_FUEL patch for harvested lanes (what
    :func:`run_fleet` does on the device at the end of a run)."""
    return np.where((halted == RUNNING) & (icount >= fuel),
                    np.int64(HALT_FUEL), halted)


# ---------------------------------------------------------------------------
# lane management: admission, restore, image rows, policy rows
# ---------------------------------------------------------------------------
#
# Every scatter here writes into the carry's own leaves (index_copy_), so
# the fleet keeps its buffers.  Slot lists follow the JAX package's
# ``mode="drop"`` convention: a negative slot counts from the end, a slot
# still out of range is dropped (callers pad with them), and of repeated
# slots the last wins (JAX's CPU scatter order, made explicit here because
# a CUDA index_copy_ leaves it undefined).

def _slot_index(slots: Sequence[int], n_lanes: int, device):
    """The entries of ``slots`` that land, as (their positions in
    ``slots``, their lanes on ``device``)."""
    idx = np.asarray(slots, np.int64).reshape(-1)
    idx = np.where(idx < 0, idx + n_lanes, idx)
    pos = np.flatnonzero((idx >= 0) & (idx < n_lanes))
    # the last occurrence of each lane
    _, first_rev = np.unique(idx[pos][::-1], return_index=True)
    pos = np.sort(pos[len(pos) - 1 - first_rev])
    return pos, torch.from_numpy(idx[pos]).to(device)


def _put_lanes(tree, idx: torch.Tensor, rows) -> None:
    """``leaf[idx[j]] = row[j]`` on every leaf of ``tree``, in place."""
    for leaf, row in zip(tree, rows):
        leaf.index_copy_(0, idx, row.to(leaf.device))


def _policy_arrays(rows: Sequence):
    """One compiled ``(action_row, arg_row)`` pair per entry (``None``:
    all-ALLOW) as the host arrays ``[k, N_POLICY_SLOTS]``."""
    pa = np.full((len(rows), N_POLICY_SLOTS), POL_ALLOW, np.int32)
    pg = np.zeros((len(rows), N_POLICY_SLOTS), np.int64)
    for i, r in enumerate(rows):
        if r is not None:
            pa[i], pg[i] = r
    return pa, pg


def admit_lanes(states: MachineState, slots: Sequence[int],
                lane_states: Sequence[MachineState], *,
                trace: Optional[TraceState] = None,
                policies: Optional[Sequence] = None):
    """Admit fresh scalar initial states into lanes ``slots`` of a batched
    state, in place.

    ``lane_states`` must be *initial* states (``runtime.initial_state``):
    only their entry pc, fuel, mechanism flags, emulation gate and seeded
    registers are carried — everything else is reset exactly as
    ``initial_state`` does (zero memory, flags and counters, ``sp =
    STACK_TOP``, ``pid = PID``, a fresh preopened guest kernel), so an
    admitted row is bit-identical to ``initial_state``.

    With ``trace`` the admitted lanes' rings are recycled (records, count,
    halves and histogram zeroed) and ``policies`` — one ``(action_row,
    arg_row)`` pair per slot (:func:`repro_torch.trace.policy.
    compile_policy`), or ``None`` entries for all-ALLOW — go into the
    policy tables; returns ``(states, trace)``.
    """
    if len(slots) != len(lane_states) or not len(slots):
        raise ValueError("admit_lanes needs one lane state per slot, and at "
                         "least one slot")
    if trace is None and policies is not None:
        raise ValueError("policies require a trace carry")
    if policies is not None and len(policies) != len(slots):
        raise ValueError("policies need one entry per slot")
    dev = states.pc.device
    pos, idx = _slot_index(slots, int(states.pc.shape[0]), dev)
    if len(pos):
        kept = [lane_states[i] for i in pos]

        def col(f):
            return torch.stack([getattr(ls, f) for ls in kept]).to(dev)

        rows = make_halted_states(len(pos), device=dev)._replace(
            regs=col("regs"), pc=col("pc"), fuel=col("fuel"),
            halted=torch.full((len(pos),), RUNNING, dtype=I64, device=dev),
            sig_handler=col("sig_handler"), ptrace=col("ptrace"),
            virt_getpid=col("virt_getpid"), k_enabled=col("k_enabled"))
        _put_lanes(states, idx, rows)
    if trace is None:
        return states
    if len(pos):
        pa, pg = _policy_arrays(policies if policies is not None
                                else [None] * len(slots))
        cap = int(trace.buf.shape[2])
        rows_t = make_empty_trace(len(pos), cap, device=dev)._replace(
            pol_action=torch.from_numpy(pa[pos]).to(dev),
            pol_arg=torch.from_numpy(pg[pos]).to(dev))
        _put_lanes(trace, idx, rows_t)
    return states, trace


def set_image_row(imgs: FleetImages, row: int,
                  new: DecodedImage) -> FleetImages:
    """Write one decode table into row ``row`` of a packed image stack, in
    place, and return the stack — incremental image admission that leaves
    the other rows and the stack's shape alone.  The next span builds its
    decode table from the new row."""
    one = pack_images(stack_images([new]))
    imgs.packed[row].copy_(one.packed[0])
    imgs.imm[row].copy_(one.imm[0])
    return imgs


def update_policy_rows(trace: TraceState, lanes: Sequence[int],
                       rows: Sequence) -> TraceState:
    """Swap the policy-table rows of *running* lanes in place, between
    spans; rings, counters and machine states are untouched, so every
    other lane stays bit-identical.  ``lanes`` are physical lane indices
    (padding drops, as for :func:`admit_lanes`); ``rows`` is one compiled
    ``(action_row, arg_row)`` pair per lane — ``None`` entries are
    all-ALLOW."""
    if len(lanes) != len(rows) or not len(lanes):
        raise ValueError("update_policy_rows needs one row per lane, and at "
                         "least one lane")
    dev = trace.count.device
    pos, idx = _slot_index(lanes, int(trace.count.shape[0]), dev)
    pa, pg = _policy_arrays(rows)
    trace.pol_action.index_copy_(0, idx, torch.from_numpy(pa[pos]).to(dev))
    trace.pol_arg.index_copy_(0, idx, torch.from_numpy(pg[pos]).to(dev))
    return trace


def restore_lanes(states: MachineState, slots: Sequence[int],
                  lane_states: Sequence[MachineState], *,
                  trace: Optional[TraceState] = None,
                  lane_traces: Optional[Sequence[TraceState]] = None):
    """Scatter *checkpointed* lanes back into slots ``slots``, in place.

    Unlike :func:`admit_lanes`, which rebuilds an initial state, the whole
    per-lane carry is written — memory, registers, counters and (traced)
    the ring, policy tables and verdict counters — so a preempted lane
    resumes where its checkpoint left off and ends bit-identical to an
    uninterrupted run.  A checkpoint must be a copy: :func:`unstack_state`
    and :func:`unstack_trace` give views into the fleet, which later
    admissions overwrite.  Slots drop as for :func:`admit_lanes`.  Returns
    ``states``, or ``(states, trace)``.
    """
    if len(slots) != len(lane_states) or not len(slots):
        raise ValueError("restore_lanes needs one lane state per slot, and "
                         "at least one slot")
    if trace is None and lane_traces is not None:
        raise ValueError("lane_traces require a trace carry")
    if trace is not None and (lane_traces is None
                              or len(lane_traces) != len(slots)):
        raise ValueError("a traced restore needs one lane trace per slot")
    pos, idx = _slot_index(slots, int(states.pc.shape[0]), states.pc.device)
    if len(pos):
        _put_lanes(states, idx, stack_states([lane_states[i] for i in pos]))
        if trace is not None:
            _put_lanes(trace, idx,
                       stack_traces([lane_traces[i] for i in pos]))
    return states if trace is None else (states, trace)


# ---------------------------------------------------------------------------
# streaming trace harvest: half-flips and overlapped cold-half readback
# ---------------------------------------------------------------------------
#
# At span boundaries the driver flips every lane's hot half (a [B] update;
# the 2 x CAP buffer is never copied) and gathers the now-cold half into a
# fresh buffer, whose copy to the host overlaps the next span.  While a
# span runs at most CAP steps a lane (worst case one svc a step), a half
# cannot wrap between flips, so every record reaches the host: zero drops
# at fixed device memory.  The host side is repro_torch.trace.stream.

def flip_trace(trace: TraceState):
    """Flip every lane's hot half and gather the cold half for harvest.

    Returns ``(trace, cold, counts, bases)``: the carry, updated in place
    (``hot`` toggled, ``base`` set to the lifetime count in its own buffer:
    it never aliases ``count``, which the next span advances; ``buf`` is
    untouched — stale cold rows are overwritten on the next pass), the
    cold halves as a fresh tensor ``int64[B, CAP, REC_WORDS]`` on the
    carry's device, and host copies of the pre-flip ``count`` / ``base``:
    lane ``b``'s cold half holds the records with lifetime sequence
    numbers ``[bases[b], counts[b])``.
    """
    host = torch.stack([trace.count, trace.base]).cpu().numpy()
    lanes = torch.arange(trace.hot.shape[0], device=trace.hot.device)
    cold = trace.buf[lanes, trace.hot]
    trace.hot.neg_().add_(1)
    trace.base.copy_(trace.count)
    return trace, cold, host[0], host[1]


def stream_interval(cap: int, chunk: int) -> int:
    """The widest flip interval (in steps) that still guarantees zero
    drops when chunk boundaries permit it: the largest multiple of
    ``chunk`` that is <= ``cap``.  When ``chunk > cap`` a flip cannot land
    inside a chunk, so the interval is one chunk — drops are then
    *possible* for svc-every-step lanes, and the sink counts them."""
    if chunk >= cap:
        return int(chunk)
    return (cap // chunk) * chunk


def _to_host_async(t: torch.Tensor):
    """Start ``t``'s copy to the host: on the card into pinned memory,
    behind an event (:func:`_landed` waits for it)."""
    if t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _landed(host, ev) -> np.ndarray:
    if ev is not None:
        ev.synchronize()
    return host.numpy()


def run_fleet_stream(imgs, states, img_ids=None, *,
                     chunk: int = DEFAULT_CHUNK,
                     trace: TraceState,
                     stream,
                     interval: Optional[int] = None,
                     keys: Optional[Sequence] = None,
                     engine: str = "xla", device=None):
    """:func:`run_fleet` with streaming trace harvest: run every lane to
    halt in spans of ``interval`` steps (default :func:`stream_interval`),
    flip the ring halves after each span and push the cold halves into
    ``stream`` (a :class:`repro_torch.trace.stream.TraceStream`).  Machine
    states are bit-identical to the unstreamed run; the stream receives
    every record whenever ``interval <= cap``.

    Span k's cold halves go to pinned host memory behind an event and are
    decoded on the host while span k+1 runs.  ``keys`` names each lane in
    the stream (default: the lane index).  Returns ``(states, trace)``;
    ``device=None`` means the card."""
    _check_engine(engine)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    from ..kernels.megastep import ops as mops  # lazy: kernel layer
    imgs, img_ids, states = _fleet_inputs(imgs, states, img_ids, device)
    trace = traces_to(trace, states.pc.device)
    cap = int(trace.buf.shape[2])
    interval = stream_interval(cap, chunk) if interval is None else \
        int(interval)
    if interval < 1:
        raise ValueError(f"interval must be >= 1, got {interval}")
    span = -(-interval // chunk)
    if keys is None:
        keys = list(range(int(states.pc.shape[0])))
    pending = None
    while True:
        mops.span(imgs, img_ids, states, trace, chunk=int(chunk), span=span)
        if pending is not None:
            # the previous span's cold halves, decoded while this span runs
            stream.push_block(keys, _landed(*pending[0]), *pending[1:])
        halted, icount, fuel = _host_rows(states.halted, states.icount,
                                          states.fuel)
        _, cold, counts, bases = flip_trace(trace)
        pending = (_to_host_async(cold), counts, bases)
        if not ((halted == RUNNING) & (icount < fuel)).any():
            break
    stream.push_block(keys, _landed(*pending[0]), *pending[1:])
    states.halted.copy_(_patch_fuel(states).halted)
    return states, trace


def _host_rows(*leaves) -> np.ndarray:
    """``[B]`` leaves as one host array (a copy: the leaves change in
    place)."""
    return torch.stack(leaves).cpu().numpy()


# ---------------------------------------------------------------------------
# live-lane compaction: bucketed re-dispatch over a ladder of widths
# ---------------------------------------------------------------------------
#
# A fixed-width fleet keeps halted lanes in every launch.  Since a lane's
# trajectory does not depend on which lanes share its launch, the fleet
# can be compacted at span boundaries — live lanes gathered into a dense
# prefix by one permutation of every carry leaf — and run on at a
# narrower power-of-two width.  The inverse permutation is kept on the
# host, and the lanes are written back into the caller's carry in lane
# order, so results are bit-identical to run_fleet's.

DEFAULT_MIN_BUCKET = 8


def compact_ladder(n_lanes: int, min_bucket: int = DEFAULT_MIN_BUCKET, *,
                   divisor: int = 1) -> List[int]:
    """Descending bucket widths: the full fleet width, then every power of
    two below it down to ``min_bucket``.  ``divisor`` keeps only rungs it
    divides (per-shard ladders)."""
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    min_bucket = max(1, int(min_bucket), int(divisor))
    rungs = [int(n_lanes)]
    w = (1 << max(0, int(n_lanes) - 1).bit_length()) >> 1
    while w >= min_bucket:
        if w < n_lanes and w % divisor == 0:
            rungs.append(w)
        w >>= 1
    return rungs


def choose_bucket(ladder: Sequence[int], n_live: int, *,
                  cur: Optional[int] = None,
                  hysteresis: float = 0.0) -> int:
    """The occupancy-chosen rung: the smallest ladder width that holds
    ``n_live`` lanes.  With ``hysteresis`` h, a *shrink* below ``cur`` is
    only taken when the live count also clears ``rung * (1 - h)``, so a
    pool near a boundary does not oscillate between rungs."""
    asc = sorted({int(w) for w in ladder})
    need = max(1, int(n_live))
    target = next((w for w in asc if w >= need), asc[-1])
    if cur is not None and hysteresis > 0.0:
        while target < int(cur) and need > target * (1.0 - hysteresis):
            target = next((w for w in asc if w > target), int(cur))
    return target


def make_halted_states(n: int, *, device=None) -> MachineState:
    """A batched all-halted fleet state on ``device`` (``None`` means the
    card): every lane parked on ``HALT_EXIT`` with zero fuel, so no driver
    steps it; every leaf its own buffer.  The padding of a pool, and the
    blank rows an admission fills in."""
    dev = resolve_device(device)

    def z():
        return torch.zeros((n,), dtype=I64, device=dev)

    def full(v):
        return torch.full((n,), v, dtype=I64, device=dev)

    return MachineState(
        regs=torch.zeros((n, 31), dtype=I64, device=dev),
        sp=full(L.STACK_TOP), pc=z(), nzcv=z(),
        mem=torch.zeros((n, L.MEM_WORDS), dtype=I64, device=dev),
        cycles=z(), icount=z(), fuel=z(), halted=full(HALT_EXIT),
        exit_code=z(), fault_pc=z(), sig_handler=z(), in_signal=z(),
        ptrace=z(), virt_getpid=z(), hook_count=z(), pid=full(L.PID),
        in_off=z(), out_count=z(), out_sum=z(), enosys_count=z(),
        emul_served=z(), **emul_state.fresh_kern(n, device=dev))


def make_empty_trace(n: int, cap: int, *, device=None) -> TraceState:
    """An all-ALLOW, empty-ring trace carry on ``device`` (``None`` means
    the card): ``recorder.make_trace_state`` with no policies."""
    from ..trace import recorder  # local: repro_torch.trace imports fleet
    return recorder.make_trace_state(n, cap, device=device)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of tensors, named tuples and tuples."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    out = [_tree_map(fn, *xs) for xs in zip(*trees)]
    return type(t)(*out) if hasattr(t, "_fields") else tuple(out)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for x in tree:
            yield from _leaves(x)


def permute_split(tree, keep_idx, drop_idx):
    """One gather over every lane-leading leaf of ``tree`` (a carry, or a
    tuple of carries): returns ``(kept, dropped)`` trees of fresh tensors,
    the lanes ``keep_idx`` as a dense prefix and ``drop_idx`` after."""
    dev = next(_leaves(tree)).device
    keep = torch.as_tensor(np.asarray(keep_idx), dtype=I64).to(dev)
    drop = torch.as_tensor(np.asarray(drop_idx), dtype=I64).to(dev)
    return (_tree_map(lambda x: x.index_select(0, keep), tree),
            _tree_map(lambda x: x.index_select(0, drop), tree))


def concat_lanes(tree, pad_tree):
    """Append ``pad_tree``'s lanes (e.g. :func:`make_halted_states`) after
    ``tree``'s along the lane axis: the grow transition of a pool."""
    return _tree_map(lambda a, b: torch.cat([a, b]), tree, pad_tree)


def precompile_ladder(imgs, ladder: Sequence[int], *,
                      chunk: int = DEFAULT_CHUNK,
                      interval: Optional[int] = None,
                      trace_cap: Optional[int] = None,
                      shard: bool = False,
                      engine: str = "xla", device=None) -> None:
    """Make ready everything a compacted run on ``device`` (``None`` means
    the card) can hit, ahead of the run.  The JAX package compiles one
    executable a rung here; the port's kernel is one build for every
    width, image set and trace capacity, so this builds (or loads) the
    kernel library once and ``imgs``, ``ladder``, ``chunk``, ``interval``
    and ``trace_cap`` change nothing."""
    _check_engine(engine, shard=shard)
    if resolve_device(device).type == "cuda":
        from ..kernels.megastep import kernel  # lazy: builds at first use
        kernel.load_library()


def _assemble_lanes(out, segments) -> None:
    """Inverse-permutation assembly: write each finished segment (original
    lane ids, carry slices) back into ``out``, the caller's carry, in
    lane order, on its device."""
    for idx, tree in segments:
        if next(_leaves(tree)) is next(_leaves(out)):
            continue  # never compacted: the lanes are already in place
        lanes = torch.from_numpy(np.asarray(idx, np.int64)).to(
            next(_leaves(out)).device)
        for dst, src in zip(_leaves(out), _leaves(tree)):
            dst.index_copy_(0, lanes, src)


def run_fleet_compact(imgs, states, img_ids=None, *,
                      chunk: int = DEFAULT_CHUNK,
                      min_bucket: int = DEFAULT_MIN_BUCKET,
                      hysteresis: float = 0.0,
                      interval: Optional[int] = None,
                      shard: bool = False,
                      trace: Optional[TraceState] = None,
                      stats: Optional[dict] = None,
                      engine: str = "xla", device=None):
    """:func:`run_fleet` with live-lane compaction: results (states, and
    the trace carry when passed) are bit-identical and lane-ordered to
    the fixed-width run, but halted lanes leave the launches.

    The fleet runs in spans of ``interval`` masked steps (default ``8 *
    chunk``).  After each span the live count is read back; when it falls
    below the next rung of the ladder (:func:`compact_ladder`; power-of-two
    widths down to ``min_bucket``, ``hysteresis`` guarding borderline
    shrinks), live lanes are gathered into a dense prefix by one
    permutation of every carry leaf and the run goes on at the narrower
    width.  The finished lanes are written back into the carry passed in.

    ``stats`` (a dict, filled in place) receives the occupancy ledger:
    dispatched against useful lane-steps, the ladder and each compaction.
    ``device=None`` means the card.  ``shard=True`` splits every span's
    lanes over the devices as :func:`run_fleet` does; the ladder then
    keeps only the rungs the device count divides (per-shard ladders).
    """
    _check_engine(engine, shard=shard)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    imgs, img_ids, states = _fleet_inputs(imgs, states, img_ids, device)
    dev = states.pc.device
    traced = trace is not None
    if traced:
        trace = traces_to(trace, dev)
    n_lanes = int(states.pc.shape[0])
    ids_np = img_ids.cpu().numpy().copy()
    interval = chunk * 8 if interval is None else int(interval)
    if interval < 1:
        raise ValueError(f"interval must be >= 1, got {interval}")
    span = -(-interval // chunk)
    mesh = _mesh(shard, device)
    divisor = SH.fleet_divisor(n_lanes, mesh) if mesh else 1
    ladder = compact_ladder(n_lanes, min_bucket, divisor=divisor)

    order = np.arange(n_lanes)          # physical slot -> original lane
    cur_s, cur_t = states, trace
    W, ids_w = n_lanes, img_ids
    segments = []                        # (original lane ids, carry slices)
    prev_icount = _host_rows(cur_s.icount)[0]
    dispatched = useful = dispatches = 0
    compactions = []
    while True:
        _drive(imgs, ids_w, cur_s, cur_t, chunk=int(chunk), span=span,
               mesh=mesh)
        dispatches += 1
        halted, icount, fuel = _host_rows(cur_s.halted, cur_s.icount,
                                          cur_s.fuel)
        delta = icount - prev_icount
        # chunks actually run: the span stops at the first chunk boundary
        # with no live lane, so the longest lane's delta rounds up to them
        chunks_run = int(-(-int(delta.max()) // chunk)) if delta.max() else 0
        dispatched += W * chunks_run * chunk
        useful += int(delta.sum())
        alive = (halted == RUNNING) & (icount < fuel)
        n_live = int(alive.sum())
        if n_live == 0:
            break
        target = choose_bucket(ladder, n_live, cur=W, hysteresis=hysteresis)
        if target < W:
            perm = np.argsort(~alive, kind="stable")   # live lanes first
            kept, dropped = permute_split(
                (cur_s, cur_t) if traced else cur_s, perm[:target],
                perm[target:])
            segments.append((order[perm[target:]], dropped))
            cur_s, cur_t = kept if traced else (kept, None)
            compactions.append({"from": W, "to": target, "live": n_live})
            order = order[perm[:target]]
            W = target
            ids_w = torch.from_numpy(ids_np[order]).to(dev)
            prev_icount = icount[perm[:target]]
        else:
            prev_icount = icount
    segments.append((order, (cur_s, cur_t) if traced else cur_s))
    _assemble_lanes((states, trace) if traced else states, segments)
    states.halted.copy_(_patch_fuel(states).halted)

    if stats is not None:
        stats.update({
            "ladder": ladder,
            "interval": interval,
            "dispatches": dispatches,
            "compactions": compactions,
            "final_bucket": W,
            "dispatched_lane_steps": dispatched,
            "useful_steps": useful,
            "occupancy": round(useful / dispatched, 4) if dispatched else 1.0,
            "wasted_lane_steps": dispatched - useful,
        })
    return (states, trace) if traced else states


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


def unpack_images(imgs: FleetImages) -> DecodedImage:
    """Invert :func:`pack_images`: the packed words back to the eight SoA
    decode tables, as fresh CPU tensors (vectorised: no per-word decode)."""
    p = imgs.packed.cpu()

    def f32(shift, mask):
        return ((p >> shift) & mask).to(I32)

    return DecodedImage(
        op=f32(0, 0x3F), rd=f32(6, 0x1F), rn=f32(11, 0x1F),
        rm=f32(16, 0x1F), sh=f32(22, 0x3F), cond=f32(28, 0xF),
        sf=f32(32, 0x1), imm=imgs.imm.to("cpu", copy=True))


# ---------------------------------------------------------------------------
# durable-serving helpers (the device side of repro_torch.serve.durability)
# ---------------------------------------------------------------------------
#
# A fleet snapshot is the WHOLE carry — MachineState tree, optional
# TraceState tree — moved to the host as a flat {key: np.ndarray} dict,
# plus a full-coverage digest.  The digest does not reuse the checkpoint
# manager's prefix hash (the first 64KB of each leaf): the chaos harness
# must catch a single flipped bit anywhere in a [B, MEM_WORDS] memory
# plane, so every byte takes part.  crc32 is enough: corruption
# detection inside one trust domain, not an authenticated hash.  Both
# digests and the packed arrays equal the JAX package's for equal carries.

def _host(leaf) -> np.ndarray:
    """A contiguous host copy of one leaf (the carry changes in place, so
    nothing kept on the host may be a view of it)."""
    return leaf.detach().to("cpu", copy=True).contiguous().numpy()


def _trees(states: MachineState, trace: Optional[TraceState]):
    return (states,) if trace is None else (states, trace)


def carry_digest(states: MachineState,
                 trace: Optional[TraceState] = None) -> int:
    """Full-coverage crc32 over every byte of a fleet carry (machine state
    tree + optional trace tree), each leaf framed by its key, shape and
    dtype so a reshaped carry of equal bytes does not collide.  The
    detector of chaos-injected bit-flips in :mod:`repro_torch.serve.
    durability`; one host copy of each leaf."""
    crc = 0
    for tree in _trees(states, trace):
        for key, leaf in zip(tree._fields, tree):
            a = _host(leaf)
            crc = zlib.crc32(f"{key}:{a.shape}:{a.dtype};".encode(), crc)
            crc = zlib.crc32(memoryview(np.ascontiguousarray(a)).cast("B"),
                             crc)
    return crc


def lane_digests(states: MachineState,
                 trace: Optional[TraceState] = None) -> List[int]:
    """Per-lane crc32s of a fleet carry — :func:`carry_digest` restricted
    to lane ``b`` of every leaf, unframed.  Lets a rollback attribute a
    corrupted carry to the lanes (and so tenants) whose bytes diverged."""
    host = [_host(leaf) for tree in _trees(states, trace) for leaf in tree]
    out = []
    for b in range(int(states.halted.shape[0])):
        crc = 0
        for a in host:
            crc = zlib.crc32(memoryview(np.ascontiguousarray(a[b])).cast("B"),
                             crc)
        out.append(crc)
    return out


# Big mostly-zero planes stored as nonzero (idx, val) pairs in snapshots.
_SPARSE_CARRY = ("mem", "k_ino_data")


def pack_carry(states: MachineState, trace: Optional[TraceState] = None,
               *, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a fleet carry (or one lane of it) into snapshot arrays:
    ``state/<field>`` and ``trace/<field>`` host copies, with the
    mostly-zero big planes — the memory leaf and the inode data plane —
    stored sparsely (``state/<f>@idx`` flat nonzero indices, ascending,
    ``state/<f>@val`` their values, ``state/<f>@shape``).  The nonzeros
    are found where the carry lives, so only the pairs cross to the
    host: a 400-lane pool's dense memory plane is 105 MB.
    :func:`unpack_carry` reverses both encodings."""
    out: Dict[str, np.ndarray] = {}
    for f in _SPARSE_CARRY:
        dense = getattr(states, f)
        flat = dense.reshape(-1)
        idx = torch.nonzero(flat).reshape(-1)
        out[f"{prefix}state/{f}@idx"] = _host(idx)
        out[f"{prefix}state/{f}@val"] = _host(flat.index_select(0, idx))
        out[f"{prefix}state/{f}@shape"] = np.asarray(tuple(dense.shape),
                                                     np.int64)
    for key, leaf in zip(states._fields, states):
        if key not in _SPARSE_CARRY:
            out[f"{prefix}state/{key}"] = _host(leaf)
    if trace is not None:
        for key, leaf in zip(trace._fields, trace):
            out[f"{prefix}trace/{key}"] = _host(leaf)
    return out


def unpack_carry(arrays, *, prefix: str = "", device=None
                 ) -> Tuple[MachineState, Optional[TraceState]]:
    """Rebuild ``(MachineState, TraceState | None)`` from
    :func:`pack_carry` arrays, as fresh tensors on ``device`` (``None``
    means the card); the sparse planes are filled in there."""
    dev = resolve_device(device)

    def fresh(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    fields = {}
    for f in _SPARSE_CARRY:
        shape = tuple(int(x) for x in arrays[f"{prefix}state/{f}@shape"])
        dense = torch.zeros(int(np.prod(shape)), dtype=I64, device=dev)
        dense[fresh(arrays[f"{prefix}state/{f}@idx"])] = \
            fresh(arrays[f"{prefix}state/{f}@val"])
        fields[f] = dense.reshape(shape)
    for key in MachineState._fields:
        if key not in _SPARSE_CARRY:
            fields[key] = fresh(arrays[f"{prefix}state/{key}"])
    states = MachineState(**fields)
    if f"{prefix}trace/count" not in arrays:
        return states, None
    return states, TraceState(**{key: fresh(arrays[f"{prefix}trace/{key}"])
                                 for key in TraceState._fields})


def flip_bit(states: MachineState, lane: int, word: int,
             bit: int) -> MachineState:
    """Flip one bit of one lane's memory plane, in place where the carry
    lives (no host copy of the plane) — the chaos harness's injected
    carry corruption, which :func:`carry_digest` must catch.  Returns
    ``states``."""
    states.mem[lane, word] ^= int(np.int64(1) << np.int64(bit))
    return states
