"""Per-lane syscall trace rings: host-side construction + decoding
(PyTorch port of the JAX package's ``repro.trace.recorder``).

The *monitor* half of the subsystem (strace's role in the paper's "modify
or monitor" motivation).  The device side is a fixed-capacity ring of
8-word records per lane, appended inside the batched step under the svc
mask (:class:`repro_torch.core.fleet.TraceState`; on the card, inside the
CUDA megastep kernel).  This module builds that carry, decodes harvested
rings back into :class:`TraceRecord` rows (oldest-first, with the dropped
count when the ring wrapped), and renders them as strace-like text.
Decoding works on host copies: tensors on the card are moved to the CPU
first.

A record captures the syscall as *executed by the simulated kernel*: under
ASC/LD_PRELOAD the hook virtualises calls before any svc runs, so a traced
getpid loop shows only the syscalls that actually crossed the kernel
boundary — exactly what a real strace of a hooked process would show.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import layout as L
from ..core.fleet import (DEFAULT_TRACE_CAP, N_POLICY_SLOTS, N_VERDICTS,
                          POL_ALLOW, POL_DENY, POL_EMULATE, POL_KILL,
                          REC_WORDS, SLOT_UNKNOWN, TRACE_SYS, TraceState,
                          VERDICT_UNKNOWN)
from ..core.machine import resolve_device
from .policy import ALLOW_ALL, policy_rows

VERDICT_NAMES = {POL_ALLOW: "ALLOW", POL_DENY: "DENY", POL_EMULATE: "EMULATE",
                 POL_KILL: "KILL", VERDICT_UNKNOWN: "UNKNOWN"}

# (name, number of x0.. arguments shown) per syscall.  The first block is
# the modelled surface (repro_torch.core.fleet.TRACE_SYS); the rest are common
# AArch64 numbers an unmodelled guest may still issue (they execute as the
# -ENOSYS fall-through but should render under their real name and arity
# rather than the generic 3-arg "syscall_NNN" form).
_SYS_SIG = {
    L.SYS_READ: ("read", 3),
    L.SYS_WRITE: ("write", 3),
    L.SYS_GETPID: ("getpid", 0),
    L.SYS_EXIT: ("exit", 1),
    L.SYS_RT_SIGRETURN: ("rt_sigreturn", 0),
    L.SYS_OPENAT: ("openat", 3),
    L.SYS_CLOSE: ("close", 1),
    L.SYS_DUP: ("dup", 1),
    L.SYS_IOCTL: ("ioctl", 3),
    L.SYS_PIPE2: ("pipe2", 2),
    L.SYS_LSEEK: ("lseek", 3),
    L.SYS_FSTAT: ("fstat", 2),
    L.SYS_GETRANDOM: ("getrandom", 3),
    # unmodelled-but-named AArch64 numbers (arity per the syscall table)
    17: ("getcwd", 2),
    25: ("fcntl", 3),
    35: ("unlinkat", 3),
    48: ("faccessat", 3),
    66: ("writev", 3),
    78: ("readlinkat", 3),
    79: ("fstatat", 3),
    94: ("exit_group", 1),
    96: ("set_tid_address", 1),
    98: ("futex", 3),
    101: ("nanosleep", 2),
    113: ("clock_gettime", 2),
    129: ("kill", 2),
    134: ("rt_sigaction", 3),
    135: ("rt_sigprocmask", 3),
    160: ("uname", 1),
    169: ("gettimeofday", 2),
    174: ("getuid", 0),
    175: ("geteuid", 0),
    178: ("gettid", 0),
    214: ("brk", 1),
    215: ("munmap", 2),
    220: ("clone", 3),
    221: ("execve", 3),
    222: ("mmap", 3),
    226: ("mprotect", 3),
    260: ("wait4", 3),
    291: ("statx", 3),
}

_ERRNO_NAMES = {
    1: "EPERM", 2: "ENOENT", 4: "EINTR", 5: "EIO", 9: "EBADF", 11: "EAGAIN",
    12: "ENOMEM", 13: "EACCES", 14: "EFAULT", 16: "EBUSY", 17: "EEXIST",
    20: "ENOTDIR", 21: "EISDIR", 22: "EINVAL", 23: "ENFILE", 24: "EMFILE",
    25: "ENOTTY", 27: "EFBIG", 28: "ENOSPC", 29: "ESPIPE", 32: "EPIPE",
    34: "ERANGE", 38: "ENOSYS", 110: "ETIMEDOUT",
}


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    """One decoded ring row: the syscall as the simulated kernel saw it."""

    step: int      # lane icount when the svc executed
    pc: int        # address of the svc instruction
    nr: int        # syscall number (x8)
    x0: int
    x1: int
    x2: int
    ret: int       # the value the application observed in x0 afterwards
    verdict: int   # POL_* / VERDICT_UNKNOWN

    @property
    def name(self) -> str:
        sig = _SYS_SIG.get(self.nr)
        return sig[0] if sig else f"syscall_{self.nr}"


def make_trace_state(n_lanes: int, cap: int = DEFAULT_TRACE_CAP, *,
                     policies: Optional[Sequence] = None,
                     device=None) -> TraceState:
    """A fresh trace carry for ``n_lanes`` lanes on ``device`` (``None``
    means the card): empty rings plus per-lane policy tables (``policies``
    = one rule list per lane, or None for the all-ALLOW default that keeps
    tracing architecturally invisible)."""
    assert n_lanes >= 1 and cap >= 1
    device = resolve_device(device)
    if policies is None:
        pa = np.broadcast_to(ALLOW_ALL[0], (n_lanes, ALLOW_ALL[0].shape[0]))
        pg = np.broadcast_to(ALLOW_ALL[1], (n_lanes, ALLOW_ALL[1].shape[0]))
    else:
        assert len(policies) == n_lanes
        pa, pg = policy_rows(policies)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=device)

    return TraceState(
        buf=zeros(n_lanes, 2, cap, REC_WORDS),
        count=zeros(n_lanes),
        hot=zeros(n_lanes),
        base=zeros(n_lanes),
        hist=zeros(n_lanes, N_POLICY_SLOTS, N_VERDICTS),
        # row-major copies: a copy of the broadcast default keeps its
        # column-major strides, which the kernel refuses
        pol_action=torch.from_numpy(np.array(pa, np.int32, order="C")).to(
            device),
        pol_arg=torch.from_numpy(np.array(pg, np.int64, order="C")).to(
            device),
        deny_count=zeros(n_lanes),
        emul_count=zeros(n_lanes),
        kill_count=zeros(n_lanes),
    )


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def decode_rows(rows) -> List[TraceRecord]:
    """int64[N, REC_WORDS] -> records, via ONE bulk ``tolist`` conversion
    instead of N x REC_WORDS scalar ``int()`` round-trips (the serving
    harvest hot path)."""
    return [TraceRecord(*r) for r in _host(rows).tolist()]


def harvest_lane(buf: np.ndarray, count: int) -> Tuple[List[TraceRecord], int]:
    """Decode one lane's ring (``buf`` = int64[CAP, REC_WORDS] — one half —
    or the full int64[2, CAP, REC_WORDS] double buffer of a never-flipped
    lane, whose hot half is half 0; ``count`` = lifetime records) into
    oldest-first records plus the dropped count.

    When the ring wrapped, the oldest surviving record sits at
    ``count % cap`` — the slot the next append would overwrite.  Flipped
    (streamed) lanes are not decodable from the carry alone; their records
    live in the stream sink (:class:`repro_torch.trace.stream.TraceStream`).
    """
    buf = _host(buf)
    if buf.ndim == 3:          # [2, CAP, REC_WORDS]: the un-flipped hot half
        buf = buf[0]
    cap = buf.shape[0]
    count = int(count)
    dropped = max(0, count - cap)
    n = min(count, cap)
    start = count % cap if count > cap else 0
    order = (start + np.arange(n)) % cap
    return decode_rows(buf[order]), dropped


def harvest(trace: TraceState) -> List[Tuple[List[TraceRecord], int]]:
    """Decode every lane with one device->host transfer per field."""
    buf = _host(trace.buf)
    count = _host(trace.count)
    return [harvest_lane(buf[i], count[i]) for i in range(buf.shape[0])]


def lane_histogram(hist: np.ndarray) -> dict:
    """One lane's on-device ``hist`` plane (int64[N_POLICY_SLOTS,
    N_VERDICTS]) as ``{syscall name: {verdict name: n}}``, zero rows
    elided — the analytics view that never touches a ring."""
    h = _host(hist)
    out = {}
    for slot in range(h.shape[0]):
        if not h[slot].any():
            continue
        name = (_SYS_SIG[TRACE_SYS[slot]][0] if slot < SLOT_UNKNOWN
                else "unknown")
        out[name] = {VERDICT_NAMES[v]: int(h[slot, v])
                     for v in range(h.shape[1]) if h[slot, v]}
    return out


def _fmt_ret(r: TraceRecord) -> str:
    if r.verdict == POL_KILL:
        return "?"
    if r.ret < 0:
        name = _ERRNO_NAMES.get(-r.ret)
        return f"{r.ret} {name}" if name else str(r.ret)
    return str(r.ret)


def format_record(r: TraceRecord) -> str:
    """One strace-like line, annotated with the non-ALLOW verdict."""
    sig = _SYS_SIG.get(r.nr)
    if sig:
        nargs = sig[1]
        args = ", ".join(f"{v:#x}" if i == 1 and nargs >= 3 else str(v)
                         for i, v in enumerate((r.x0, r.x1, r.x2)[:nargs]))
    else:
        # unknown number: the arity is unknown, so render every captured
        # register defensively in hex rather than guessing types
        args = ", ".join(f"{v:#x}" for v in (r.x0, r.x1, r.x2))
    line = f"{r.name}({args}) = {_fmt_ret(r)}"
    if r.verdict == POL_DENY:
        line += "  <denied by policy>"
    elif r.verdict == POL_EMULATE:
        line += "  <emulated by policy>"
    elif r.verdict == POL_KILL:
        line += "  <killed by policy>"
    return line


def format_strace(records: Iterable[TraceRecord], *, dropped: int = 0,
                  pid: Optional[int] = None) -> str:
    """Render a lane's records as an strace-style transcript."""
    prefix = f"[pid {pid}] " if pid is not None else ""
    lines = []
    if dropped:
        lines.append(f"{prefix}... {dropped} oldest record(s) dropped "
                     f"(ring wrapped) ...")
    for r in records:
        lines.append(prefix + format_record(r))
        if r.verdict == POL_KILL:
            lines.append(f"{prefix}+++ killed by policy +++")
    return "\n".join(lines)
