"""Workload programs for the evaluation (paper §4).

Each builder returns a fresh ``Asm`` for the application text, calling into
the mini-libc exactly the way compiled C would (``bl`` to wrapper symbols).
The set mirrors the paper's benchmarks at simulation scale:

* ``getpid_loop``   — Table 3 microbenchmark (hook overhead per call);
* ``read_loop``     — the MPI-BFS read-heavy workload (Figure 5);
* ``mixed_ops``     — the SQLite speedtest1-like mixed syscall workload;
* ``io_bandwidth``  — the IOR/redis/nginx-style bandwidth workload (Figure 6);
* ``indirect_svc``  — the Figure 4 program: an indirect jump whose target is
  an svc instruction (completeness strategy C3);
* ``retry_loop``    — a direct back-edge onto an svc (strategy C2);
* ``caller_x8``     — x8 assigned by the caller of a raw svc (strategy C1);
* ``file_churn_param`` / ``proc_probe_param`` / ``bad_fd_probe`` — guest
  kernel emulation workloads (repro.emul): real open/write/seek/read/close
  churn against the in-memory filesystem, the synthetic procfs window, and
  the errno paths (-EBADF / -ENOENT).
"""
from __future__ import annotations

from . import isa
from . import layout as L
from .image import APP_BASE
from .isa import Asm


def _exit0(a: Asm) -> None:
    a.emit(isa.movz(0, 0))
    a.bl_to("libc.so:exit")


_BURN_ID = [0]


def _burn(a: Asm, n: int) -> None:
    """~2n cycles of user-space compute (models the app work between
    syscalls; calibrates workload syscall-density to the paper's apps)."""
    if n <= 0:
        return
    _BURN_ID[0] += 1
    lbl = f"burn{_BURN_ID[0]}"
    a.emit(*isa.mov_imm48(25, n))
    a.label(lbl)
    a.emit(isa.subsi(25, 25, 1))
    a.b_to(lbl, cond="ne")


def getpid_loop(n: int = 1000) -> Asm:
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(19, n))
    a.label("loop")
    a.bl_to("libc.so:getpid")
    a.emit(isa.mov_r(20, 0))  # keep last pid for verification
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    # store the observed pid for the transparency check
    a.emit(isa.movz(10, L.SCRATCH & 0xFFFF), isa.movk(10, L.SCRATCH >> 16, 1))
    a.emit(isa.str_imm(20, 10))
    _exit0(a)
    return a


def read_loop(n: int = 256, nbytes: int = 1024, work: int = 0) -> Asm:
    assert nbytes % 8 == 0
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(19, n))
    a.emit(*isa.mov_imm48(21, L.HEAP_BASE))
    a.emit(*isa.mov_imm48(22, nbytes))
    a.label("loop")
    a.emit(isa.movz(0, 3))        # fd
    a.emit(isa.mov_r(1, 21))      # buf
    a.emit(isa.mov_r(2, 22))      # count
    a.bl_to("libc.so:read")
    _burn(a, work)
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    a.emit(isa.movz(0, 1))
    a.emit(isa.mov_r(1, 21))
    a.emit(isa.mov_r(2, 22))
    a.bl_to("libc.so:write")      # checksum flush
    _exit0(a)
    return a


def mixed_ops(n: int = 64, nbytes: int = 512, work: int = 0) -> Asm:
    assert nbytes % 8 == 0
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(19, n))
    a.emit(*isa.mov_imm48(21, L.HEAP_BASE))
    a.label("loop")
    a.emit(isa.movz(0, 0), isa.movz(1, 0), isa.movz(2, 0))
    a.bl_to("libc.so:openat")
    a.emit(isa.mov_r(23, 0))      # fd
    a.emit(isa.mov_r(0, 23))
    a.emit(isa.mov_r(1, 21))
    a.emit(*isa.mov_imm48(2, nbytes))
    a.bl_to("libc.so:read")
    a.emit(isa.mov_r(0, 23))
    a.emit(isa.mov_r(1, 21))
    a.emit(*isa.mov_imm48(2, nbytes))
    a.bl_to("libc.so:write")
    a.emit(isa.mov_r(0, 23))
    a.bl_to("libc.so:close")
    _burn(a, work)
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    _exit0(a)
    return a


def io_bandwidth(n: int = 128, nbytes: int = 4096, work: int = 0) -> Asm:
    """Large sequential transfers: overhead should amortise (Figure 6)."""
    assert nbytes % 8 == 0
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(19, n))
    a.emit(*isa.mov_imm48(21, L.HEAP_BASE))
    a.label("loop")
    a.emit(isa.movz(0, 3))
    a.emit(isa.mov_r(1, 21))
    a.emit(*isa.mov_imm48(2, nbytes))
    a.bl_to("libc.so:read")
    a.emit(isa.movz(0, 1))
    a.emit(isa.mov_r(1, 21))
    a.emit(*isa.mov_imm48(2, nbytes))
    a.bl_to("libc.so:write")
    _burn(a, work)
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    _exit0(a)
    return a


# -- parameterised variants (fleet censuses) ---------------------------------
#
# Same workloads, but the iteration count comes from x19 at entry instead of
# being baked into the text as a mov_imm48.  Every iteration-count lane of a
# census then shares ONE image per (mechanism, workload) — the decode tables
# deduplicate (pack_fleet), exactly like a production fleet running many
# processes of the same binary with different arguments.  Seed x19 via
# ``run_prepared(..., regs={19: n})`` / ``pack_fleet(..., regs=[...])``.

def getpid_loop_param() -> Asm:
    a = Asm(APP_BASE)
    a.label("main")
    a.label("loop")
    a.bl_to("libc.so:getpid")
    a.emit(isa.mov_r(20, 0))
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    a.emit(isa.movz(10, L.SCRATCH & 0xFFFF), isa.movk(10, L.SCRATCH >> 16, 1))
    a.emit(isa.str_imm(20, 10))
    _exit0(a)
    return a


def read_loop_param(nbytes: int = 1024) -> Asm:
    assert nbytes % 8 == 0
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(21, L.HEAP_BASE))
    a.emit(*isa.mov_imm48(22, nbytes))
    a.label("loop")
    a.emit(isa.movz(0, 3))
    a.emit(isa.mov_r(1, 21))
    a.emit(isa.mov_r(2, 22))
    a.bl_to("libc.so:read")
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    a.emit(isa.movz(0, 1))
    a.emit(isa.mov_r(1, 21))
    a.emit(isa.mov_r(2, 22))
    a.bl_to("libc.so:write")
    _exit0(a)
    return a


def mixed_ops_param(nbytes: int = 512) -> Asm:
    assert nbytes % 8 == 0
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(21, L.HEAP_BASE))
    a.label("loop")
    a.emit(isa.movz(0, 0), isa.movz(1, 0), isa.movz(2, 0))
    a.bl_to("libc.so:openat")
    a.emit(isa.mov_r(23, 0))
    a.emit(isa.mov_r(0, 23))
    a.emit(isa.mov_r(1, 21))
    a.emit(*isa.mov_imm48(2, nbytes))
    a.bl_to("libc.so:read")
    a.emit(isa.mov_r(0, 23))
    a.emit(isa.mov_r(1, 21))
    a.emit(*isa.mov_imm48(2, nbytes))
    a.bl_to("libc.so:write")
    a.emit(isa.mov_r(0, 23))
    a.bl_to("libc.so:close")
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    _exit0(a)
    return a


def io_bandwidth_param(nbytes: int = 4096) -> Asm:
    assert nbytes % 8 == 0
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(21, L.HEAP_BASE))
    a.label("loop")
    a.emit(isa.movz(0, 3))
    a.emit(isa.mov_r(1, 21))
    a.emit(*isa.mov_imm48(2, nbytes))
    a.bl_to("libc.so:read")
    a.emit(isa.movz(0, 1))
    a.emit(isa.mov_r(1, 21))
    a.emit(*isa.mov_imm48(2, nbytes))
    a.bl_to("libc.so:write")
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    _exit0(a)
    return a


# -- guest-kernel emulation workloads (repro.emul) ---------------------------
#
# These exercise the emulated syscall surface: per-lane fd tables, the
# in-memory filesystem and the synthetic procfs.  New syscall numbers go
# through ``libc.so:raw_svc`` with a caller-side x8 assignment (the C1
# pattern) rather than new libc wrappers, so the library's svc-site census
# — and with it the rewriter/classification oracles — stays fixed.  Path
# names are identified by their first 8 bytes (repro.emul.state.path_key),
# so a program "writes a path" by storing one 8-byte little-endian word.

def _raw(a: Asm, nr: int) -> None:
    a.emit(isa.movz(8, nr, sf=0))
    a.bl_to("libc.so:raw_svc")


def _mov_imm64(rd: int, value: int) -> list:
    """movz + 3x movk: a full 64-bit immediate (path-key words)."""
    assert 0 <= value < (1 << 64), value
    return [isa.movz(rd, value & 0xFFFF, 0),
            isa.movk(rd, (value >> 16) & 0xFFFF, 1),
            isa.movk(rd, (value >> 32) & 0xFFFF, 2),
            isa.movk(rd, (value >> 48) & 0xFFFF, 3)]


def _store_path(a: Asm, reg_addr: int, reg_tmp: int, name: bytes) -> None:
    """Place ``name``'s path-key word at the buffer held in ``reg_addr``."""
    from ..emul.state import path_key
    a.emit(*_mov_imm64(reg_tmp, path_key(name)))
    a.emit(isa.str_imm(reg_tmp, reg_addr))


def file_churn_param(nbytes: int = 512) -> Asm:
    """x19 iterations of openat(O_CREAT|O_TRUNC) -> write -> lseek(0,SET) ->
    read -> close on one regular file of the in-memory filesystem — the
    emulation subsystem's churn workload (BENCH_emul).  The last read's
    return lands at SCRATCH (= nbytes when the kernel personality is on)."""
    assert nbytes % 8 == 0 and 0 < nbytes <= L.FILE_BYTES
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(21, L.HEAP_BASE))          # data buffer
    a.emit(*isa.mov_imm48(24, L.HEAP_BASE + 2048))   # path buffer
    _store_path(a, 24, 25, b"churn.da")
    a.label("loop")
    a.emit(isa.movz(0, 0))                           # dirfd (ignored)
    a.emit(isa.mov_r(1, 24))
    a.emit(*isa.mov_imm48(2, L.O_CREAT | L.O_TRUNC))
    _raw(a, L.SYS_OPENAT)
    a.emit(isa.mov_r(23, 0))                         # fd
    a.emit(isa.mov_r(0, 23))
    a.emit(isa.mov_r(1, 21))
    a.emit(*isa.mov_imm48(2, nbytes))
    a.bl_to("libc.so:write")
    a.emit(isa.mov_r(0, 23))
    a.emit(isa.movz(1, 0))
    a.emit(isa.movz(2, L.SEEK_SET))
    _raw(a, L.SYS_LSEEK)
    a.emit(isa.mov_r(0, 23))
    a.emit(isa.mov_r(1, 21))
    a.emit(*isa.mov_imm48(2, nbytes))
    a.bl_to("libc.so:read")
    a.emit(isa.mov_r(20, 0))                         # last read count
    a.emit(isa.mov_r(0, 23))
    a.bl_to("libc.so:close")
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    a.emit(isa.movz(10, L.SCRATCH & 0xFFFF), isa.movk(10, L.SCRATCH >> 16, 1))
    a.emit(isa.str_imm(20, 10))
    _exit0(a)
    return a


def proc_probe_param() -> Asm:
    """x19 iterations of openat("/proc/se...") -> read the counter window ->
    close.  The procfs read snapshots per-lane kernel statistics (virtual
    pid, icount, cycles, hook/enosys/emul counts...) into the heap buffer;
    the program stores the observed pid word at SCRATCH — under PTRACE
    with virtualize=True, procfs must agree with the virtualised getpid
    (VIRT_PID); under ASC the library virtualises getpid before any svc
    fires, so the kernel's procfs view shows the real PID."""
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(21, L.HEAP_BASE))
    a.emit(*isa.mov_imm48(24, L.HEAP_BASE + 2048))
    from ..emul.state import PROC_KEY
    a.emit(*_mov_imm64(25, PROC_KEY))
    a.emit(isa.str_imm(25, 24))
    a.label("loop")
    a.emit(isa.movz(0, 0))
    a.emit(isa.mov_r(1, 24))
    a.emit(isa.movz(2, 0))
    _raw(a, L.SYS_OPENAT)
    a.emit(isa.mov_r(23, 0))
    a.emit(isa.mov_r(0, 23))
    a.emit(isa.mov_r(1, 21))
    a.emit(*isa.mov_imm48(2, L.PROC_WORDS * 8))
    a.bl_to("libc.so:read")
    a.emit(isa.mov_r(0, 23))
    a.bl_to("libc.so:close")
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    a.emit(isa.ldr_imm(20, 21))                      # proc word 0: virt pid
    a.emit(isa.movz(10, L.SCRATCH & 0xFFFF), isa.movk(10, L.SCRATCH >> 16, 1))
    a.emit(isa.str_imm(20, 10))
    _exit0(a)
    return a


def bad_fd_probe() -> Asm:
    """Errno paths: read(9) on a never-opened fd, then openat of a missing
    name without O_CREAT.  With the kernel personality on the returns are
    -EBADF and -ENOENT; they land at SCRATCH and SCRATCH+8.  (Legacy lanes
    see the stub semantics instead: a stream read and openat -> 3.)"""
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(21, L.HEAP_BASE))
    a.emit(isa.movz(0, 9))
    a.emit(isa.mov_r(1, 21))
    a.emit(isa.movz(2, 64))
    a.bl_to("libc.so:read")
    a.emit(isa.mov_r(20, 0))
    a.emit(*isa.mov_imm48(24, L.HEAP_BASE + 2048))
    _store_path(a, 24, 25, b"no-such")
    a.emit(isa.movz(0, 0))
    a.emit(isa.mov_r(1, 24))
    a.emit(isa.movz(2, 0))
    _raw(a, L.SYS_OPENAT)
    a.emit(isa.mov_r(22, 0))
    a.emit(isa.movz(10, L.SCRATCH & 0xFFFF), isa.movk(10, L.SCRATCH >> 16, 1))
    a.emit(isa.str_imm(20, 10))
    a.emit(isa.str_imm(22, 10, 8))
    _exit0(a)
    return a


def indirect_svc(n: int = 2) -> Asm:
    """Figure 4: ``blr`` straight onto the (rewritten) svc inside getpid.

    The caller supplies x8 = __NR_getpid itself — exactly the pattern where
    only the second replacement instruction executes.
    """
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(19, n))
    a.mov48_sym(9, "libc.so:getpid", delta=4)  # address of the svc itself
    a.label("loop")
    a.emit(isa.movz(8, L.SYS_GETPID, sf=0))    # caller-side x8 assignment
    a.emit(isa.blr(9))
    a.emit(isa.mov_r(20, 0))
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    a.emit(isa.movz(10, L.SCRATCH & 0xFFFF), isa.movk(10, L.SCRATCH >> 16, 1))
    a.emit(isa.str_imm(20, 10))
    _exit0(a)
    return a


def unknown_svc(n: int = 4, nr: int = 181) -> Asm:
    """``n`` calls of an *unmodelled* syscall number (default 181, chown on
    arm64): every one falls through the modelled kernel's dispatch to
    -ENOSYS.  Exercises the ``enosys_count`` statistic and the trace
    subsystem's UNKNOWN verdict."""
    from .opspec import TRACE_SYS  # the modelled set; guard tracks it
    assert nr not in TRACE_SYS, f"{nr} is a modelled syscall"
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(19, n))
    a.label("loop")
    a.emit(isa.movz(8, nr, sf=0))
    a.bl_to("libc.so:raw_svc")
    a.emit(isa.mov_r(20, 0))      # keep the -ENOSYS for verification
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    a.emit(isa.movz(10, L.SCRATCH & 0xFFFF), isa.movk(10, L.SCRATCH >> 16, 1))
    a.emit(isa.str_imm(20, 10))
    _exit0(a)
    return a


def syscall_storm_param() -> Asm:
    """Register-parameterised noisy neighbor: hammers svc at a configurable
    rate.  Per-lane arguments (one shared image for a whole storm fleet):

    * ``x19`` — outer iterations;
    * ``x20`` — svc burst per iteration (raw getpid syscalls, caller-side
      x8 assignment like :func:`caller_x8`);
    * ``x21`` — burn-loop iterations per outer iteration (~2 cycles each).

    ``x20=burst, x21=0`` is a pure syscall flood; raising ``x21`` dials
    the svc density down to any victim-like mix.  Used by the policy
    scheduler benchmark/tests (budget exhaustion, deny-rate eviction,
    DENY-storm tenants) — see :mod:`repro.sched`.
    """
    a = Asm(APP_BASE)
    a.label("main")
    a.label("outer")
    a.emit(isa.mov_r(23, 20))
    a.cbz_to(23, "burn")
    a.label("burst")
    a.emit(isa.movz(8, L.SYS_GETPID, sf=0))
    a.bl_to("libc.so:raw_svc")
    a.emit(isa.subsi(23, 23, 1))
    a.b_to("burst", cond="ne")
    a.label("burn")
    a.emit(isa.mov_r(24, 21))
    a.cbz_to(24, "next")
    a.label("spin")
    a.emit(isa.subsi(24, 24, 1))
    a.b_to("spin", cond="ne")
    a.label("next")
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("outer", cond="ne")
    _exit0(a)
    return a


def retry_loop(retries: int = 3) -> Asm:
    """Strategy C2: libc's retry_svc has a direct back-edge onto its svc."""
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(isa.movz(19, retries))
    a.bl_to("libc.so:retry_svc")
    a.emit(isa.movz(10, L.SCRATCH & 0xFFFF), isa.movk(10, L.SCRATCH >> 16, 1))
    a.emit(isa.str_imm(0, 10))
    _exit0(a)
    return a


def caller_x8(n: int = 4) -> Asm:
    """Strategy C1: raw_svc has no x8 assignment in its preceding window."""
    a = Asm(APP_BASE)
    a.label("main")
    a.emit(*isa.mov_imm48(19, n))
    a.label("loop")
    a.emit(isa.movz(8, L.SYS_GETPID, sf=0))
    a.bl_to("libc.so:raw_svc")
    a.emit(isa.mov_r(20, 0))
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("loop", cond="ne")
    a.emit(isa.movz(10, L.SCRATCH & 0xFFFF), isa.movk(10, L.SCRATCH >> 16, 1))
    a.emit(isa.str_imm(20, 10))
    _exit0(a)
    return a
