"""The batched guest-kernel step: fd-table syscall service + data mover
(PyTorch port of the JAX package's ``repro.emul.engine``).

Called from the executor body (:func:`repro_torch.core.fleet.exec_lanes`),
so the plain PyTorch step inherits every emulated syscall from this one
implementation; the CUDA megastep kernel carries the same arithmetic per
lane (``kernels/megastep/csrc/megastep.cu``).

The work is split in two, as in the JAX package:

* :func:`service` — the control plane: resolve fds through the per-lane
  tables, compute every errno and return value, and produce the updated
  small ``k_*`` leaves plus routing vectors for the bulk data movement.
* :func:`run_data_loop` — the data plane: move up to FILE_WORDS words per
  lane between guest memory, the inode data plane, the synthetic /proc
  window and the getrandom stream, in W_KIO-word windows.

Every tensor lives on the device of the state it is given.  Index
arithmetic is the JAX package's: gathers clip the index first, and scatter
indices past the end of a plane are dropped (torch has no ``mode="drop"``,
so only the live entries are written).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import layout as L
from .state import (ASC_IOCTL_HOOKS, ASC_IOCTL_ICOUNT, ASC_IOCTL_PID,
                    DEV_KEY, EAGAIN, EBADF, EEXIST, EFAULT, EFBIG, EINVAL,
                    EMFILE, ENFILE, ENOENT, ENOSPC, ENOTTY, ESPIPE, FD_DEV,
                    FD_FILE, FD_FREE, FD_PIPE_R, FD_PIPE_W, FD_PROC,
                    FD_RSTREAM, FD_WSINK, INO_FILE, INO_FREE, INO_PIPE,
                    PROC_KEY, STAT_WORDS, KernelState, kern_of)

I64 = torch.int64

_IPL = L.MAX_INODES * L.FILE_WORDS   # inode data words per lane


def _signed(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


# splitmix64 finalizer constants (uint64 arithmetic, carried in int64)
_SM_GAMMA = _signed(0x9E3779B97F4A7C15)
_SM_M1 = _signed(0xBF58476D1CE4E5B9)
_SM_M2 = _signed(0x94D049BB133111EB)


def _lsr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """Deterministic 64-bit mix of an int64 counter — the getrandom
    stream.  The low 64 bits of an int64 product equal the uint64 one, so
    only the right shifts need masking."""
    z = x * _SM_GAMMA
    z = (z ^ _lsr(z, 30)) * _SM_M1
    z = (z ^ _lsr(z, 27)) * _SM_M2
    return z ^ _lsr(z, 31)


def select(pairs, default):
    """``jnp.select``: the value of the FIRST true condition per lane.  A
    ``torch.where`` chain reaches that by applying the pairs in reverse."""
    out = default
    for cond, val in reversed(pairs):
        out = torch.where(cond, val, out)
    return out


def _mem_ok(addr):
    return (addr >= L.DATA_BASE) & (addr < L.MEM_LIMIT) & ((addr & 7) == 0)


def _widx(addr):
    return ((addr - L.DATA_BASE) >> 3).clamp(0, L.MEM_WORDS - 1)


def _take(tab, idx):
    """Row-wise gather: ``tab[b, idx[b]]`` with idx pre-clipped."""
    return torch.gather(tab, 1, idx[:, None]).squeeze(1)


def _onehot(idx, width):
    return torch.arange(width, device=idx.device)[None, :] == idx[:, None]


def _first(m):
    """Index of the first true entry per row; 0 for an all-false row (the
    behaviour of ``jnp.argmax`` the tables rely on)."""
    return torch.argmax(m.to(torch.int8), dim=1)


def _setcol(tab, mask, idx, val):
    """``tab[b, idx[b]] = val[b]`` where ``mask[b]`` (one-hot where)."""
    hit = _onehot(idx, tab.shape[1]) & mask[:, None]
    if not isinstance(val, torch.Tensor):
        val = torch.full(mask.shape, val, dtype=tab.dtype, device=tab.device)
    return torch.where(hit, val[:, None], tab)


class EmulEffects(NamedTuple):
    """Everything :func:`service` hands back to the executor."""

    kern: KernelState        # updated small k_* leaves (ino_data untouched)
    ret: torch.Tensor        # [B] return value for emul-serviced lanes
    is_ret: torch.Tensor     # [B] lanes whose x0 comes from ``ret``
    served: torch.Tensor     # [B] lanes serviced by the guest kernel
    rd_stream: torch.Tensor  # [B] reads taking the legacy stream path
    wr_stream: torch.Tensor  # [B] writes taking the legacy sink path
    # bulk data-mover routing (consumed by run_data_loop)
    fio_do: torch.Tensor     # [B] lanes with words to move
    nw: torch.Tensor         # [B] words to move
    mem_base: torch.Tensor   # [B] absolute word index into mem_flat
    ino_base: torch.Tensor   # [B] absolute word index into ino_flat
    dst_is_mem: torch.Tensor  # [B] True: fill guest memory; False: inode data
    src_is_ino: torch.Tensor  # [B] source select (exactly one on fio lanes
    src_is_proc: torch.Tensor  # [B]  with dst_is_mem; writes source memory)
    src_is_rand: torch.Tensor  # [B]
    proc_base: torch.Tensor  # [B] absolute word index into proc_flat
    rng0: torch.Tensor       # [B] getrandom counter before this call
    # small guest-memory writes (fstat statbuf + pipe2 fd pair)
    scat_do: torch.Tensor    # [B] any lane writing result words
    scat_idx: torch.Tensor   # [6B] mem_flat indices (parked when unused)
    scat_val: torch.Tensor   # [6B] values


def neutral(s, sys_read, sys_write) -> EmulEffects:
    """The no-emulated-syscall step: legacy routing, nothing changes.
    Bit-identical to :func:`service` on a batch where no lane executes an
    emulated operation and no enabled lane reads or writes."""
    B = s.pc.shape[0]
    dev = s.pc.device
    zb = torch.zeros((B,), dtype=torch.bool, device=dev)
    z = torch.zeros((B,), dtype=I64, device=dev)
    return EmulEffects(
        kern=kern_of(s), ret=z, is_ret=zb, served=zb,
        rd_stream=sys_read, wr_stream=sys_write,
        fio_do=zb, nw=z, mem_base=z, ino_base=z, dst_is_mem=zb,
        src_is_ino=zb, src_is_proc=zb, src_is_rand=zb, proc_base=z,
        rng0=s.k_rng, scat_do=zb,
        scat_idx=L.MEM_WORDS * B + torch.arange(6 * B, dtype=I64, device=dev),
        scat_val=torch.zeros((6 * B,), dtype=I64, device=dev))


def service(s, *, en, x0, x1, x2, path_w, io_ok, io_n,
            sys_open, sys_close, sys_lseek, sys_dup, sys_fstat, sys_pipe,
            sys_rand, sys_ioctl, sys_read, sys_write) -> EmulEffects:
    """One guest-kernel step over the batch.

    ``sys_*`` masks are already gated on the executing-svc mask and (for
    the emulated families) on ``k_enabled``; ``sys_read``/``sys_write``
    are the raw I/O masks (enabled and legacy lanes both).  ``path_w`` is
    the first path word, read from the pre-store memory; ``io_ok``/``io_n``
    the legacy buffer check and byte count.
    """
    B = s.pc.shape[0]
    dev = s.pc.device
    k = kern_of(s)
    lanes = torch.arange(B, dtype=I64, device=dev)
    zero = torch.zeros((B,), dtype=I64, device=dev)
    lane_mem = lanes * L.MEM_WORDS
    lane_ino = lanes * _IPL
    lane_proc = lanes * L.PROC_WORDS

    def full(v):
        return torch.full((B,), v, dtype=I64, device=dev)

    # -- fd resolution (shared by close/dup/lseek/fstat/ioctl/read/write) --
    fd = x0
    fd_inr = (fd >= 0) & (fd < L.MAX_FDS)
    fdc = fd.clamp(0, L.MAX_FDS - 1)
    ofd = _take(k.fd_ofd, fdc)
    fd_valid = fd_inr & (ofd >= 0)
    ofdc = ofd.clamp(0, L.MAX_FDS - 1)
    okind = _take(k.ofd_kind, ofdc)
    oino = _take(k.ofd_ino, ofdc)
    ooff = _take(k.ofd_off, ofdc)
    oflags = _take(k.ofd_flags, ofdc)
    oref = _take(k.ofd_ref, ofdc)
    inoc = oino.clamp(0, L.MAX_INODES - 1)
    isize = _take(k.ino_size, inoc)

    # -- free-slot scans (argmax of an all-false row is 0) ------------------
    free_fd_m = k.fd_ofd < 0
    n_free_fd = free_fd_m.sum(1)
    fd_a = _first(free_fd_m)
    fd_b = _first(free_fd_m & ~_onehot(fd_a, L.MAX_FDS))
    free_ofd_m = k.ofd_kind == FD_FREE
    n_free_ofd = free_ofd_m.sum(1)
    ofd_a = _first(free_ofd_m)
    ofd_b = _first(free_ofd_m & ~_onehot(ofd_a, L.MAX_FDS))
    free_ino_m = k.ino_kind == INO_FREE
    has_ino = free_ino_m.any(1)
    ino_a = _first(free_ino_m)

    # -- openat(dirfd, path, flags) -----------------------------------------
    pvalid = _mem_ok(x1)
    name = path_w
    is_proc = name == PROC_KEY
    is_dev = name == DEV_KEY
    is_file = ~is_proc & ~is_dev
    fmatch = (k.ino_kind == INO_FILE) & (k.ino_name == name[:, None])
    exists = fmatch.any(1)
    ino_hit = _first(fmatch)
    o_creat = (x2 & L.O_CREAT) != 0
    o_excl = (x2 & L.O_EXCL) != 0
    o_trunc = (x2 & L.O_TRUNC) != 0
    need_create = is_file & ~exists
    open_err = select(
        [(~pvalid, full(-EFAULT)),
         (is_file & ~exists & ~o_creat, full(-ENOENT)),
         (is_file & exists & o_creat & o_excl, full(-EEXIST)),
         (n_free_fd < 1, full(-EMFILE)),
         (n_free_ofd < 1, full(-ENFILE)),
         (need_create & ~has_ino, full(-ENOSPC))],
        zero)
    open_ok = sys_open & (open_err == 0)
    open_ino = torch.where(need_create, ino_a, ino_hit)
    open_kind = select([(is_proc, full(FD_PROC)), (is_dev, full(FD_DEV))],
                        full(FD_FILE))
    ret_open = torch.where(open_ok, fd_a, open_err)
    do_create = open_ok & need_create
    do_trunc = open_ok & is_file & exists & o_trunc

    # -- close(fd) / dup(fd) -------------------------------------------------
    close_ok = sys_close & fd_valid
    ret_close = torch.where(fd_valid, zero, full(-EBADF))
    free_ofd_now = close_ok & (oref <= 1)

    dup_ok = sys_dup & fd_valid & (n_free_fd >= 1)
    ret_dup = select([(~fd_valid, full(-EBADF)),
                       (n_free_fd < 1, full(-EMFILE))], fd_a)

    # -- lseek(fd, off, whence) ----------------------------------------------
    whence_ok = (x2 >= L.SEEK_SET) & (x2 <= L.SEEK_END)
    seek_new = select([(x2 == L.SEEK_SET, x1), (x2 == L.SEEK_CUR, ooff + x1)],
                       isize + x1)
    seek_err = select(
        [(~fd_valid, full(-EBADF)), (okind != FD_FILE, full(-ESPIPE)),
         (~whence_ok, full(-EINVAL)), (seek_new < 0, full(-EINVAL))],
        zero)
    seek_ok = sys_lseek & (seek_err == 0)
    ret_seek = torch.where(seek_ok, seek_new, seek_err)

    # -- fstat(fd, statbuf): STAT_WORDS result words --------------------------
    sbuf_ok = _mem_ok(x1) & (x1 + STAT_WORDS * 8 <= L.MEM_LIMIT)
    stat_size = select(
        [(okind == FD_PROC, full(L.PROC_WORDS * 8)),
         ((okind == FD_PIPE_R) | (okind == FD_PIPE_W) | (okind == FD_FILE),
          isize)], zero)
    stat_err = select([(~fd_valid, full(-EBADF)), (~sbuf_ok, full(-EFAULT))],
                       zero)
    stat_ok = sys_fstat & (stat_err == 0)
    ret_stat = torch.where(stat_ok, zero, stat_err)

    # -- pipe2(pipefd, flags): 2 fds + 2 OFDs + 1 pipe inode -----------------
    pbuf_ok = _mem_ok(x0) & (x0 + 16 <= L.MEM_LIMIT)
    pipe_err = select(
        [(x1 != 0, full(-EINVAL)), (~pbuf_ok, full(-EFAULT)),
         (n_free_fd < 2, full(-EMFILE)), (n_free_ofd < 2, full(-ENFILE)),
         (~has_ino, full(-ENOSPC))],
        zero)
    pipe_ok = sys_pipe & (pipe_err == 0)
    ret_pipe = torch.where(pipe_ok, zero, pipe_err)

    # -- getrandom(buf, len, flags): short-reads to FILE_BYTES ----------------
    rand_n = x1.clamp(0, L.FILE_BYTES)
    rand_err = select(
        [((x1 < 0) | ((x1 & 7) != 0), full(-EINVAL)),
         (~(_mem_ok(x0) & (x0 + rand_n <= L.MEM_LIMIT)), full(-EFAULT))],
        zero)
    rand_ok = sys_rand & (rand_err == 0)
    ret_rand = torch.where(rand_ok, rand_n, rand_err)

    # -- ioctl(fd, req, arg): the FD_DEV control surface ----------------------
    ioctl_val = select(
        [(x1 == ASC_IOCTL_ICOUNT, s.icount), (x1 == ASC_IOCTL_HOOKS,
                                              s.hook_count),
         (x1 == ASC_IOCTL_PID, s.pid)],
        full(-EINVAL))
    ret_ioctl = select([(~fd_valid, full(-EBADF)),
                         (okind != FD_DEV, full(-ENOTTY))], ioctl_val)

    # -- read/write routing: stream (legacy), data (file/proc/pipe), dev -----
    rd_stream = (sys_read & ~en) | (sys_read & en & fd_valid
                                    & (okind == FD_RSTREAM))
    wr_stream = (sys_write & ~en) | (sys_write & en & fd_valid
                                     & (okind == FD_WSINK))
    rd_en = sys_read & en
    wr_en = sys_write & en

    rd_data = rd_en & fd_valid & ((okind == FD_FILE) | (okind == FD_PROC)
                                  | (okind == FD_PIPE_R))
    rd_dev = rd_en & fd_valid & (okind == FD_DEV)
    rd_bad = rd_en & ~(rd_stream | rd_data | rd_dev)

    src_size = select([(okind == FD_PROC, full(L.PROC_WORDS * 8)),
                        (okind == FD_FILE, isize)], isize)
    off_align = (ooff & 7) == 0
    rd_err = select([(~io_ok, full(-EFAULT)), (~off_align, full(-EINVAL))],
                     zero)
    rd_n = torch.minimum(io_n, src_size - ooff).clamp(min=0)
    rd_data_ok = rd_data & (rd_err == 0)
    ret_read = torch.where(rd_data, torch.where(rd_err == 0, rd_n, rd_err),
                           torch.where(rd_dev, zero, full(-EBADF)))

    wr_data = wr_en & fd_valid & ((okind == FD_FILE) | (okind == FD_PIPE_W))
    wr_dev = wr_en & fd_valid & (okind == FD_DEV)
    wr_bad = wr_en & ~(wr_stream | wr_data | wr_dev)

    w_is_pipe = okind == FD_PIPE_W
    w_off = torch.where(w_is_pipe, isize,
                        torch.where((oflags & L.O_APPEND) != 0, isize, ooff))
    w_end = w_off + io_n
    wr_err = select(
        [(~io_ok, full(-EFAULT)),
         ((w_off & 7) != 0, full(-EINVAL)),
         (w_is_pipe & (w_end > L.FILE_BYTES), full(-EAGAIN)),
         (~w_is_pipe & (w_end > L.FILE_BYTES), full(-EFBIG))],
        zero)
    wr_data_ok = wr_data & (wr_err == 0)
    dev_err = torch.where(io_ok, io_n, full(-EFAULT))
    ret_write = torch.where(wr_data, torch.where(wr_err == 0, io_n, wr_err),
                            torch.where(wr_dev, dev_err, full(-EBADF)))

    # -- combined return value + masks ---------------------------------------
    rd_any = rd_data | rd_dev | rd_bad
    wr_any = wr_data | wr_dev | wr_bad
    is_ret = (sys_open | sys_close | sys_lseek | sys_dup | sys_fstat
              | sys_pipe | sys_rand | sys_ioctl | rd_any | wr_any)
    ret = select(
        [(sys_open, ret_open), (sys_close, ret_close), (sys_dup, ret_dup),
         (sys_lseek, ret_seek), (sys_fstat, ret_stat), (sys_pipe, ret_pipe),
         (sys_rand, ret_rand), (sys_ioctl, ret_ioctl),
         (rd_any, ret_read), (wr_any, ret_write)],
        zero)
    served = is_ret | (rd_stream & en) | (wr_stream & en)

    # -- table updates (one syscall per lane => row-disjoint one-hot writes) --
    fd_tab = k.fd_ofd
    fd_tab = _setcol(fd_tab, open_ok, fd_a, ofd_a)
    fd_tab = _setcol(fd_tab, close_ok, fdc, -1)
    fd_tab = _setcol(fd_tab, dup_ok, fd_a, ofd)
    fd_tab = _setcol(fd_tab, pipe_ok, fd_a, ofd_a)
    fd_tab = _setcol(fd_tab, pipe_ok, fd_b, ofd_b)

    okind_t = k.ofd_kind
    okind_t = _setcol(okind_t, open_ok, ofd_a, open_kind)
    okind_t = _setcol(okind_t, free_ofd_now, ofdc, FD_FREE)
    okind_t = _setcol(okind_t, pipe_ok, ofd_a, FD_PIPE_R)
    okind_t = _setcol(okind_t, pipe_ok, ofd_b, FD_PIPE_W)

    oino_t = k.ofd_ino
    oino_t = _setcol(oino_t, open_ok, ofd_a, open_ino)
    oino_t = _setcol(oino_t, free_ofd_now, ofdc, 0)
    oino_t = _setcol(oino_t, pipe_ok, ofd_a, ino_a)
    oino_t = _setcol(oino_t, pipe_ok, ofd_b, ino_a)

    adv_rd = rd_data_ok
    adv_off = torch.where(adv_rd, ooff + rd_n, zero)
    wr_adv = wr_data_ok & ~w_is_pipe      # pipe writes track ino_size only
    ooff_t = k.ofd_off
    ooff_t = _setcol(ooff_t, open_ok, ofd_a, 0)
    ooff_t = _setcol(ooff_t, free_ofd_now, ofdc, 0)
    ooff_t = _setcol(ooff_t, pipe_ok, ofd_a, 0)
    ooff_t = _setcol(ooff_t, pipe_ok, ofd_b, 0)
    ooff_t = _setcol(ooff_t, seek_ok, ofdc, seek_new)
    ooff_t = _setcol(ooff_t, adv_rd, ofdc, adv_off)
    ooff_t = _setcol(ooff_t, wr_adv, ofdc, w_end)

    oflags_t = k.ofd_flags
    oflags_t = _setcol(oflags_t, open_ok, ofd_a, x2)
    oflags_t = _setcol(oflags_t, free_ofd_now, ofdc, 0)
    oflags_t = _setcol(oflags_t, pipe_ok, ofd_a, 0)
    oflags_t = _setcol(oflags_t, pipe_ok, ofd_b, 0)

    oref_t = k.ofd_ref
    oref_t = _setcol(oref_t, open_ok, ofd_a, 1)
    oref_t = _setcol(oref_t, close_ok, ofdc, (oref - 1).clamp(min=0))
    oref_t = _setcol(oref_t, dup_ok, ofdc, oref + 1)
    oref_t = _setcol(oref_t, pipe_ok, ofd_a, 1)
    oref_t = _setcol(oref_t, pipe_ok, ofd_b, 1)

    ikind_t = k.ino_kind
    ikind_t = _setcol(ikind_t, do_create, ino_a, INO_FILE)
    ikind_t = _setcol(ikind_t, pipe_ok, ino_a, INO_PIPE)

    iname_t = k.ino_name
    iname_t = _setcol(iname_t, do_create, ino_a, name)
    iname_t = _setcol(iname_t, pipe_ok, ino_a, 0)

    isize_t = k.ino_size
    isize_t = _setcol(isize_t, do_create, ino_a, 0)
    isize_t = _setcol(isize_t, do_trunc, ino_hit, 0)
    isize_t = _setcol(isize_t, pipe_ok, ino_a, 0)
    isize_t = _setcol(isize_t, wr_data_ok, inoc,
                      torch.where(w_is_pipe, w_end,
                                  torch.maximum(isize, w_end)))

    rng_t = k.rng + torch.where(rand_ok, rand_n >> 3, zero)

    # -- data-mover routing ---------------------------------------------------
    rd_words = rd_n >> 3
    wr_words = torch.where(wr_data_ok, io_n >> 3, zero)
    rand_words = torch.where(rand_ok, rand_n >> 3, zero)
    nw = select([(rd_data_ok, rd_words), (wr_data_ok, wr_words),
                  (rand_ok, rand_words)], zero)
    fio_do = ((rd_data_ok & (rd_words > 0)) | (wr_data_ok & (wr_words > 0))
              | (rand_ok & (rand_words > 0)))
    dst_is_mem = rd_data_ok | rand_ok
    buf = torch.where(sys_rand, x0, x1)
    mem_base = lane_mem + _widx(buf)
    data_off_w = torch.where(wr_data, w_off, ooff) >> 3
    ino_base = (lane_ino + inoc * L.FILE_WORDS
                + data_off_w.clamp(0, L.FILE_WORDS - 1))
    src_is_proc = rd_data_ok & (okind == FD_PROC)
    src_is_ino = rd_data_ok & ~src_is_proc
    src_is_rand = rand_ok
    proc_base = lane_proc + data_off_w.clamp(0, L.PROC_WORDS - 1)

    # -- result-word scatter (fstat statbuf / pipe2 fd pair), parked off ------
    park = L.MEM_WORDS * B + torch.arange(6 * B, dtype=I64, device=dev)
    sbase = lane_mem + _widx(x1)
    pbase = lane_mem + _widx(x0)

    def col(m, idx, j):
        return torch.where(m, idx, park[j * B:(j + 1) * B])

    scat_idx = torch.cat([col(stat_ok, sbase, 0), col(stat_ok, sbase + 1, 1),
                          col(stat_ok, sbase + 2, 2),
                          col(stat_ok, sbase + 3, 3),
                          col(pipe_ok, pbase, 4), col(pipe_ok, pbase + 1, 5)])
    scat_val = torch.cat([okind, oino, stat_size, torch.ones_like(zero),
                          fd_a, fd_b])
    scat_do = stat_ok | pipe_ok

    kern = KernelState(
        enabled=k.enabled, rng=rng_t, fd_ofd=fd_tab, ofd_kind=okind_t,
        ofd_ino=oino_t, ofd_off=ooff_t, ofd_flags=oflags_t, ofd_ref=oref_t,
        ino_kind=ikind_t, ino_name=iname_t, ino_size=isize_t,
        ino_data=k.ino_data)
    return EmulEffects(
        kern=kern, ret=ret, is_ret=is_ret, served=served,
        rd_stream=rd_stream, wr_stream=wr_stream,
        fio_do=fio_do, nw=nw, mem_base=mem_base, ino_base=ino_base,
        dst_is_mem=dst_is_mem, src_is_ino=src_is_ino,
        src_is_proc=src_is_proc, src_is_rand=src_is_rand,
        proc_base=proc_base, rng0=k.rng, scat_do=scat_do,
        scat_idx=scat_idx, scat_val=scat_val)


def proc_rows(s) -> torch.Tensor:
    """The synthetic /proc window, [B, PROC_WORDS]: live lane counters
    rendered as one word each.  Word 0 mirrors getpid-level
    virtualisation from ``virt_getpid`` alone."""
    vpid = torch.where(s.virt_getpid != 0,
                       torch.full_like(s.pid, L.VIRT_PID), s.pid)
    cols = [vpid, s.icount, s.cycles, s.hook_count, s.enosys_count,
            s.emul_served, s.in_off, s.out_count, s.out_sum, s.fuel]
    body = torch.stack(cols, dim=1)
    pad = torch.zeros((s.pc.shape[0], L.PROC_WORDS - len(cols)), dtype=I64,
                      device=s.pc.device)
    return torch.cat([body, pad], dim=1)


W_KIO = 128   # data-mover window: ceil(max nw / W_KIO) windows per step


def run_data_loop(mem_flat, ino_flat, proc_flat, eff: EmulEffects):
    """Move every data lane's words, in W_KIO-word windows, as the JAX
    package does: per window, every lane gathers its sources (indices
    clipped into the whole flat plane), then scatters (indices past the
    plane's end dropped).  ``mem_flat`` and ``ino_flat`` are updated in
    place; returns them."""
    if not bool(eff.fio_do.any()):
        return mem_flat, ino_flat
    B = eff.nw.shape[0]
    W = W_KIO
    dev = mem_flat.device
    woff = torch.arange(W, dtype=I64, device=dev)
    MTOT = B * L.MEM_WORDS
    ITOT = B * _IPL
    PTOT = B * L.PROC_WORDS
    nwin = int(torch.where(eff.fio_do, (eff.nw + W - 1) // W,
                           torch.zeros_like(eff.nw)).max())
    rng = splitmix64(eff.rng0 * 0x10001 + 1)
    to_mem = (eff.fio_do & eff.dst_is_mem)[:, None]
    to_ino = (eff.fio_do & ~eff.dst_is_mem)[:, None]
    for c in range(nwin):
        rel = (c * W + woff)[None, :]                       # [1, W]
        within = rel < eff.nw[:, None]                      # [B, W]
        v_ino = ino_flat[(eff.ino_base[:, None] + rel).clamp(0, ITOT - 1)]
        v_proc = proc_flat[(eff.proc_base[:, None] + rel).clamp(0, PTOT - 1)]
        v_rand = splitmix64(rng[:, None] + rel)
        v = torch.where(eff.src_is_rand[:, None], v_rand,
                        torch.where(eff.src_is_proc[:, None], v_proc, v_ino))
        v_mem = mem_flat[(eff.mem_base[:, None] + rel).clamp(0, MTOT - 1)]
        idx_m = eff.mem_base[:, None] + rel
        idx_i = eff.ino_base[:, None] + rel
        live_m = within & to_mem & (idx_m < MTOT)
        live_i = within & to_ino & (idx_i < ITOT)
        mem_flat[idx_m[live_m]] = v[live_m]
        ino_flat[idx_i[live_i]] = v_mem[live_i]
    return mem_flat, ino_flat
