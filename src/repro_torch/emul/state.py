"""Guest-kernel carry: the layout of MachineState's ``k_`` leaves (PyTorch port).

The guest-kernel emulation state rides as flat ``k_``-prefixed int64
leaves of :class:`repro_torch.core.machine.MachineState`, exactly as in
the JAX package, so both packages carry the same 34 leaves.  This module
owns their layout, the fresh (preopened) values and the typed
:class:`KernelState` view; :mod:`repro_torch.emul.engine` is the service
that updates them.

Shapes (``B`` = lane count; scalar states drop the leading axis):

* ``k_fd_ofd [B, MAX_FDS]`` — fd -> OFD id, -1 = free slot.
* ``k_ofd_* [B, MAX_FDS]`` — OFD rows: kind, inode, byte offset, open
  flags, refcount.
* ``k_ino_* [B, MAX_INODES]`` — inode rows: kind, name key, size in bytes.
* ``k_ino_data [B, MAX_INODES * FILE_WORDS]`` — one flat data plane per
  lane.

Fds 0..3 are preopened: 0 and 3 as the modelled input stream, 1 and 2 as
the modelled output sink.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import layout as L

I64 = torch.int64

# -- fd / OFD kinds ----------------------------------------------------------
FD_FREE = 0
FD_RSTREAM = 1   # legacy modelled input stream (read fills 8*j pattern)
FD_WSINK = 2     # legacy modelled output sink (write sums into out_sum)
FD_FILE = 3      # regular in-memory file (inode-backed)
FD_PROC = 4      # synthetic /proc view rendered from live lane counters
FD_PIPE_R = 5    # read end of a pipe2 pair
FD_PIPE_W = 6    # write end of a pipe2 pair
FD_DEV = 7       # /dev/asc control device (ioctl surface)

# -- inode kinds -------------------------------------------------------------
INO_FREE = 0
INO_FILE = 1
INO_PIPE = 2

# -- errnos returned by the emulated surface ---------------------------------
ENOENT = 2
EBADF = 9
EAGAIN = 11
EFAULT = 14
EEXIST = 17
EINVAL = 22
ENFILE = 23
EMFILE = 24
ENOTTY = 25
EFBIG = 27
ENOSPC = 28
ESPIPE = 29
ENOSYS = 38

ERRNOS = {
    "ENOENT": ENOENT, "EBADF": EBADF, "EAGAIN": EAGAIN, "EFAULT": EFAULT,
    "EEXIST": EEXIST, "EINVAL": EINVAL, "ENFILE": ENFILE, "EMFILE": EMFILE,
    "ENOTTY": ENOTTY, "EFBIG": EFBIG, "ENOSPC": ENOSPC, "ESPIPE": ESPIPE,
    "ENOSYS": ENOSYS,
}

# -- path namespace ----------------------------------------------------------
# A path is identified by its first 8 bytes packed little-endian into one
# int64 (what the one-word path read in the executor sees).  Two prefixes
# select synthetic objects; everything else names a regular file.
PROC_KEY = int.from_bytes(b"/proc/se", "little")   # /proc/self/* window
DEV_KEY = int.from_bytes(b"/dev/asc", "little")    # the ioctl device


def path_key(path: bytes) -> int:
    """The int64 name key for a path (first 8 bytes, zero padded)."""
    return int.from_bytes(path[:8].ljust(8, b"\0"), "little")


# -- ioctl requests on FD_DEV ------------------------------------------------
ASC_IOCTL_ICOUNT = 1    # retired instruction count of the calling lane
ASC_IOCTL_HOOKS = 2     # tracer-side hook invocations (ptrace mode)
ASC_IOCTL_PID = 3       # the simulated pid

# fstat(2) result layout: 4 words written to the statbuf
STAT_WORDS = 4          # [ofd kind, inode id, size bytes, nlink=1]

# Preopened fd table (see module docstring): fd -> OFD, one OFD per fd.
_PREOPEN_KINDS = (FD_RSTREAM, FD_WSINK, FD_WSINK, FD_RSTREAM)
N_PREOPEN = len(_PREOPEN_KINDS)

KERN_FIELDS = ("k_enabled", "k_rng", "k_fd_ofd", "k_ofd_kind", "k_ofd_ino",
               "k_ofd_off", "k_ofd_flags", "k_ofd_ref", "k_ino_kind",
               "k_ino_name", "k_ino_size", "k_ino_data")


class KernelState(NamedTuple):
    """The typed view over MachineState's ``k_`` leaves (same order as
    :data:`KERN_FIELDS`)."""

    enabled: torch.Tensor
    rng: torch.Tensor
    fd_ofd: torch.Tensor
    ofd_kind: torch.Tensor
    ofd_ino: torch.Tensor
    ofd_off: torch.Tensor
    ofd_flags: torch.Tensor
    ofd_ref: torch.Tensor
    ino_kind: torch.Tensor
    ino_name: torch.Tensor
    ino_size: torch.Tensor
    ino_data: torch.Tensor


def kern_of(s) -> KernelState:
    """Project a MachineState (scalar or batched) to its KernelState."""
    return KernelState(*(getattr(s, f) for f in KERN_FIELDS))


def with_kern(s, k: KernelState):
    """A MachineState with its ``k_`` leaves replaced from ``k``."""
    return s._replace(**dict(zip(KERN_FIELDS, k)))


def _preopen_np(n: int):
    """Host-side preopened tables for ``n`` lanes (numpy, to be wrapped)."""
    fd_ofd = np.full((n, L.MAX_FDS), -1, np.int64)
    ofd_kind = np.zeros((n, L.MAX_FDS), np.int64)
    ofd_ref = np.zeros((n, L.MAX_FDS), np.int64)
    for fd, kind in enumerate(_PREOPEN_KINDS):
        fd_ofd[:, fd] = fd
        ofd_kind[:, fd] = kind
        ofd_ref[:, fd] = 1
    return fd_ofd, ofd_kind, ofd_ref


def fresh_kern(n: int, *, enabled: bool = True, device="cpu") -> dict:
    """Batched fresh guest-kernel leaves for ``n`` lanes on ``device``, as
    the kwargs of a MachineState constructor / ``_replace``.  Every buffer
    is fresh (no aliasing between leaves — the fleet drivers update the
    carry in place)."""
    fd_ofd, ofd_kind, ofd_ref = _preopen_np(n)
    zf = lambda: torch.zeros((n, L.MAX_FDS), dtype=I64, device=device)
    zi = lambda: torch.zeros((n, L.MAX_INODES), dtype=I64, device=device)
    return dict(
        k_enabled=torch.full((n,), 1 if enabled else 0, dtype=I64,
                             device=device),
        k_rng=torch.zeros((n,), dtype=I64, device=device),
        k_fd_ofd=torch.as_tensor(fd_ofd).to(device),
        k_ofd_kind=torch.as_tensor(ofd_kind).to(device),
        k_ofd_ino=zf(),
        k_ofd_off=zf(),
        k_ofd_flags=zf(),
        k_ofd_ref=torch.as_tensor(ofd_ref).to(device),
        k_ino_kind=zi(),
        k_ino_name=zi(),
        k_ino_size=zi(),
        k_ino_data=torch.zeros((n, L.MAX_INODES * L.FILE_WORDS), dtype=I64,
                               device=device),
    )


def fresh_kern_scalar(*, enabled: bool = True, device="cpu") -> dict:
    """Scalar (unbatched) fresh guest-kernel leaves for ``make_state``."""
    batched = fresh_kern(1, enabled=enabled, device=device)
    return {k: v[0].clone() for k, v in batched.items()}
