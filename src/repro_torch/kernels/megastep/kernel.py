"""Build and launch the CUDA megastep kernel (``csrc/megastep.cu``).

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``
(:mod:`repro_torch.kernels.nvcc`: ``build/`` beside this file, named by a
hash of the source, the generated constants header and the flags).

The constants the kernel needs (layout, op-spec classes, halt codes, cost
model, the ``MachineState`` leaf order) are generated into a header from
the Python modules at build time: the kernel has no second copy of them.

Nothing here runs at import time; importing this module needs no card
and no compiler.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from ...core import costmodel as cm
from ...core import layout as L
from ...core import machine as M
from ...core import opspec
from ...core.fleet import REC_WORDS, FleetImages, TraceState
from ...core.isa import Op
from ...core.machine import MachineState
from ...emul import state as emul_state
from ...emul.engine import W_KIO
from .. import nvcc

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "megastep.cu"
BUILD_DIR = _HERE / "build"
DEFAULT_BLOCK = 4  # lanes (one warp each) a block: 500 lanes -> 125 blocks


def consts_header() -> str:
    """The ``megastep_consts.h`` the kernel includes, from the Python
    sources of truth."""
    defs = {
        "CODE_LIMIT": L.CODE_LIMIT, "CODE_WORDS": L.CODE_WORDS,
        "DATA_BASE": L.DATA_BASE, "MEM_LIMIT": L.MEM_LIMIT,
        "MEM_WORDS": L.MEM_WORDS, "SIGFRAME": L.SIGFRAME,
        "SIGSTACK_TOP": L.SIGSTACK_TOP, "VIRT_PID": L.VIRT_PID,
        "SIGFRAME_IDX": M._SIGFRAME_IDX, "MAX_IO_WORDS": 4096,
        "RUNNING": M.RUNNING, "HALT_EXIT": M.HALT_EXIT,
        "HALT_SEGV": M.HALT_SEGV, "HALT_TRAP": M.HALT_TRAP,
        "HALT_BADMEM": M.HALT_BADMEM, "HALT_KILL": M.HALT_KILL,
        "KERNEL_CROSS": cm.KERNEL_CROSS, "PTRACE_STOP": cm.PTRACE_STOP,
        "IO_BYTES_PER_CYCLE": cm.IO_BYTES_PER_CYCLE,
        "SIGNAL_DELIVERY": cm.SIGNAL_DELIVERY,
        "OP_NULLPAGE": int(Op.NULLPAGE), "N_OPS": int(Op.N_OPS),
        "N_SYSCALLS": len(opspec.SYSCALLS),
        "N_LEAVES": len(MachineState._fields),
        "N_TRACE_LEAVES": len(TraceState._fields),
        # the guest-kernel layout (core/layout.py, emul/state.py)
        "MAX_FDS": L.MAX_FDS, "MAX_INODES": L.MAX_INODES,
        "FILE_WORDS": L.FILE_WORDS, "FILE_BYTES": L.FILE_BYTES,
        "PROC_WORDS": L.PROC_WORDS, "W_KIO": W_KIO,
        "O_CREAT": L.O_CREAT, "O_EXCL": L.O_EXCL, "O_TRUNC": L.O_TRUNC,
        "O_APPEND": L.O_APPEND, "SEEK_SET": L.SEEK_SET,
        "SEEK_CUR": L.SEEK_CUR, "SEEK_END": L.SEEK_END,
        "STAT_WORDS": emul_state.STAT_WORDS,
        "PROC_KEY": emul_state.PROC_KEY, "DEV_KEY": emul_state.DEV_KEY,
        # the trace carry (core/fleet.py, core/opspec.py)
        "REC_WORDS": REC_WORDS, "SLOT_UNKNOWN": opspec.SLOT_UNKNOWN,
        "N_POLICY_SLOTS": opspec.N_POLICY_SLOTS,
        "N_VERDICTS": opspec.N_VERDICTS,
        "VERDICT_UNKNOWN": opspec.VERDICT_UNKNOWN,
    }
    for prefix in ("A_", "F_", "M_", "P_", "K_", "POL_"):
        defs.update({k: v for k, v in vars(opspec).items()
                     if k.startswith(prefix) and isinstance(v, int)
                     and not isinstance(v, bool)})
    for prefix in ("FD_", "INO_", "ASC_IOCTL_"):
        defs.update({k: v for k, v in vars(emul_state).items()
                     if k.startswith(prefix) and isinstance(v, int)})
    # errnos under a prefix of their own: <errno.h> may define the names
    defs.update({f"EMUL_{k}": v for k, v in emul_state.ERRNOS.items()})
    defs.update({f"LEAF_{f}": i for i, f in enumerate(MachineState._fields)})
    defs.update({f"TLEAF_{f}": i for i, f in enumerate(TraceState._fields)})
    lines = ["// Generated by repro_torch/kernels/megastep/kernel.py.",
             "#pragma once"]
    lines += [f"#define {k} ((int64_t){v}LL)" if abs(v) > 2**31 - 1
              else f"#define {k} {v}" for k, v in sorted(defs.items())]
    return "\n".join(lines) + "\n"


def build(source: Path = SOURCE) -> tuple[Path, str]:
    """Compile the kernel library if it is not built yet.  Returns the
    library path and the compiler's report (``-Xptxas -v``: registers,
    shared memory, spills; empty when the library was already there).
    ``source`` is another copy of the kernel with the same C interface
    (``scripts/torch_megastep_study.py`` builds an earlier design's)."""
    return nvcc.build("megastep", source, BUILD_DIR,
                      {"megastep_consts.h": consts_header()})


class _Args(ctypes.Structure):
    """Mirror of ``struct MegastepArgs`` in ``csrc/megastep.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "packed", "imm", "ids", "alu", "wb_sp", "wb_lr", "flags", "memc",
        "addr_post", "wb_base", "pcc", "segv", "exit_", "signo", "cost",
        "cond_mask", "sys_nr", "sys_kind", "sys_const", "sys_emul")]
        + [("leaf", ctypes.c_void_p * len(MachineState._fields)),
           ("tleaf", ctypes.c_void_p * len(TraceState._fields)),
           ("n_lanes", ctypes.c_int64), ("chunk", ctypes.c_int64),
           ("trace_cap", ctypes.c_int64), ("uop", ctypes.c_void_p)])


@functools.lru_cache(maxsize=None)
def load_library(source: Path = SOURCE):
    """Build (at first use) and load the kernel library."""
    path, _ = build(source)
    lib = ctypes.CDLL(str(path))
    fn = lib.megastep_launch
    # every pointer and the stream as c_void_p: ctypes would cut them to
    # 32-bit ints otherwise
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if hasattr(lib, "megastep_info"):  # an earlier design's build has none
        info = lib.megastep_info
        info.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        info.restype = ctypes.c_int
        dec = lib.megastep_decode
        dec.argtypes = [ctypes.POINTER(_Args), ctypes.c_int64,
                        ctypes.c_void_p]
        dec.restype = ctypes.c_int
    return lib


def kernel_info(lib=None) -> dict:
    """The runtime's view of the kernel: registers a thread, local memory
    a thread, and the most lanes a block (32 threads a lane) that its
    registers allow."""
    lib = load_library() if lib is None else lib
    vals = [ctypes.c_int() for _ in range(3)]
    rc = lib.megastep_info(*(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"megastep_info failed: CUDA error {rc}")
    regs, local, threads = (v.value for v in vals)
    return {"registers": regs, "local_bytes": local,
            "max_threads": threads, "max_lanes_per_block": threads // 32}


@functools.lru_cache(maxsize=None)
def device_tables(device: torch.device):
    """The 13 spec columns plus the 4 syscall-row columns on ``device``."""
    syscalls = tuple(torch.as_tensor(a).to(device) for a in
                     (opspec.SYS_NR_NP, opspec.SYS_KIND_NP,
                      opspec.SYS_CONST_NP, opspec.SYS_EMUL_NP))
    return tuple(opspec.spec_tables(device)) + syscalls


class Launch:
    """The kernel's arguments for one carry, and its decode table (every
    code word with its op-spec word, built here by one launch), made once
    and launched as often as the caller likes: the kernel updates the
    carry in place, so the pointers stay valid while the caller keeps the
    same tensors (the run and span drivers launch one ``Launch`` a chunk).
    ``lib`` is another build of the kernel with the same C interface
    (default: this package's; an earlier design's build has no decode
    table and reads ``packed``)."""

    def __init__(self, imgs: FleetImages, ids: torch.Tensor, s: MachineState,
                 tr: Optional[TraceState] = None, *, chunk: int, lib=None):
        self.device = s.pc.device
        self.lib = load_library() if lib is None else lib
        args = _Args()
        args.packed = imgs.packed.data_ptr()
        args.imm = imgs.imm.data_ptr()
        args.ids = ids.data_ptr()
        names = [f[0] for f in _Args._fields_[3:20]]
        for name, t in zip(names, device_tables(self.device)):
            setattr(args, name, t.data_ptr())
        for i, leaf in enumerate(s):
            args.leaf[i] = leaf.data_ptr()
        if tr is not None:
            for i, leaf in enumerate(tr):
                args.tleaf[i] = leaf.data_ptr()
        args.n_lanes = int(s.pc.shape[0])
        args.chunk = int(chunk)
        args.trace_cap = 0 if tr is None else int(tr.buf.shape[2])
        self.args = args
        self.ref = ctypes.byref(args)
        self.uop = torch.empty_like(imgs.packed)
        args.uop = self.uop.data_ptr()
        if hasattr(self.lib, "megastep_decode"):
            with torch.cuda.device(self.device):
                stream = torch.cuda.current_stream(self.device).cuda_stream
                rc = self.lib.megastep_decode(self.ref, self.uop.numel(),
                                              stream)
            if rc != 0:
                raise RuntimeError(f"megastep decode launch failed: CUDA "
                                   f"error {rc}")
        # keep the operands alive as long as their pointers are held
        self._keep = (imgs, ids, s, tr)

    def __call__(self, block: Optional[int] = None) -> None:
        """One launch on PyTorch's current stream, ``block`` lanes a block
        (default ``DEFAULT_BLOCK``); raises if the card refuses it."""
        block = DEFAULT_BLOCK if block is None else int(block)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = self.lib.megastep_launch(self.ref, block, stream)
        if rc != 0:
            raise RuntimeError(f"megastep kernel launch failed: CUDA error "
                               f"{rc} (block={block} lanes of 32 threads; "
                               f"see kernel_info() for the most a block)")
