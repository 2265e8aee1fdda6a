"""Build and launch the CUDA megastep kernel (``csrc/megastep.cu``).

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/`` beside this file (git-ignored), named by a
hash of the source, the generated constants header and the flags, so an
edited source rebuilds and an unchanged one is reused.

The constants the kernel needs (layout, op-spec classes, halt codes, cost
model, the ``MachineState`` leaf order) are generated into a header from
the Python modules at build time: the kernel has no second copy of them.

Nothing here runs at import time; importing this module needs no card
and no compiler.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from ...core import costmodel as cm
from ...core import layout as L
from ...core import machine as M
from ...core import opspec
from ...core.fleet import FleetImages
from ...core.isa import Op
from ...core.machine import MachineState

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "megastep.cu"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DEFAULT_BLOCK = 32  # threads (= lanes) per block: 500 lanes -> 16 blocks


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
        "HALT_BADMEM": M.HALT_BADMEM,
        "KERNEL_CROSS": cm.KERNEL_CROSS, "PTRACE_STOP": cm.PTRACE_STOP,
        "IO_BYTES_PER_CYCLE": cm.IO_BYTES_PER_CYCLE,
        "SIGNAL_DELIVERY": cm.SIGNAL_DELIVERY,
        "OP_NULLPAGE": int(Op.NULLPAGE), "N_OPS": int(Op.N_OPS),
        "N_SYSCALLS": len(opspec.SYSCALLS),
        "N_LEAVES": len(MachineState._fields),
    }
    for prefix in ("A_", "F_", "M_", "P_", "K_"):
        defs.update({k: v for k, v in vars(opspec).items()
                     if k.startswith(prefix) and isinstance(v, int)
                     and not isinstance(v, bool)})
    defs.update({f"LEAF_{f}": i for i, f in enumerate(MachineState._fields)})
    lines = ["// Generated by repro_torch/kernels/megastep/kernel.py.",
             "#pragma once"]
    lines += [f"#define {k} ((int64_t){v}LL)" if abs(v) > 2**31 - 1
              else f"#define {k} {v}" for k, v in sorted(defs.items())]
    return "\n".join(lines) + "\n"


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the megastep kernel is built with "
                       "the CUDA toolkit on the machine with the card")


def build() -> tuple[Path, str]:
    """Compile the kernel library if it is not built yet.  Returns the
    library path and the compiler's report (``-Xptxas -v``: registers,
    shared memory, spills; empty when the library was already there)."""
    header = consts_header()
    src = SOURCE.read_text()
    tag = hashlib.sha1("\0".join((src, header) + NVCC_FLAGS).encode()
                       ).hexdigest()[:16]
    lib = BUILD_DIR / f"libmegastep_{tag}.so"
    if lib.exists():
        return lib, ""
    inc = BUILD_DIR / f"include_{tag}"
    inc.mkdir(parents=True, exist_ok=True)
    (inc / "megastep_consts.h").write_text(header)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-I", str(inc), "-o", str(tmp),
           str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


class _Args(ctypes.Structure):
    """Mirror of ``struct MegastepArgs`` in ``csrc/megastep.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "packed", "imm", "ids", "alu", "wb_sp", "wb_lr", "flags", "memc",
        "addr_post", "wb_base", "pcc", "segv", "exit_", "signo", "cost",
        "cond_mask", "sys_nr", "sys_kind", "sys_const")]
        + [("leaf", ctypes.c_void_p * len(MachineState._fields)),
           ("n_lanes", ctypes.c_int64), ("chunk", ctypes.c_int64)])


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.megastep_launch
    # every pointer and the stream as c_void_p: ctypes would cut them to
    # 32-bit ints otherwise
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def device_tables(device: torch.device):
    """The 13 spec columns plus the 3 syscall-row columns on ``device``."""
    syscalls = tuple(torch.as_tensor(a).to(device) for a in
                     (opspec.SYS_NR_NP, opspec.SYS_KIND_NP,
                      opspec.SYS_CONST_NP))
    return tuple(opspec.spec_tables(device)) + syscalls


def megastep_chunk_cuda(imgs: FleetImages, ids: torch.Tensor,
                        s: MachineState, *, chunk: int,
                        block: Optional[int] = None) -> None:
    """Launch the kernel on PyTorch's current stream: ``chunk`` steps of
    every lane, the carry updated in place.  The caller has validated the
    operands (:func:`repro_torch.kernels.megastep.ops.megastep_chunk`)."""
    dev = s.pc.device
    block = DEFAULT_BLOCK if block is None else int(block)
    lib = load_library()
    args = _Args()
    args.packed = imgs.packed.data_ptr()
    args.imm = imgs.imm.data_ptr()
    args.ids = ids.data_ptr()
    names = [f[0] for f in _Args._fields_[3:19]]
    for name, t in zip(names, device_tables(dev)):
        setattr(args, name, t.data_ptr())
    for i, leaf in enumerate(s):
        args.leaf[i] = leaf.data_ptr()
    args.n_lanes = int(s.pc.shape[0])
    args.chunk = int(chunk)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.megastep_launch(ctypes.byref(args), block, stream)
    if rc != 0:
        raise RuntimeError(f"megastep kernel launch failed: CUDA error {rc}")
