"""Build and launch the CUDA flash-attention kernels
(``csrc/flash_attention.cu``): the tensor-core kernel for bf16 inputs (the
serving paths), the SIMT kernel for f32 inputs.

Built at first use by :mod:`repro_torch.kernels.nvcc` into ``build/``
beside this file and loaded with ``ctypes``.  Nothing here runs at import
time; importing this module needs no card and no compiler.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from .. import nvcc

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "flash_attention.cu"
BUILD_DIR = _HERE / "build"
HEAD_DIMS = (16, 64, 128, 256)
# input type -> kernel: 0 the f32 SIMT kernel, 1 the bf16 tensor-core kernel
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 instance's name (mangled) in a build report, by head dim
TC_INSTANCE = "flash_tc_kernelILi{hd}E"
LAUNCH_ERRORS = {-1: "no instance for this head dim and type",
                 -2: "a TMA map could not be built"}


class FlashArgs(ctypes.Structure):
    """Mirror of ``struct FlashArgs`` in ``csrc/flash_attention.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o")]
                + [(n, ctypes.c_int64) for n in (
                    "B", "Hq", "Hkv", "Sq", "Skv",
                    "q_sb", "q_ss", "q_sh", "k_sb", "k_ss", "k_sh",
                    "v_sb", "v_ss", "v_sh", "o_sb", "o_ss", "o_sh",
                    "causal", "window")]
                + [("scale", ctypes.c_float)])


def build() -> tuple[Path, str]:
    """Compile the kernel library if it is not built yet; returns the
    library path and ptxas's report (empty when it was already built)."""
    return nvcc.build("flash_attention", SOURCE, BUILD_DIR)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.POINTER(FlashArgs), ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = lib.flash_attention_info
    info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    info.restype = ctypes.c_int
    return lib


def tc_info(hd: int) -> dict:
    """The bf16 tensor-core instance of head dim ``hd`` as the runtime
    sees it: dynamic shared memory, threads a block, registers a thread,
    local memory a thread."""
    out = (ctypes.c_int * 4)()
    rc = load_library().flash_attention_info(hd, out)
    if rc != 0:
        raise RuntimeError(f"flash_attention_info({hd}) failed: {rc}")
    return dict(zip(("dynamic_smem_bytes", "threads", "registers",
                     "local_bytes"), out))


def scale_of(hd: int) -> float:
    """1/sqrt(hd) as the f32 the TPU kernel multiplies q by."""
    return float(np.float32(1.0 / np.sqrt(hd)))


def flash_attention_cuda(q, k, v, out, *, dims: tuple, strides: tuple,
                         causal: bool, window: int) -> None:
    """Launch the kernel for q's type on PyTorch's current stream.

    ``dims`` is (B, Hq, Hkv, Sq, Skv); ``strides`` gives, for q, k, v and
    out in turn, the element strides (batch, sequence, head) of a layout
    whose head dim is contiguous.  The caller
    (:mod:`repro_torch.kernels.flash_attention.ops`) has checked the
    operands, 16-byte alignment included."""
    a = FlashArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *dims, *strides, int(bool(causal)), int(window),
                  scale_of(q.shape[-1]))
    lib = load_library()
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_launch(ctypes.byref(a), DTYPES[q.dtype],
                                        q.shape[-1], stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: {rc} "
                           f"({LAUNCH_ERRORS.get(rc, 'a CUDA error')})")
