"""Build and launch the CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

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
TILES = ((64, 32), (32, 32), (64, 64))  # (bq, bk) instantiated; first = default
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def scale_of(hd: int) -> float:
    """1/sqrt(hd) as the f32 the TPU kernel multiplies q by."""
    return float(np.float32(1.0 / np.sqrt(hd)))


def flash_attention_cuda(q, k, v, out, *, dims: tuple, strides: tuple,
                         causal: bool, window: int, bq: int, bk: int) -> None:
    """Launch the kernel on PyTorch's current stream.

    ``dims`` is (B, Hq, Hkv, Sq, Skv); ``strides`` gives, for q, k, v and
    out in turn, the element strides (batch, sequence, head) of a layout
    whose head dim is contiguous.  The caller
    (:mod:`repro_torch.kernels.flash_attention.ops`) has checked the
    operands."""
    a = FlashArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *dims, *strides, int(bool(causal)), int(window),
                  scale_of(q.shape[-1]))
    lib = load_library()
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_launch(ctypes.byref(a), DTYPES[q.dtype],
                                        q.shape[-1], bq, bk, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: {rc} "
                           "(-1: no instance for this head dim / tile; "
                           "else a CUDA error)")
