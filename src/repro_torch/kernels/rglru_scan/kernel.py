"""Build and launch the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

Built at first use by :mod:`repro_torch.kernels.nvcc` into ``build/``
beside this file and loaded with ``ctypes``.  Nothing here runs at import
time; importing this module needs no card and no compiler.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import nvcc

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "rglru_scan.cu"
BUILD_DIR = _HERE / "build"
MAX_BATCH = 65535  # the launch grid's y dimension


def build() -> tuple[Path, str]:
    """Compile the kernel library if it is not built yet; returns the
    library path and ptxas's report (empty when it was already built)."""
    return nvcc.build("rglru_scan", SOURCE, BUILD_DIR)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def rglru_scan_cuda(a, b, h0, out) -> None:
    """Launch the kernel on PyTorch's current stream.  ``a``, ``b``,
    ``out`` are contiguous (B, S, D) f32 and ``h0`` contiguous (B, D) f32
    on one card; the caller (:mod:`repro_torch.kernels.rglru_scan.ops`)
    has checked them."""
    B, S, D = a.shape
    lib = load_library()
    dev = a.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(),
                                   h0.data_ptr(), out.data_ptr(), B, S, D,
                                   stream)
    if rc != 0:
        raise RuntimeError(f"rglru scan kernel launch failed: {rc} "
                           "(-1: empty or batch over the grid; else a CUDA "
                           "error)")
