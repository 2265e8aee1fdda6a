"""Build and launch the CUDA chunkwise mLSTM kernel
(``csrc/mlstm_chunk.cu``).

Built at first use by :mod:`repro_torch.kernels.nvcc` into ``build/``
beside this file and loaded with ``ctypes``.  Nothing here runs at import
time; importing this module needs no card and no compiler.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .. import nvcc

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "mlstm_chunk.cu"
BUILD_DIR = _HERE / "build"
CHUNK = 64      # the kernel's chunk K (csrc: KC)
MAX_DH = 512    # the largest head dim its shared memory holds
MAX_BLOCKS = 65535  # the launch grid's y dimension (B * H)


def build() -> tuple[Path, str]:
    """Compile the kernel library if it is not built yet; returns the
    library path and ptxas's report (empty when it was already built)."""
    return nvcc.build("mlstm_chunk", SOURCE, BUILD_DIR)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.mlstm_chunk_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 13
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mlstm_chunk_smem_bytes.argtypes = [ctypes.c_int64]
    lib.mlstm_chunk_smem_bytes.restype = ctypes.c_int64
    return lib


def smem_bytes(dh: int) -> int:
    """The dynamic shared memory a block asks for at head dim ``dh``, as
    the kernel's source computes it."""
    return int(load_library().mlstm_chunk_smem_bytes(dh))


def mlstm_chunk_cuda(q, k, v, log_f, log_i, C0, n0, h, C, n) -> None:
    """Launch the kernel on PyTorch's current stream.  q/k/v are bf16
    (B, S, H, dh), unit stride over dh and rows 16-byte aligned (any other
    strides); log_f, log_i, C0, n0 and the outputs h, C, n are contiguous
    f32 on one card; the caller (:mod:`repro_torch.kernels.mlstm_chunk.ops`)
    has checked them."""
    B, S, H, dh = q.shape
    # the scale as the JAX model rounds it: 1/sqrt(dh) in f64, then f32
    scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))
    lib = load_library()
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mlstm_chunk_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
            log_i.data_ptr(), C0.data_ptr(), n0.data_ptr(), h.data_ptr(),
            C.data_ptr(), n.data_ptr(), B, S, H, dh, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], scale, stream)
    if rc != 0:
        raise RuntimeError(f"mlstm chunk kernel launch failed: {rc} (-1: "
                           "a shape the kernel does not take; else a CUDA "
                           "error)")
