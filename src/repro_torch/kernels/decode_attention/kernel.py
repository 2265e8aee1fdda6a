"""Build and launch the CUDA flash-decode kernels
(``csrc/decode_attention.cu``: the split kernel and the merge of the
splits, one call).

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
from ..flash_attention.kernel import DTYPES, HEAD_DIMS, scale_of

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "decode_attention.cu"
BUILD_DIR = _HERE / "build"
MAX_GROUP = 16  # MAXG: query rows per kv head


class DecodeArgs(ctypes.Structure):
    """Mirror of ``struct DecodeArgs`` in ``csrc/decode_attention.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o")]
                + [(n, ctypes.c_int64) for n in (
                    "BH", "Hkv", "G", "Skv", "kv_len", "q_sbh", "q_sg",
                    "k_sb", "k_sh", "k_ss", "v_sb", "v_sh", "v_ss",
                    "o_sbh", "o_sg")]
                + [("scale", ctypes.c_float)])


def build() -> tuple[Path, str]:
    """Compile the kernel library if it is not built yet; returns the
    library path and ptxas's report (empty when it was already built)."""
    return nvcc.build("decode_attention", SOURCE, BUILD_DIR)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.decode_attention_launch
    fn.argtypes = [ctypes.POINTER(DecodeArgs), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def decode_attention_cuda(q, k, v, out, kv_len: int, *, Hkv: int, Skv: int,
                          strides: tuple, nsplit: int, part=None) -> None:
    """Launch the split kernel and, for ``nsplit`` > 1, the merge of the
    splits, on PyTorch's current stream, in one call.

    ``q`` and ``out`` are (BHkv, G, hd) with a contiguous head dim;
    ``strides`` gives q's (bh, g), k's and v's (batch, head, sequence) and
    out's (bh, g) element strides, where bh = batch * Hkv + head; ``part``
    is f32 scratch of BHkv * nsplit * G * (hd + 2) values (None for one
    split).  The caller (:mod:`repro_torch.kernels.decode_attention.ops`)
    has checked the operands, 16-byte aligned rows included."""
    BH, G, hd = q.shape
    a = DecodeArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   BH, Hkv, G, Skv, int(kv_len), *strides, scale_of(hd))
    lib = load_library()
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.decode_attention_launch(
            ctypes.byref(a), DTYPES[q.dtype], hd, int(nsplit),
            None if part is None else part.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: {rc} "
                           "(-1: no instance for this head dim / group; "
                           "else a CUDA error)")
