"""Build and launch the CUDA mLSTM kernels (``csrc/mlstm_chunk.cu``): the
prefill's scores pass and state-and-output pass on the tensor cores, and
the decode step in place.

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
CHUNK = 64      # the kernels' chunk K (csrc: KC)
BN = 64         # columns of C a block of the state pass owns (csrc: BN)
MAX_DH = 512    # the largest head dim the kernels take
MAX_BLOCKS = 65535  # the launch grids' y dimension (B * H)
# the kernels' names in the library (mangled as nvcc writes them)
KERNELS = ("mlstm_scores_kernel", "mlstm_state_kernel",
           "mlstm_decode_n_kernel", "mlstm_decode_c_kernel")
LAUNCH_ERRORS = {-1: "a shape the kernels do not take",
                 -2: "a TMA map could not be built"}

_P, _I = ctypes.c_void_p, ctypes.c_int64


def build() -> tuple[Path, str]:
    """Compile the kernel library if it is not built yet; returns the
    library path and ptxas's report (empty when it was already built)."""
    return nvcc.build("mlstm_chunk", SOURCE, BUILD_DIR)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (at first use) and load the kernel library."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.mlstm_prefill_launch.argtypes = [_P] * 11 + [_I] * 13 + [
        ctypes.c_float, _P]
    lib.mlstm_prefill_launch.restype = ctypes.c_int
    lib.mlstm_decode_launch.argtypes = [_P] * 11 + [_I] * 9 + [
        ctypes.c_float, _P]
    lib.mlstm_decode_launch.restype = ctypes.c_int
    lib.mlstm_scratch_bytes.argtypes = [_I] * 3
    lib.mlstm_scratch_bytes.restype = _I
    lib.mlstm_info.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.mlstm_info.restype = ctypes.c_int
    return lib


def info() -> dict:
    """Each kernel as the runtime sees it: {name: {dynamic shared memory,
    threads a block, registers a thread, local memory a thread}}."""
    out = (ctypes.c_int * (4 * len(KERNELS)))()
    rc = load_library().mlstm_info(out)
    if rc != 0:
        raise RuntimeError(f"mlstm_info failed: {rc}")
    keys = ("dynamic_smem_bytes", "threads", "registers", "local_bytes")
    return {name: dict(zip(keys, out[4 * i:4 * i + 4]))
            for i, name in enumerate(KERNELS)}


def scale_of(dh: int) -> float:
    """1/sqrt(dh) as the JAX model rounds it: in f64, then f32."""
    return float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))


def _check(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"mlstm kernel launch failed: {rc} "
                           f"({LAUNCH_ERRORS.get(rc, 'a CUDA error')})")


def mlstm_prefill_cuda(q, k, v, log_f, log_i, C0, n0, h, C, n) -> None:
    """Launch the scores pass and the state-and-output pass on PyTorch's
    current stream.  q/k/v are bf16 (B, S, H, dh), unit stride over dh and
    16-byte multiples otherwise; log_f, log_i, C0, n0 and the outputs h, C,
    n are contiguous f32 on one card, n apart from n0; the caller
    (:mod:`repro_torch.kernels.mlstm_chunk.ops`) has checked them.  The
    scores' scratch is allocated here."""
    B, S, H, dh = q.shape
    lib = load_library()
    sc = torch.empty(int(lib.mlstm_scratch_bytes(B * H, S, dh)),
                     dtype=torch.uint8, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mlstm_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
            log_i.data_ptr(), C0.data_ptr(), n0.data_ptr(), h.data_ptr(),
            C.data_ptr(), n.data_ptr(), sc.data_ptr(), B, S, H, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale_of(dh),
            stream)
    _check(rc)


def mlstm_decode_cuda(q, k, v, log_f, log_i, C0, n0, h, C, n) -> None:
    """Launch the decode step (S = 1) on PyTorch's current stream: n, then
    C, each written where the caller says — C may be C0 and n may be n0
    (the step in place).  Operands as for :func:`mlstm_prefill_cuda`."""
    B, _, H, dh = q.shape
    lib = load_library()
    den = torch.empty(B * H, dtype=torch.float32, device=q.device)
    strides = [x for t in (q, k, v) for x in (t.stride(0), t.stride(2))]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mlstm_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
            log_i.data_ptr(), C0.data_ptr(), n0.data_ptr(), h.data_ptr(),
            C.data_ptr(), n.data_ptr(), den.data_ptr(), B, H, dh, *strides,
            scale_of(dh), stream)
    _check(rc)
