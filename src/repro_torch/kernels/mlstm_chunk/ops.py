"""The chunkwise mLSTM wrapper.

:func:`mlstm_chunk` is the one entry to the kernel: for CPU tensors it
runs the plain version (:func:`.ref.mlstm_chunk_ref` at ``chunk``, the
JAX model's ``mlstm_scan_chunked``); for CUDA tensors it launches the
CUDA kernel (:mod:`.kernel`), which computes in chunks of its own
:data:`.kernel.CHUNK` whatever ``chunk`` says (chunking changes only the
rounding), or raises — there is no fallback.  ``mlstm_chunk.launches``
counts kernel launches (it stays 0 on the CPU).
"""
from __future__ import annotations

import torch

from .kernel import CHUNK, MAX_BLOCKS, MAX_DH, mlstm_chunk_cuda
from .ref import mlstm_chunk_ref


def check_operands(q, k, v, log_f, log_i, C0, n0) -> None:
    """Types, shapes and devices of q/k/v (B, S, H, dh), log_f/log_i
    (B, S, H), C0 (B, H, dh, dh) and n0 (B, H, dh)."""
    named = (("q", q), ("k", k), ("v", v), ("log_f", log_f),
             ("log_i", log_i), ("C0", C0), ("n0", n0))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: expected a tensor")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, q is on {q.device}")
    for name, t in named[:3]:
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name}: {t.dtype}; q/k/v are bfloat16 (or "
                            "float32 on the CPU)")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {t.dtype}, q is {q.dtype}")
    for name, t in named[3:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {t.dtype}; the gates and the state "
                            "are float32")
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}: expected (B, S, H, dh)")
    B, S, H, dh = q.shape
    want = {"k": (B, S, H, dh), "v": (B, S, H, dh), "log_f": (B, S, H),
            "log_i": (B, S, H), "C0": (B, H, dh, dh), "n0": (B, H, dh)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)}: expected "
                             f"{want[name]}")
    if S < 1:
        raise ValueError("S must be >= 1")


def mlstm_chunk(q, k, v, log_f, log_i, C0, n0, *, chunk: int = CHUNK):
    """The mLSTM over (B, S, H, dh) from the state (C0, n0): returns (h
    (B, S, H, dh) f32, C (B, H, dh, dh) f32, n (B, H, dh) f32)."""
    check_operands(q, k, v, log_f, log_i, C0, n0)
    if q.device.type == "cpu":
        return mlstm_chunk_ref(q, k, v, log_f, log_i, C0, n0, chunk)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"q: {q.dtype}; the kernel takes bfloat16 q/k/v")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(3) != 1 or any(x % 8 for x in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: the kernel reads rows of dh "
                             "contiguous elements, 16-byte aligned")
    for name, t in (("log_f", log_f), ("log_i", log_i), ("C0", C0),
                    ("n0", n0)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if C0.data_ptr() % 16:
        raise ValueError("C0: the kernel reads it 16-byte aligned")
    B, S, H, dh = q.shape
    if dh % 32 or dh > MAX_DH:
        raise ValueError(f"dh {dh}: the kernel takes multiples of 32 up to "
                         f"{MAX_DH}")
    if B * H > MAX_BLOCKS:
        raise ValueError(f"B * H = {B * H}: the kernel takes at most "
                         f"{MAX_BLOCKS}")
    h = torch.empty((B, S, H, dh), dtype=torch.float32, device=q.device)
    C = torch.empty_like(C0)
    n = torch.empty_like(n0)
    mlstm_chunk_cuda(q, k, v, log_f, log_i, C0, n0, h, C, n)
    mlstm_chunk.launches += 1
    return h, C, n


mlstm_chunk.launches = 0
