"""The chunkwise mLSTM wrapper.

:func:`mlstm_chunk` is the one entry to the kernels: for CPU tensors it
runs the plain version (:func:`.ref.mlstm_chunk_ref` at ``chunk``, the
JAX model's ``mlstm_scan_chunked``); for CUDA tensors it launches the
CUDA kernels (:mod:`.kernel`) — at S > 1 the prefill's scores pass and
state pass, which compute in chunks of their own :data:`.kernel.CHUNK`
whatever ``chunk`` says (chunking changes only the rounding), at S = 1
the decode step — or raises: there is no fallback.  ``out=(C, n)`` asks
for the new state in the caller's tensors; at S = 1 they may be the state
passed in (the decode step in place).  ``mlstm_chunk.launches`` counts
calls that launched the kernels, one a call (it stays 0 on the CPU).
A CUDA call whose inputs require grad, with grad mode on, raises
(:func:`repro_torch.kernels.refuse_grad`): the kernel has no backward.
"""
from __future__ import annotations

import torch

from .. import refuse_grad
from .kernel import (CHUNK, MAX_BLOCKS, MAX_DH, mlstm_decode_cuda,
                     mlstm_prefill_cuda)
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


def _overlap(a, b) -> bool:
    """Whether two tensors' memory intersects."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a.device == b.device and a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def check_out(out, C0, n0, S: int) -> None:
    """``out`` is (C, n) like (C0, n0): f32, contiguous, on their device;
    at S > 1 apart from them (the prefill's blocks read n0 while one
    writes n), at S = 1 each either its own state tensor or apart."""
    if not (isinstance(out, (tuple, list)) and len(out) == 2
            and all(isinstance(t, torch.Tensor) for t in out)):
        raise ValueError("out: expected a pair of tensors (C, n)")
    for name, t, like in (("C", out[0], C0), ("n", out[1], n0)):
        if (t.shape != like.shape or t.dtype != torch.float32
                or t.device != like.device or not t.is_contiguous()):
            raise ValueError(f"out {name}: expected contiguous float32 "
                             f"{tuple(like.shape)} on {like.device}")
    for t, own in ((out[0], C0), (out[1], n0)):
        if S == 1 and t.data_ptr() == own.data_ptr():
            continue  # in place: each element read and written by one thread
        if _overlap(t, C0) or _overlap(t, n0):
            raise ValueError("out: overlaps the state passed in (in place "
                             "only at S = 1, each tensor over its own)")


def mlstm_chunk(q, k, v, log_f, log_i, C0, n0, *, chunk: int = CHUNK,
                out=None):
    """The mLSTM over (B, S, H, dh) from the state (C0, n0): returns (h
    (B, S, H, dh) f32, C (B, H, dh, dh) f32, n (B, H, dh) f32), with C and
    n the tensors of ``out`` when it is given."""
    check_operands(q, k, v, log_f, log_i, C0, n0)
    S = q.shape[1]
    if out is not None:
        check_out(out, C0, n0, S)
    if q.device.type == "cpu":
        h, C, n = mlstm_chunk_ref(q, k, v, log_f, log_i, C0, n0, chunk)
        if out is None:
            return h, C, n
        out[0].copy_(C)
        out[1].copy_(n)
        return h, out[0], out[1]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    refuse_grad("mlstm_chunk", q, k, v, log_f, log_i, C0, n0)
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
    B, _, H, dh = q.shape
    if dh % 32 or dh > MAX_DH:
        raise ValueError(f"dh {dh}: the kernel takes multiples of 32 up to "
                         f"{MAX_DH}")
    if B * H > MAX_BLOCKS:
        raise ValueError(f"B * H = {B * H}: the kernel takes at most "
                         f"{MAX_BLOCKS}")
    C, n = out if out is not None else (torch.empty_like(C0),
                                        torch.empty_like(n0))
    if C0.data_ptr() % 16 or C.data_ptr() % 16:
        raise ValueError("C0, C: the kernel reads them 16-byte aligned")
    h = torch.empty((B, S, H, dh), dtype=torch.float32, device=q.device)
    if S == 1:
        mlstm_decode_cuda(q, k, v, log_f, log_i, C0, n0, h, C, n)
    else:
        mlstm_prefill_cuda(q, k, v, log_f, log_i, C0, n0, h, C, n)
    mlstm_chunk.launches += 1
    return h, C, n


mlstm_chunk.launches = 0
