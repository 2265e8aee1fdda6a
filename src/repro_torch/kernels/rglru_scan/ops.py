"""The RG-LRU scan wrapper.

:func:`rglru_scan` is the one entry to the kernel: for CPU tensors it runs
the plain version (:func:`.ref.rglru_scan_ref`, the associative scan the
JAX model runs); for CUDA tensors it launches the CUDA kernel
(:mod:`.kernel`), or raises — there is no fallback.
``rglru_scan.launches`` counts kernel launches (it stays 0 on the CPU).
A CUDA call whose inputs require grad, with grad mode on, raises
(:func:`repro_torch.kernels.refuse_grad`): the kernel has no backward.
"""
from __future__ import annotations

import torch

from .. import refuse_grad
from .kernel import MAX_BATCH, rglru_scan_cuda
from .ref import rglru_scan_ref


def check_operands(a, b, h0) -> None:
    """Types, shapes, devices and layout of a, b (B, S, dr) and h0
    (B, dr)."""
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: expected a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {t.dtype}; the scan takes float32")
        if t.device != a.device:
            raise ValueError(f"{name}: on {t.device}, a is on {a.device}")
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0],
                                                           a.shape[2]):
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}, h0 "
                         f"{tuple(h0.shape)}: expected (B, S, dr) twice "
                         "and (B, dr)")
    if a.shape[1] < 1:
        raise ValueError("S must be >= 1")


def rglru_scan(a, b, h0):
    """h_t = a_t h_{t-1} + b_t seeded by h0.  a, b: (B, S, dr) f32;
    h0: (B, dr) f32 -> h (B, S, dr) f32."""
    check_operands(a, b, h0)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    refuse_grad("rglru_scan", a, b, h0)
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    B, S, dr = a.shape
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    if B > MAX_BATCH:
        raise ValueError(f"batch {B}: the kernel takes at most {MAX_BATCH}")
    rglru_scan_cuda(a, b, h0, out)
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
