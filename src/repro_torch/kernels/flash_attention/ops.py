"""The flash-attention wrapper, in the model's (B, S, H, hd) layout.

:func:`flash_attention` is the one entry to the kernel: for CPU tensors it
runs the plain version (:func:`flash_attention_plain`: the JAX wrapper's
GQA flattening to (B*H, S, hd), then :mod:`.ref`); for CUDA tensors it
launches a CUDA kernel (:mod:`.kernel`) on the (B, S, H, hd) strides
directly, with no transpose, or raises — there is no fallback.  The
inputs' type picks the kernel: bf16 (the serving paths) runs on the
tensor cores (wgmma, K and V tiles by TMA), f32 on the SIMT kernel, whose
f32 products hold the f32 bound that bf16 or TF32 tensor cores cannot; a
bf16 instance that fails to build or launch raises.  The tile is each
kernel's own.  ``flash_attention.launches`` counts kernel launches (it
stays 0 on the CPU).
A CUDA call whose inputs require grad, with grad mode on, raises
(:func:`repro_torch.kernels.refuse_grad`): the kernel has no backward.
"""
from __future__ import annotations

import torch

from .. import refuse_grad
from .kernel import DTYPES, HEAD_DIMS, flash_attention_cuda
from .ref import attention_ref


def check_qkv(q, k, v) -> None:
    """Types, shapes, devices and layout of (B, S, H, hd) q, k, v."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name}: expected a (B, S, H, hd) tensor")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{name}: {t.dtype}; q, k, v must share one of "
                            f"{tuple(DTYPES)}")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, q is on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    B, _, Hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[2] < 1 or Hq % k.shape[2]:
        raise ValueError(f"{Hq} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")


def check_aligned(*named) -> None:
    """What the kernels' 16-byte copies (TMA, cp.async) need: each
    (name, tensor)'s base 16-byte aligned and its batch, sequence and head
    strides multiples of 16 bytes."""
    for name, t in named:
        vec = 16 // t.element_size()
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name}: rows must be 16-byte aligned")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """The plain version in the wrapper's layout: q (B, Sq, Hq, hd);
    k, v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    q3 = q.transpose(1, 2).reshape(B * Hq, Sq, hd)
    k3 = k.transpose(1, 2).reshape(B * Hkv, Skv, hd)
    v3 = v.transpose(1, 2).reshape(B * Hkv, Skv, hd)
    o3 = attention_ref(q3, k3, v3, causal=causal, window=window)
    return o3.reshape(B, Hq, Sq, hd).transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd).

    Query head hq reads kv head hq // (Hq // Hkv)."""
    check_qkv(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    refuse_grad("flash_attention", q, k, v)
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel has {HEAD_DIMS}")
    check_aligned(("q", q), ("k", k), ("v", v))
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Skv < 1:
        raise ValueError("Skv must be >= 1")
    strides = tuple(s for t in (q, k, v, out)
                    for s in (t.stride(0), t.stride(1), t.stride(2)))
    flash_attention_cuda(q, k, v, out, dims=(B, Hq, Hkv, Sq, Skv),
                         strides=strides, causal=causal, window=int(window))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
