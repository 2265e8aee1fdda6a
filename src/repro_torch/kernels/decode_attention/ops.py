"""The flash-decode wrapper, in the model's (B, S, H, hd) layout.

:func:`decode_attention` is the one entry to the kernel: for CPU tensors it
runs the plain version (:func:`decode_attention_plain`: the JAX wrapper's
reshapes, then :mod:`.ref`); for CUDA tensors it launches the CUDA kernel
(:mod:`.kernel`) on the cache's (B, S, H, hd) strides directly, or raises
— there is no fallback.  ``kv_len`` is a host integer, so no call syncs.
The kernel splits the cache into :func:`split_count` slices that run side
by side and merges them in a fixed order (the same bits every call).
``decode_attention.launches`` counts calls of the kernel: one a call,
which launches the split kernel and, with more than one split, the merge
(it stays 0 on the CPU).
A CUDA call whose inputs require grad, with grad mode on, raises
(:func:`repro_torch.kernels.refuse_grad`): the kernel has no backward.
"""
from __future__ import annotations

import functools
import operator

import torch

from .. import refuse_grad
from ..flash_attention.ops import check_aligned, check_qkv
from .kernel import HEAD_DIMS, MAX_GROUP, decode_attention_cuda
from .ref import decode_attention_ref

MIN_SPLIT = 64  # cache positions a split holds at least
H100_SMS = 132


def split_count(Skv: int, kv_len: int, bh: int, sms: int = H100_SMS) -> int:
    """How many slices of the cache the kernel runs side by side for
    ``bh`` (batch x kv heads) rows: enough that bh x splits covers the
    card's ``sms`` twice, but no split under MIN_SPLIT positions.  The
    kernel visits n = min(kv_len, Skv) positions (all Skv when kv_len <= 0,
    every one masked); split s takes [s * n // splits, (s + 1) * n //
    splits)."""
    n = min(kv_len, Skv) if kv_len >= 1 else Skv
    want = -(-2 * sms // max(bh, 1))
    return max(1, min(want, n // MIN_SPLIT))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_plain(q, k, v, kv_len: int):
    """The plain version in the wrapper's layout: q (B, 1, Hq, hd);
    k, v (B, Skv, Hkv, hd) -> (B, 1, Hq, hd)."""
    B, _, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    q3 = q.reshape(B, Hkv, G, hd).reshape(B * Hkv, G, hd)
    k3 = k.transpose(1, 2).reshape(B * Hkv, Skv, hd)
    v3 = v.transpose(1, 2).reshape(B * Hkv, Skv, hd)
    o3 = decode_attention_ref(q3, k3, v3, kv_len)
    return o3.reshape(B, Hkv, G, hd).reshape(B, 1, Hq, hd)


def decode_attention(q, k, v, kv_len):
    """q: (B, 1, Hq, hd); k, v: (B, Skv, Hkv, hd); kv_len: an int (cache
    positions >= kv_len are masked) -> (B, 1, Hq, hd).

    Query head hq = hkv * G + g, G = Hq // Hkv."""
    check_qkv(q, k, v)
    kv_len = operator.index(kv_len)  # a host int: never a device sync
    if q.shape[1] != 1:
        raise ValueError(f"decode takes one query position, got {q.shape[1]}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    refuse_grad("decode_attention", q, k, v)
    B, _, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel has {HEAD_DIMS}")
    if G > MAX_GROUP:
        raise ValueError(f"{G} query heads per kv head: the kernel takes "
                         f"at most {MAX_GROUP}")
    check_aligned(("k", k), ("v", v))  # the kernel's 16-byte copies
    q3 = q.reshape(B * Hkv, G, hd)
    out = torch.empty((B * Hkv, G, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out.reshape(B, 1, Hq, hd)
    if Skv < 1:
        raise ValueError("Skv must be >= 1")
    strides = (q3.stride(0), q3.stride(1),
               k.stride(0), k.stride(2), k.stride(1),
               v.stride(0), v.stride(2), v.stride(1),
               out.stride(0), out.stride(1))
    nsplit = split_count(Skv, kv_len, B * Hkv, sm_count(q.device.index or 0))
    part = None if nsplit == 1 else torch.empty(
        (B * Hkv, nsplit, G, hd + 2), dtype=torch.float32, device=q.device)
    decode_attention_cuda(q3, k, v, out, kv_len, Hkv=Hkv, Skv=Skv,
                          strides=strides, nsplit=nsplit, part=part)
    decode_attention.launches += 1
    return out.reshape(B, 1, Hq, hd)


decode_attention.launches = 0
