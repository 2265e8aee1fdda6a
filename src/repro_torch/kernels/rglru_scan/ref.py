"""The plain PyTorch versions of the RG-LRU scan (the ground truth the
CUDA kernel is held to, and the CPU route).

h_t = a_t * h_{t-1} + b_t over axis 1, seeded by h0.  The JAX package's
CPU backend computes every ``x * y + z`` of these scans as one fused
multiply-add; :func:`repro_torch.numerics.fma` rounds the same way on any
device, so both functions equal their JAX counterparts bit for bit.
"""
from __future__ import annotations

import torch

from ...numerics import fma


def _combine(l, r):
    """(a, b) o (a', b') = (a a', a' b + b'): step l, then step r."""
    return l[0] * r[0], fma(r[0], l[1], r[1])


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along axis 1.  The JAX function adds
    two zero-padded arrays, which turns -0 into +0; so does ``+ 0.0``."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out + 0.0


def associative_scan(a, b):
    """``lax.associative_scan`` of :func:`_combine` over axis 1, with its
    odd/even recursion, so that every sum is rounded where JAX rounds it."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                     (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        odd_prev = (odd[0][:, :-1], odd[1][:, :-1])
    else:
        odd_prev = odd
    even = _combine(odd_prev, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], 1),
            torch.cat([b[:, :1], even[1]], 1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def rglru_scan_ref(a, b, h0):
    """a, b: (B, S, dr) f32; h0: (B, dr) f32 -> h (B, S, dr) f32.  h0 is
    folded into the first step (b'_0 = a_0 h0 + b_0), then the
    associative scan."""
    b = torch.cat([fma(a[:, 0], h0, b[:, 0])[:, None], b[:, 1:]], 1)
    return associative_scan(a, b)[1]


def rglru_scan_seq(a, b, h0):
    """The definitional recurrence, one step at a time."""
    h, out = h0, []
    for t in range(a.shape[1]):
        h = fma(a[:, t], h, b[:, t])
        out.append(h)
    return torch.stack(out, 1)
