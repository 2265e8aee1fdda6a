"""The plain PyTorch version of flash-decode (the ground truth the CUDA
kernel is held to, and the CPU route)."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k, v, kv_len: int):
    """q: (BHkv, G, hd); k, v: (BHkv, Skv, hd); kv_len: an int.

    The JAX package's ``decode_attention_ref``: positions >= kv_len masked
    with -1e30, softmax in f32, output in q's dtype."""
    _, Skv, hd = k.shape
    s = torch.einsum("hgd,hkd->hgk", q.float(), k.float()) / math.sqrt(hd)
    mask = torch.arange(Skv, device=q.device)[None, None, :] < kv_len
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hgk,hkd->hgd", p, v.float()).to(q.dtype)


def decode_split_ref(q, k, v, kv_len: int, nsplit: int):
    """The kernel's split and merge in plain PyTorch: the visited positions
    (min(kv_len, Skv), or all Skv when kv_len <= 0, every one masked) cut
    into ``nsplit`` slices [s * n // nsplit, (s + 1) * n // nsplit); each
    slice's partial (max m, denominator l, unnormalised o) in f32, then the
    partials merged in slice order.  Same arguments and result as
    :func:`decode_attention_ref`."""
    _, Skv, hd = k.shape
    n = min(kv_len, Skv) if kv_len >= 1 else Skv
    s = torch.einsum("hgd,hkd->hgk", q.float(), k[:, :n].float()) \
        / math.sqrt(hd)
    if kv_len < 1:
        s = torch.full_like(s, -1e30)
    parts = []
    for i in range(nsplit):
        lo, hi = i * n // nsplit, (i + 1) * n // nsplit
        si = s[..., lo:hi]
        m = si.max(-1, keepdim=True).values
        p = torch.exp(si - m)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("hgk,hkd->hgd", p, v[:, lo:hi].float())))
    mx = torch.stack([m for m, _, _ in parts]).max(0).values
    den = sum(l * torch.exp(m - mx) for m, l, _ in parts)
    num = sum(o * torch.exp(m - mx) for m, _, o in parts)
    return (num / den).to(q.dtype)
