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
