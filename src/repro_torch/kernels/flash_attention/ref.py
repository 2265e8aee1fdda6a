"""The plain PyTorch version of flash attention (the ground truth the
CUDA kernel is held to, and the CPU route)."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (BHq, Sq, hd); k, v: (BHkv, Skv, hd); GQA by h // group.

    The JAX package's ``attention_ref``: f32 logits over all keys, masked
    logits -1e30, softmax in f32, output in q's dtype."""
    BH, Sq, hd = q.shape
    BHkv, Skv, _ = k.shape
    group = BH // BHkv
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) / math.sqrt(hd)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)
