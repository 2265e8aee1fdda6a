"""The plain PyTorch version of flash attention (the ground truth the
CUDA kernel is held to, and the CPU route)."""
from __future__ import annotations

import math

import torch


def _masked_logits(q, k, v, causal: bool, window: int):
    """f32 logits of q against k (GQA by h // group) with masked logits
    -1e30, and v repeated to the query heads."""
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
    return torch.where(mask[None], s, torch.tensor(-1e30, device=q.device)), v


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (BHq, Sq, hd); k, v: (BHkv, Skv, hd); GQA by h // group.

    The JAX package's ``attention_ref``: f32 logits over all keys, masked
    logits -1e30, softmax in f32, output in q's dtype."""
    s, v = _masked_logits(q, k, v, causal, window)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)


def attention_tc_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """:func:`attention_ref` with the tensor-core kernel's one extra
    rounding: the probabilities, exp(s - row max) in f32, are rounded to
    bf16 before P V, while the denominator sums them unrounded."""
    s, v = _masked_logits(q, k, v, causal, window)
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    o = torch.einsum("hqk,hkd->hqd", p.bfloat16().float(), v.float())
    return (o / p.sum(-1, keepdim=True)).to(q.dtype)
