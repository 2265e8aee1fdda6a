"""Mixture-of-Experts FFN: token-choice top-k routing with capacity
(PyTorch port of the JAX package's ``models/moe.py``).

The JAX function vmaps every routing step over the batch rows; here the
rows are one leading dimension of every tensor, and no sort, rank or
gather crosses it.  Per row:

* router logits in bf16, cast to f32; softmax; the top k experts, the
  lower expert id first among equal probabilities (``lax.top_k``'s order,
  here a stable descending sort), their weights renormalised;
* the S * k (token, expert) slots stably sorted by expert; a slot's rank
  within its expert past the capacity ``C = ceil(cf * S * k / E)``
  drops it (its output is the residual alone);
* the dispatch buffer (E, C, d): position (e, c) holds the token of
  expert e's c-th slot, zero where the expert has fewer;
* the experts' SwiGLU products, one expert at a time
  (``RunConfig.moe_expert_scan``, the default) or batched over experts;
* the combine: each token's k weighted outputs (zero where dropped)
  summed in bf16 from zero in ascending expert id — the order of the JAX
  function's scatter-add over the expert-sorted slots — as a gather and a
  left-to-right sum, deterministic on both devices (a CUDA ``index_add_``
  adds in no fixed order);
* the auxiliary loss: the switch load-balance loss plus the router
  z-loss, averaged over the rows.

The shared experts (``n_shared``) are one MLP of their summed width.  The
expert stacks are cast to bf16 at every call, as the JAX function does.
The router, the products and the combine are PyTorch operations on both
devices: no kernel of the JAX package computes them.  On CPU tensors the
softmax, its sums and every product round as XLA's CPU backend does
(:mod:`repro_torch.numerics`, :func:`layers.dot`).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import numerics
from ..configs.base import ModelConfig, MoeConfig
from .layers import act_fn, apply_mlp, dense_init, dot, init_mlp


def init_moe(cfg: ModelConfig, gen: torch.Generator, *, lead=()) -> dict:
    e = cfg.moe
    d = cfg.d_model
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, lead + (d, e.n_experts), scale=0.02),
        # stacked expert weights: (E, d, ffe) / (E, ffe, d)
        "w1": dense_init(gen, lead + (e.n_experts, d, e.d_ff_expert)),
        "w2": dense_init(gen, lead + (e.n_experts, e.d_ff_expert, d)),
        "w3": dense_init(gen, lead + (e.n_experts, d, e.d_ff_expert)),
    }
    if e.n_shared:
        p["shared"] = init_mlp(cfg, gen, lead=lead,
                               d_ff=e.n_shared * e.d_ff_expert)
    return p


def capacity(e: MoeConfig, seq: int) -> int:
    return int(np.ceil(e.capacity_factor * seq * e.top_k / e.n_experts))


class Routing(NamedTuple):
    """One call's routing, every tensor with a leading row dimension."""

    logits: torch.Tensor   # (B, S, E) f32 router logits
    probs: torch.Tensor    # (B, S, E) f32 softmax
    top_e: torch.Tensor    # (B, S, k) int64 experts, best first
    top_w: torch.Tensor    # (B, S, k) f32 renormalised weights
    slot: torch.Tensor     # (B, S, k) int64 dispatch slot e * C + rank
    keep: torch.Tensor     # (B, S, k) bool: within the expert's capacity
    first: torch.Tensor    # (B, E) int64 first sorted slot of each expert
    stok: torch.Tensor     # (B, S * k) int64 token of each sorted slot
    C: int                 # capacity a row


def _row_sum(x):
    """Sum over the last axis, keeping it: XLA's CPU order on CPU tensors
    (:func:`numerics.sum_product` with ones), PyTorch's on the card."""
    return numerics.sum_product(x, torch.ones_like(x), -1)[..., None]


def _softmax(x):
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum."""
    u = numerics.exp(x - x.amax(-1, keepdim=True))
    return u / _row_sum(u)


def router(cfg: ModelConfig, p: dict, x):
    """The router's (logits, probabilities), f32, for x (B, S, d) bf16:
    the logits computed in bf16 and cast, then the softmax."""
    logits = dot(x, p["router"].to(x.dtype)).float()
    return logits, _softmax(logits)


def route(cfg: ModelConfig, p: dict, x) -> Routing:
    """The router and the dispatch plan for x (B, S, d) bf16."""
    logits, probs = router(cfg, p, x)
    # lax.top_k: the larger first, the lower index first among equals
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_w, top_e = srt.values[..., :k], srt.indices[..., :k]
    return plan(cfg, logits, probs, top_e, top_w / _row_sum(top_w))


def plan(cfg: ModelConfig, logits, probs, top_e, top_w) -> Routing:
    """The dispatch plan of chosen experts ``top_e`` (B, S, k) and their
    renormalised weights: the slots stably sorted by expert, each slot's
    rank within its expert, the capacity cut."""
    e = cfg.moe
    B, S, k = top_e.shape
    E = e.n_experts
    C = capacity(e, S)
    flat_e = top_e.reshape(B, S * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = flat_e.gather(1, order)
    stok = order // k                      # token of each sorted slot
    experts = torch.arange(E, device=top_e.device).expand(B, E).contiguous()
    first = torch.searchsorted(se, experts, right=False)    # (B, E)
    rank_sorted = (torch.arange(S * k, device=top_e.device)
                   - first.gather(1, se))
    # back to each (token, choice) slot's own place
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank, E * C)
    return Routing(logits, probs, top_e, top_w, slot.reshape(B, S, k),
                   keep.reshape(B, S, k), first, stok, C)


def _dispatch(r: Routing, x, E: int):
    """The (B, E, C, d) buffer: expert e's c-th sorted slot's token at
    (e, c), zero past the expert's count (a gather: no scatter, so no
    order among writes to one place)."""
    B, S, d = x.shape
    C = r.C
    last = torch.cat([r.first[:, 1:], torch.full_like(r.first[:, :1],
                                                      r.stok.shape[1])], 1)
    src = r.first[:, :, None] + torch.arange(C, device=x.device)  # (B,E,C)
    live = src < last[:, :, None]
    src = torch.where(live, src, 0).reshape(B, E * C)
    tok = r.stok.gather(1, src)                                    # (B,E*C)
    buf = x.gather(1, tok[:, :, None].expand(B, E * C, d))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    buf = torch.where(live.reshape(B, E * C, 1), buf, zero)
    return buf.reshape(B, E, C, d)


def _experts(cfg: ModelConfig, p: dict, buf, expert_scan: bool):
    """The SwiGLU expert products of the (B, E, C, d) buffer, in bf16."""
    act = act_fn(cfg.act)
    dt = buf.dtype
    w1, w2, w3 = (p[n].to(dt) for n in ("w1", "w2", "w3"))
    if expert_scan:
        # expert at a time: one expert's buffer live, E products each
        return torch.stack([
            dot(act(dot(buf[:, i], w1[i])) * dot(buf[:, i], w3[i]), w2[i])
            for i in range(buf.shape[1])], 1)
    # batched over experts: one product a projection
    xb = buf.transpose(0, 1)                                  # (E, B, C, d)
    h = act(dot(xb, w1[:, None])) * dot(xb, w3[:, None])
    return dot(h, w2[:, None]).transpose(0, 1)


def _combine(r: Routing, ybuf, S: int):
    """Each token's k weighted expert outputs (zero where dropped), summed
    in bf16 from +0 in ascending expert id: the JAX function's
    scatter-add over the expert-sorted slots, as a gather."""
    B, EC, d = ybuf.shape
    k = r.top_e.shape[-1]
    dt = ybuf.dtype
    slot = r.slot.reshape(B, S * k).clamp_max(EC - 1)
    y = ybuf.gather(1, slot[:, :, None].expand(B, S * k, d))
    zero = torch.zeros((), dtype=dt, device=ybuf.device)
    y = torch.where(r.keep.reshape(B, S * k, 1), y, zero)
    y = (y * r.top_w.reshape(B, S * k, 1).to(dt)).reshape(B, S, k, d)
    by_id = torch.argsort(r.top_e, dim=-1)                    # (B, S, k)
    y = y.gather(2, by_id[..., None].expand(B, S, k, d))
    acc = torch.zeros((B, S, d), dtype=dt, device=ybuf.device)
    for j in range(k):
        acc = acc + y[:, :, j]
    return acc


def _aux(cfg: ModelConfig, r: Routing):
    """Per row: the switch load-balance loss plus the router z-loss."""
    e = cfg.moe
    E = e.n_experts
    S = r.probs.shape[1]
    one_hot = torch.nn.functional.one_hot(r.top_e[..., 0], E).float()
    frac_tokens = one_hot.sum(1) / S
    frac_probs = r.probs.sum(1) / S
    lb_loss = E * (frac_tokens * frac_probs).sum(-1)
    lse = torch.logsumexp(r.logits, dim=-1)
    z_loss = (lse * lse).sum(-1) / S
    return e.lb_coef * lb_loss + e.router_z_coef * z_loss


def apply_moe(cfg: ModelConfig, p: dict, x,
              expert_scan: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) bf16 -> (y (B, S, d), the aux loss, an f32 scalar)."""
    e = cfg.moe
    B, S, d = x.shape
    r = route(cfg, p, x)
    buf = _dispatch(r, x, e.n_experts)
    ybuf = _experts(cfg, p, buf, expert_scan).reshape(B, e.n_experts * r.C,
                                                      d)
    y = _combine(r, ybuf, S)
    if e.n_shared:
        y = y + apply_mlp(cfg, p["shared"], x)
    return y, _aux(cfg, r).mean()


def drops(r: Routing) -> int:
    """Slots past their expert's capacity (a host sync)."""
    return int((~r.keep).sum())

