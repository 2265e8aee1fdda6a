"""AdamW (decoupled weight decay) + cosine/warmup schedule + global clip
(the JAX package's ``repro.optim.adamw``, on nested dicts of tensors).

The moments are f32.  The JAX function returns new trees and its step
donates the old ones; here :func:`adamw_update` writes the new parameters
and moments into the tensors it was given, under ``torch.no_grad()``, and
returns those same trees — the in-place update stands for the donation.
On CPU tensors the multiply-adds XLA contracts (``b1 * m + (1 - b1) * g``,
``p - lr * delta``, ...) are single roundings (:func:`numerics.muladd`),
and the sums of the global norm run in XLA's order for a row
(:func:`numerics.sum_product` over each flattened leaf), which is its
order for a vector leaf; on the card they are PyTorch's operations.
Leaves are visited in sorted-key order, the JAX package's tree order.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .. import numerics
from ..configs.base import RunConfig

Tree = Any


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves of a nested dict, keys sorted (``jax.tree_util``'s
    order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` on the leaves of ``tree`` and of the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def init_opt_state(params: Tree) -> Dict[str, Any]:
    """Zero f32 moments beside each parameter and a step count of 0 (an
    int32 scalar on the parameters' device)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _f32(x) -> np.float32:
    return np.float32(x)


def lr_at(run: RunConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): a linear warmup to
    ``run.learning_rate`` over ``warmup_steps``, then a half cosine to 0 at
    ``total_steps``; f32, with the constants folded as XLA folds them
    (a division by a constant is a multiply by its f32 reciprocal, and
    ``lr * (s + 1) / w`` is ``(s + 1) * f32(lr * f32(1 / w))``).  Within an ulp of the JAX
    package's (its cosine)."""
    step = step.float()
    w = max(run.warmup_steps, 1)
    warm = (step + 1.0) * float(_f32(run.learning_rate) * (_f32(1) / _f32(w)))
    inv = float(_f32(1) / _f32(max(run.total_steps - run.warmup_steps, 1)))
    prog = torch.clamp((step - run.warmup_steps) * inv, 0.0, 1.0)
    # the cosine correctly rounded (via f64): XLA's own differs from it by
    # an ulp at ~1 % of arguments
    turn = torch.cos((float(_f32(math.pi)) * prog).double()).float()
    cos = (turn + 1.0) * float(_f32(0.5 * run.learning_rate))
    return torch.where(step < run.warmup_steps, warm, cos)


def _sum_sq(x) -> torch.Tensor:
    x = x.float()
    if not numerics.exact_forms(x):
        # the card's sum_product over the leaf unflattened (a contiguous
        # tensor reduces as one row all the same; a DTensor sharded over
        # two mesh axes does not flatten)
        return (x * x).sum()
    x = x.reshape(-1)
    return numerics.sum_product(x, x, 0)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (f32)."""
    sums = torch.stack([_sum_sq(x) for x in tree_leaves(tree)])
    return numerics.sqrt(numerics.sum_product(sums, torch.ones_like(sums),
                                              0))


def clip_by_global_norm(grads: Tree, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), the norm)."""
    gn = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-12), 1.0)
    return tree_map(lambda g: g * scale, grads), gn


_NO_DECAY_SUFFIXES = ("ln1", "ln2", "ln_x", "norm", "final_norm", "enc_norm",
                      "q_norm", "k_norm", "lam", "b_r", "b_i", "bf", "bi",
                      "bq", "bk", "bv")


def _decay_mask(params: Tree) -> Tree:
    """1.0 where weight decay applies, 0.0 on a leaf named in
    ``_NO_DECAY_SUFFIXES`` (norms, gate biases, the RG-LRU's Lambda)."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return 0.0 if name in _NO_DECAY_SUFFIXES else 1.0

    return walk(params, "")


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, opt: Dict[str, Any],
                 run: RunConfig) -> Tuple[Tree, Dict[str, Any],
                                          Dict[str, Any]]:
    """One AdamW step: clip the gradients by their global norm, update the
    moments and the parameters in place.  Returns (params, opt, {"lr",
    "grad_norm"}), the trees those given."""
    grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
    opt["step"].add_(1)
    step = opt["step"].float()
    lr = lr_at(run, opt["step"])
    b1, b2, eps = run.b1, run.b2, run.eps
    # filled on the device: a tensor made from a host scalar is a copy
    # that waits for the card
    bc1, bc2 = (1.0 - torch.pow(torch.full((), b, dtype=torch.float32,
                                           device=step.device), step)
                for b in (b1, b2))
    mask = _decay_mask(params)

    def upd(p, g, m, v, wd_on):
        g = g.float()
        m.copy_(numerics.muladd(b1, m, (1 - b1) * g))
        v.copy_(numerics.muladd(b2, v, (1 - b2) * g * g))
        # (m / bc1) / (sqrt(v / bc2) + eps), as XLA rewrites it
        adam = m / (bc1 * (numerics.sqrt(v / bc2) + eps))
        delta = numerics.muladd(run.weight_decay * wd_on, p, adam)
        p.copy_(numerics.muladd(-lr, delta, p).to(p.dtype))

    for p, g, m, v, w in zip(*(tree_leaves(t) for t in (
            params, grads, opt["m"], opt["v"], mask))):
        upd(p, g, m, v, w)
    return params, opt, {"lr": lr, "grad_norm": gnorm}
