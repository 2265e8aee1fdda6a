"""Gradient compression with error feedback (EF-SGD style), the JAX
package's ``repro.optim.compress`` on nested dicts of tensors.

The residual between the true gradient and its compressed form is carried
in optimizer-adjacent state and re-injected next step, preserving
convergence.

Two codecs:
  * ``bf16``  — cast (2x bytes saved), negligible residual;
  * ``int8``  — per-tensor max-abs scaling (4x bytes saved), EF essential;
    rounding half to even (``torch.round``, as ``jnp.round``).
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .. import numerics
from .adamw import tree_leaves, tree_map

Tree = Any


def init_ef_state(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


_INV_127 = float(np.float32(1) / np.float32(127))


def _encode_int8(x):
    # XLA folds the division by 127 into a multiply by its f32 reciprocal
    scale = torch.clamp_min(x.abs().amax(), 1e-12) * _INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _decode_int8(q, scale):
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads: Tree, ef: Tree, codec: str = "int8"
                   ) -> Tuple[Tree, Tree]:
    """Returns (decoded compressed grads, new error-feedback state).

    The decoded value is what the optimizer sees (== what the wire carried);
    the residual goes back into ef.
    """
    if codec not in ("bf16", "int8"):
        raise ValueError(codec)

    def one(g, e):
        g32 = g.float() + e
        if codec == "bf16":
            sent = g32.to(torch.bfloat16).float()
            return sent, g32 - sent
        q, scale = _encode_int8(g32)
        # the residual's multiply-subtract is one rounding on XLA's CPU
        return _decode_int8(q, scale), numerics.muladd(-q.float(), scale, g32)

    pairs = tree_map(one, grads, ef)
    return (tree_map(lambda pair: pair[0], pairs),
            tree_map(lambda pair: pair[1], pairs))


def wire_bytes(grads: Tree, codec: str) -> int:
    """Bytes a gradient all-reduce moves per step under each codec."""
    per = {"none": 4, "bf16": 2, "int8": 1}[codec]
    return sum(x.numel() * per for x in tree_leaves(grads))
