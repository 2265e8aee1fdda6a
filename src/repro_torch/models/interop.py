"""Carry model parameters across frameworks as numpy arrays.

A nested dict of numpy arrays (``jax.tree.map(np.asarray, params)`` of the
JAX package's ``init_params`` tree gives one) becomes the port's tree of
tensors on a device, leaf for leaf and with the same dtypes, and back —
every subtree, the stacked ``tiles``, the ``tail`` blocks and the RG-LRU
``lam`` included.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.machine import resolve_device


def params_from_numpy(tree: Mapping, device=None) -> dict:
    """The port's parameter tree on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        # np.array copies: the tensor never aliases the caller's buffer
        return torch.from_numpy(np.array(node)).to(dev)

    return conv(tree)


def params_to_numpy(tree: Mapping) -> dict:
    """Host copies of every leaf, as a nested dict of numpy arrays."""
    return {k: params_to_numpy(v) if isinstance(v, Mapping)
            else v.detach().cpu().numpy() for k, v in tree.items()}
