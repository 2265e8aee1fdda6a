"""Named collectives of a per-rank program.

A per-rank step all-reduces a tree of gradients from one Python loop over
its leaves: one line, run once a leaf.  The JAX package's
``tree_map(psum)`` unrolls that loop at trace time, so each leaf is a
collective site of its own there.  :func:`mean_over` issues one all-reduce
a leaf under :func:`site_scope` of the leaf's path, and the collective
census (``repro_torch.hooks.scanner``) keys a site by the issuing line and
by :func:`scope_prefix`, so each leaf is a site of its own here too, while
a plain Python loop of collectives stays one site with its trip count.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List

import torch.distributed as dist


class _Scope(threading.local):
    def __init__(self):
        self.names: List[str] = []


_SCOPE = _Scope()


@contextlib.contextmanager
def site_scope(name: str):
    """Name the collectives issued inside: each scope is a site of its own
    (the loops JAX unrolls at trace time)."""
    _SCOPE.names.append(name)
    try:
        yield
    finally:
        _SCOPE.names.pop()


def scope_prefix() -> str:
    """The current scopes, outermost first, each followed by "/"."""
    return "".join(s + "/" for s in _SCOPE.names)


def mean_over(tree: Dict[str, Any], group, size: int,
              scope: str) -> Dict[str, Any]:
    """Every leaf all-reduced (SUM) over ``group`` in place, one site a
    leaf named ``scope/<path>``, then divided by ``size`` — the explicit
    collective boundary, the svc of a per-rank program."""
    out = {}
    for k, x in tree.items():
        path = f"{scope}/{k}"
        if isinstance(x, dict):
            out[k] = mean_over(x, group, size, path)
            continue
        with site_scope(path):
            dist.all_reduce(x, group=group)
        out[k] = x.div_(size)
    return out
