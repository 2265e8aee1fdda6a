"""Collective census — the linear-scan disassembly of the adaptation (the
JAX package's ``repro.hooks.scanner``).

The JAX package walks a traced jaxpr.  PyTorch has no program to walk
before it runs, so :func:`census_fn` records one run of the function
under the hook, on clones of its tensor arguments (the port's train
steps update their state in place; a clone leaves the caller's state as
it was and runs the real collectives, which fake tensors do not accept).

A *site* is a collective primitive issued from one place: the user frame
that issued it (its file and line, the first frame outside ``torch/`` and
this package) under the current
``repro_torch.parallel.collectives.site_scope``.  ``loop_trip`` is how
many times the site ran, so the body of a Python loop of three is one
site with trip 3, as ``lax.scan``'s body is in JAX.  A Python loop that
JAX unrolls at trace time — a ``tree_map`` over gradient leaves — names
each iteration with ``site_scope`` (``parallel.collectives.mean_over``
does) so each is a site of its own, as each is an equation of its own in
the jaxpr.

Primitive names are the hook's: "psum", "pmax", "pmin", "all_gather",
"reduce_scatter", "all_to_all" (JAX's census canonicalises its legacy
"psum2" to "psum_invariant", the name a psum takes inside a shard_map
that checks replication; a per-rank program has no such variant).
``scan_jaxpr`` has no counterpart.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Callable, Dict, List

import torch

from ..parallel.collectives import scope_prefix
from .interceptor import COLLECTIVE_PRIMS, hooking

_SKIP_DIRS = (os.path.dirname(torch.__file__) + os.sep,
              os.path.dirname(os.path.abspath(__file__)) + os.sep)


@dataclasses.dataclass
class CollectiveSite:
    primitive: str
    path: str                 # e.g. "grads/embed/tok/collectives.py:57/psum"
    in_shapes: tuple
    in_bytes: int
    loop_trip: int            # times the site ran in the recorded run
    params: Dict[str, Any]


def _user_frame():
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename.startswith(_SKIP_DIRS):
        f = f.f_back
    return f


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


class _Recorder:
    """A pass-through handler that files each call under its site."""

    def __init__(self):
        self.sites: Dict[tuple, CollectiveSite] = {}
        self.bytes_run = 0

    def __call__(self, name, args, params, do_original):
        f = _user_frame()
        where = (f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
                 if f is not None else "?")
        scope = scope_prefix()
        key = (name, where, scope)
        nbytes = sum(a.numel() * a.element_size() for a in args)
        self.bytes_run += nbytes
        site = self.sites.get(key)
        if site is None:
            self.sites[key] = CollectiveSite(
                primitive=name, path=f"{scope}{where}/{name}",
                in_shapes=tuple(tuple(a.shape) for a in args),
                in_bytes=nbytes, loop_trip=1,
                params={k: v for k, v in params.items()
                        if isinstance(v, (int, str, bool, tuple))})
        else:
            site.loop_trip += 1
        return do_original()


def census_fn(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run fn once under the hook, on clones of its tensor arguments, and
    summarise its collective population (Table-1 analogue)."""
    args, kwargs = _clone(args), _clone(kwargs)
    rec = _Recorder()
    with hooking({name: rec for name in COLLECTIVE_PRIMS}):
        fn(*args, **kwargs)
    sites = list(rec.sites.values())
    by_prim: Dict[str, int] = {}
    for s in sites:
        by_prim[s.primitive] = by_prim.get(s.primitive, 0) + 1
    return {
        "total_sites": len(sites),
        "by_primitive": by_prim,
        "payload_bytes_static": sum(s.in_bytes for s in sites),
        "payload_bytes_per_step": rec.bytes_run,
        "sites": sites,
    }
