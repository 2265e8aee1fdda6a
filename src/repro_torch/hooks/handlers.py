"""Shipped hook handlers — the framework's first-class interception
features (the JAX package's ``repro.hooks.handlers``).

* ``TraceHandler``     — telemetry: counts sites + payload bytes, then runs
  the original operator unchanged (transparent, like the paper's counting
  hook).
* ``CastCompressHandler`` — gradient compression: cast the all-reduce
  payload to a narrower dtype on the wire (bf16/f16), halving collective
  bytes.  Designed to pair with optimizer-level error feedback
  (repro_torch.optim.compress).
* ``RSAGHandler``      — schedule rewrite: all-reduce -> reduce_scatter +
  all_gather through the group's own collectives, the ZeRO trick; same
  semantics, different collective mix.
* ``virtualize``       — the Table-3-style hook: skip the collective
  entirely and return a supplied value (isolates the hook's cost).

The JAX package's RSAG has a second branch for older jax versions, a psum
of the zero-padded chunk, because their shard_map learns replication only
from psum; a per-rank program has no replication types, so that branch
has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist

# the single-tensor gather and scatter under this torch's names (the
# *_into_tensor/*_tensor spellings are deprecated in newer releases)
_all_gather = getattr(dist, "all_gather_single", None) or (
    dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or (
    dist.reduce_scatter_tensor)


@dataclasses.dataclass
class TraceRecord:
    primitive: str
    shapes: Tuple
    bytes: int


class TraceHandler:
    """Counting hook: transparent pass-through + site log."""

    def __init__(self):
        self.records: List[TraceRecord] = []

    def __call__(self, name, args, params, do_original):
        nbytes = sum(a.numel() * a.element_size() for a in args)
        self.records.append(TraceRecord(name, tuple(tuple(a.shape)
                                                    for a in args), nbytes))
        return do_original()

    @property
    def count(self) -> int:
        return len(self.records)

    @property
    def total_bytes(self) -> int:
        return sum(r.bytes for r in self.records)


class CastCompressHandler:
    """Compress the wire payload of an all-reduce by casting to
    ``wire_dtype``.

    The quantisation error is the caller's to feed back (error feedback
    lives in the optimizer state — see repro_torch.optim.compress) so the
    hook itself stays stateless and shape-transparent.
    """

    def __init__(self, wire_dtype=torch.bfloat16, min_bytes: int = 1 << 16):
        self.wire_dtype = wire_dtype
        self.min_bytes = min_bytes
        self.compressed_sites = 0

    def __call__(self, name, args, params, do_original):
        new_args = []
        for a in args:
            big = a.dtype == torch.float32 and a.numel() * 4 >= self.min_bytes
            if big:
                self.compressed_sites += 1
                new_args.append(a.to(self.wire_dtype))
            else:
                new_args.append(a)
        out = do_original(*new_args)
        flat = out if isinstance(out, tuple) else (out,)
        fixed = tuple(o.to(torch.float32) if o.dtype == self.wire_dtype
                      else o for o in flat)
        return fixed if isinstance(out, tuple) else fixed[0]


class RSAGHandler:
    """all-reduce -> all_gather(reduce_scatter(x)): same result, ZeRO
    schedule.

    Payloads whose leading dim is divisible by the axis size take the
    RS+AG path, through the collectives of the group the all-reduce was
    issued on; everything else falls through to the original operator.
    """

    def __init__(self, axis_size: int):
        self.axis_size = axis_size
        self.rewritten = 0

    def __call__(self, name, args, params, do_original):
        if len(args) != 1:
            return do_original()
        (x,) = args
        n = self.axis_size
        if x.dim() == 0 or x.shape[0] % n != 0:
            return do_original()
        self.rewritten += 1
        group = params["group"]
        x = x.contiguous()
        scattered = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        _reduce_scatter(scattered, x, group=group)
        full = torch.empty_like(x)
        _all_gather(full, scattered, group=group)
        return full


def virtualize(value_fn: Callable[[Tuple], Any]):
    """Return a handler that skips the collective and fabricates the result
    (the 'hook returns a virtual value' microbenchmark of Table 3)."""

    def handler(name, args, params, do_original):
        return value_fn(args)

    return handler
