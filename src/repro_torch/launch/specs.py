"""Sharded stand-ins for every (arch x shape) cell: the JAX package's
``launch/specs.py``.

JAX's ``ShapeDtypeStruct`` with a ``NamedSharding`` becomes a ``DTensor``
whose local tensor is a fake tensor of this rank's shard
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes, no
memory), with the global shape and stride.  Call these inside the
``FakeTensorMode`` the step will run under.  Model and optimizer state
come from the real init functions run under that mode (``jax.eval_shape``'s
place), inputs are made directly, and placements come from the logical
rules in :mod:`repro_torch.parallel.sharding`.

A :class:`Sharding` is ``NamedSharding``'s place: a mesh and the
placements of a spec on it (:func:`placements`, ``_named``'s
counterpart).  The decode position is a Python int (``seq_len - 1``), not
a tensor: the port's ``decode_step`` takes a host int, and a
data-dependent ``int()`` of a fake tensor raises.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..configs.base import ModelConfig, RunConfig, ShapeConfig
from ..models import lm
from ..parallel import sharding as shd
from ..parallel.sharding import P, placements
from ..train.step import init_train_state


class Sharding(NamedTuple):
    """A mesh and a spec's placements on it."""

    mesh: Any
    placements: list


def _named(mesh, spec) -> Sharding:
    return Sharding(mesh, placements(mesh, spec))


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def sds(shape, dtype, sharding: Sharding, device) -> torch.Tensor:
    """A DTensor of global ``shape`` whose local tensor is this rank's
    shard, empty (fake under ``FakeTensorMode``).  Shards may be uneven:
    the local shape is DTensor's own for this rank."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape = tuple(shape)
    local, _ = compute_local_shape_and_global_offset(
        shape, sharding.mesh, sharding.placements, skip_offset=True)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local, dtype=dtype, device=device),
                              sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                device) -> Dict[str, Any]:
    """Input stand-ins for one step (train/prefill batches)."""
    gb, seq = shape.global_batch, shape.seq_len
    bsh2 = _named(mesh, P(shd.data_axes(), None, None))
    out: Dict[str, Any] = {}
    npfx = 0
    if cfg.frontend is not None and cfg.kind != "encdec":
        npfx = seq // cfg.frontend_len_div
        out["prefix_emb"] = sds((gb, npfx, cfg.d_model), torch.float32,
                                bsh2, device)
    if cfg.kind == "encdec":
        out["enc_emb"] = sds((gb, seq // cfg.frontend_len_div, cfg.d_model),
                             torch.float32, bsh2, device)
    out["tokens"] = sds((gb, seq - npfx), torch.int32,
                        _named(mesh, P(shd.data_axes(), None)), device)
    return out


def state_shapes(cfg: ModelConfig, run: RunConfig, device) -> Any:
    """The train state's (global) tensors from the real init, drawn in the
    current ``FakeTensorMode``: shapes only."""
    return init_train_state(cfg, run, torch.Generator(device))


def state_shardings(cfg: ModelConfig, run: RunConfig, mesh,
                    state_tree: Any) -> Any:
    pspecs = shd.param_specs(state_tree["params"])

    def to_sh(spec):
        return _named(mesh, spec)

    out = {"params": _tree_map(to_sh, pspecs),
           "opt": {"m": _tree_map(to_sh, pspecs),
                   "v": _tree_map(to_sh, pspecs),
                   "step": _named(mesh, P())}}
    if "ef" in state_tree:
        out["ef"] = _tree_map(to_sh, pspecs)
    return out


def with_shardings(tree, shardings):
    """Each leaf of ``tree`` (global tensors) as a DTensor of its
    sharding."""
    return _tree_map(lambda t, s: sds(t.shape, t.dtype, s, t.device),
                     tree, shardings)


def train_inputs(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig, mesh,
                 device):
    """(state, batch, state_shardings) for tracing train_step."""
    st = state_shapes(cfg, run, device)
    sh = state_shardings(cfg, run, mesh, st)
    return (with_shardings(st, sh), batch_specs(cfg, shape, mesh, device),
            sh)


def _strip_data_axes(spec) -> P:
    drop = set(shd.data_axes())

    def keep(e):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a not in drop)
            return kept if kept else None
        return None if e in drop else e

    return P(*(keep(e) for e in spec))


def _n_data(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for ax in shd.data_axes():
        n *= sizes.get(ax, 1)
    return n


def _params(cfg: ModelConfig, run: RunConfig, mesh, device):
    st = state_shapes(cfg, run, device)
    psh = _tree_map(lambda s: _named(mesh, s),
                    shd.param_specs(st["params"]))
    return with_shardings(st["params"], psh), psh


def decode_inputs(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig, mesh,
                  device):
    """(params, cache, tokens, pos, param_shardings, cache_shardings) for
    tracing decode_step; ``pos`` is the host int ``seq_len - 1``."""
    params, psh = _params(cfg, run, mesh, device)
    gb, seq = shape.global_batch, shape.seq_len
    cache = lm.init_decode_cache(cfg, gb, seq, device=device)
    cspecs = shd.cache_spec(cfg, cache)
    if gb % _n_data(mesh) != 0:
        # batch too small to data-shard (long_500k, gb=1): replicate batch,
        # TP still shards heads/state width
        cspecs = _tree_map(_strip_data_axes, cspecs)
        tok_spec = P(None, None)
    else:
        tok_spec = P(shd.data_axes(), None)
    csh = _tree_map(lambda s: _named(mesh, s), cspecs)
    cache = with_shardings(cache, csh)
    tokens = sds((gb, 1), torch.int32, _named(mesh, tok_spec), device)
    return params, cache, tokens, seq - 1, psh, csh


def prefill_inputs(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig,
                   mesh, device):
    """(params, batch, param_shardings) for tracing prefill_step."""
    params, psh = _params(cfg, run, mesh, device)
    return params, batch_specs(cfg, shape, mesh, device), psh

