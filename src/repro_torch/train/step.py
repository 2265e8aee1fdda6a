"""Train / serve step builders (the JAX package's ``repro.train.step``).

``make_train_step`` is the JAX package's auto-SPMD step on one device:
the loss's gradient (``torch.autograd.grad``; ``microbatch`` > 1
accumulates the microbatches' gradients in f32, a loop for JAX's
``lax.scan``), optional ``param_wire_bf16`` (the parameters cast to bf16
before use, the gradient taken through the cast), optional error-feedback
compression (``int8_ef``, ``bf16_ef``), then AdamW.  The step runs the
model's plain forms on every device (:func:`lm.loss_fn` enters
:func:`repro_torch.models.layers.xla_route`): no kernel has a backward,
in the JAX package either, so ``attn_impl="pallas"`` raises.  The state
(parameters, moments, step count, EF residuals) is updated in place and
returned — the in-place update stands for JAX's donated state.

``make_ddp_train_step`` is the JAX package's shard_map step, written per
rank: each rank's gradient of its shard of the batch, then an *explicit*
all-reduce (``torch.distributed``) of every gradient leaf and every
metric over the mesh's ``data`` group, divided by the group's size.
Functionally the same as ``make_train_step`` on the whole batch; it
exists so the collective boundary is visible to the hooks
(:mod:`repro_torch.hooks`: tracing, compression, schedule rewrite), one
site a leaf as JAX's ``tree_map(psum)`` gives.

While a profiler runs, both steps record the span ``train.step`` and its
children ``train.forward`` (``lm.loss_fn``), ``train.backward`` (the
gradient and its tree) and ``train.optimizer`` (AdamW, with its
CUDA-event time on the card) (:mod:`repro_torch.obs`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from .. import obs
from ..configs.base import ModelConfig, RunConfig
from ..models import lm
from ..optim import compress as compress_lib
from ..optim.adamw import (adamw_update, init_opt_state, tree_leaves,
                           tree_map)
from ..parallel.collectives import mean_over
from ..parallel.sharding import constrain_like

METRICS = ("ce", "z_loss", "aux", "loss")


def init_train_state(cfg: ModelConfig, run: RunConfig,
                     gen: torch.Generator) -> Dict[str, Any]:
    """Parameters drawn from ``gen`` (on its device), zero AdamW moments,
    and zero EF residuals under ``int8_ef``/``bf16_ef``."""
    params = lm.init_params(cfg, gen)
    state = {"params": params, "opt": init_opt_state(params)}
    if run.grad_compression in ("int8_ef", "bf16_ef"):
        state["ef"] = compress_lib.init_ef_state(params)
    return state


def grads_and_metrics(cfg: ModelConfig, run: RunConfig, params, batch):
    """(f32 gradient tree, detached metrics) of ``lm.loss_fn`` at
    ``params`` (whose tensors are left as they are).  Every floating leaf
    must be reached: a graph cut short raises rather than train on
    zeros."""
    leaf = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)
    p = leaf
    if run.param_wire_bf16:
        p = tree_map(lambda x: x.to(torch.bfloat16)
                     if x.dtype == torch.float32 else x, leaf)
    with obs.span("train.forward"):
        loss, metrics = lm.loss_fn(cfg, run, p, batch)
    with obs.span("train.backward"):
        wrt = [x for x in tree_leaves(leaf) if x.requires_grad]
        got = dict(zip(map(id, wrt), torch.autograd.grad(loss, wrt)))
        # on a mesh's DTensors each gradient is reduced to its parameter's
        # layout, as JAX's partitioner lays out the gradient of a donated
        # state
        grads = tree_map(lambda x: constrain_like(got[id(x)].float(), x)
                         if x.requires_grad
                         else torch.zeros_like(x, dtype=torch.float32), leaf)
    return grads, {k: metrics[k].detach() for k in METRICS}


def make_train_step(cfg: ModelConfig, run: RunConfig) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: metrics ``ce``,
    ``z_loss``, ``aux``, ``loss`` (microbatch means), ``lr`` and
    ``grad_norm`` (before clipping), 0-d tensors."""
    if run.attn_impl != "xla":
        raise ValueError(f"attn_impl={run.attn_impl!r}: no kernel has a "
                         "backward; the train step runs the XLA route")

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        with obs.span("train.step"):
            return _step(state, batch)

    def _step(state, batch):
        params = state["params"]
        mb = run.microbatch
        if mb > 1:
            def split(x, i):
                b = x.shape[0]
                if b % mb:
                    raise ValueError(f"batch {b} is not a multiple of "
                                     f"microbatch {mb}")
                return x.reshape(mb, b // mb, *x.shape[1:])[i]

            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            metrics = {k: torch.zeros((), dtype=torch.float32,
                                      device=tree_leaves(params)[0].device)
                       for k in METRICS}
            for i in range(mb):
                g, m = grads_and_metrics(cfg, run, params,
                              {k: split(x, i) for k, x in batch.items()})
                grads = tree_map(torch.add, grads, g)
                metrics = {k: metrics[k] + m[k] for k in METRICS}
            grads = tree_map(lambda g: g / mb, grads)
            metrics = {k: v / mb for k, v in metrics.items()}
        else:
            grads, metrics = grads_and_metrics(cfg, run, params, batch)
        new_state = dict(state)
        if "ef" in state:
            codec = "int8" if run.grad_compression == "int8_ef" else "bf16"
            grads, new_state["ef"] = compress_lib.compress_grads(
                grads, state["ef"], codec)
        with obs.span("train.optimizer", device=True):
            params, opt, opt_metrics = adamw_update(params, grads,
                                                    state["opt"], run)
        new_state.update(params=params, opt=opt)
        return new_state, {**metrics, **opt_metrics}

    return train_step


def make_ddp_train_step(cfg: ModelConfig, run: RunConfig, mesh,
                        data_axis: str = "data") -> Callable:
    """Per-rank data-parallel step with an explicit (hookable) gradient
    all-reduce.  ``train_step(state, batch)`` takes the global batch, as
    the JAX package's shard_map does, and runs this rank's rows of it
    (its place along ``mesh``'s ``data_axis``); parameters and optimizer
    state are replicated and updated in place."""
    if run.attn_impl != "xla":
        raise ValueError(f"attn_impl={run.attn_impl!r}: no kernel has a "
                         "backward; the train step runs the XLA route")
    group = mesh.get_group(data_axis)
    n_data = mesh.size(mesh.mesh_dim_names.index(data_axis))
    rank = mesh.get_local_rank(data_axis)
    # the JAX package's DDP loss takes the parameters as they are
    local_run = dataclasses.replace(run, param_wire_bf16=False)

    def shard(x):
        b = x.shape[0]
        if b % n_data:
            raise ValueError(f"batch {b} is not a multiple of the {n_data} "
                             f"ranks of {data_axis!r}")
        w = b // n_data
        return x[rank * w:(rank + 1) * w]

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        with obs.span("train.step"):
            return _step(state, batch)

    def _step(state, batch):
        local = {k: shard(x) for k, x in batch.items()}
        grads, metrics = grads_and_metrics(cfg, local_run, state["params"],
                                           local)
        grads = mean_over(grads, group, n_data, "grads")
        metrics = mean_over(metrics, group, n_data, "metrics")
        new_state = dict(state)
        if "ef" in state:
            codec = "int8" if run.grad_compression == "int8_ef" else "bf16"
            grads, new_state["ef"] = compress_lib.compress_grads(
                grads, state["ef"], codec)
        with obs.span("train.optimizer", device=True):
            params, opt, opt_metrics = adamw_update(state["params"], grads,
                                                    state["opt"], run)
        new_state.update(params=params, opt=opt)
        return new_state, {**metrics, **opt_metrics}

    return train_step


def make_serve_steps(cfg: ModelConfig, run: RunConfig):
    """(prefill_fn, decode_fn) for the serving engine."""

    def prefill_step(params, batch):
        return lm.prefill(cfg, run, params, batch)

    def decode_step(params, cache, tokens, pos):
        return lm.decode_step(cfg, run, params, cache, tokens, pos)

    return prefill_step, decode_step
