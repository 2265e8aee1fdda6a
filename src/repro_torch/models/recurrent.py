"""Recurrent blocks of the PyTorch port: RG-LRU (RecurrentGemma) and xLSTM
(mLSTM, sLSTM).

The JAX package's ``models/recurrent.py``, with its names and dtypes.

RG-LRU: a diagonal linear recurrence h_t = a_t h_{t-1} +
sqrt(1 - a_t^2) (i_t x_t), a_t = exp(c r_t log sigmoid(Lambda)), after a
width-4 depthwise causal conv.  Projections and the gates' sigmoids are
bf16; softplus, exp and the scan are f32 (on CPU tensors rounded as the
JAX package's CPU backend rounds them, :mod:`repro_torch.numerics`).
Prefill and decode both run the scan through
:func:`repro_torch.kernels.rglru_scan.ops.rglru_scan` — on the card the
CUDA kernel, prefill from h0 = 0 and decode one step from the cached h
(the JAX model's prefill runs ``lax.associative_scan`` and its decode
``a h0 + b``, which the scan's plain version reproduces bit for bit).

mLSTM: matrix memory C (dh x dh per head, dh = 2 d / H after the
up-projection) with an exp input gate and a sigmoid forget gate, in the
chunkwise-parallel form; prefill from (C, n) = 0 and decode one step
from the cached state both go through
:func:`repro_torch.kernels.mlstm_chunk.ops.mlstm_chunk` — on the card the
CUDA kernels (the decode step in place, in the cache's tensors), on the
CPU the JAX model's ``mlstm_scan_chunked`` at ``run.mlstm_chunk``
(prefill) or 1 (decode).

sLSTM: exp-gated scalar memory with normaliser and max-stabiliser, a
Python loop over time (the JAX model's ``lax.scan``; no kernel computes
it there either), the products ``x_t W`` inside the step as there.  On
CPU tensors its f32 products, tanh, sigmoid and fused multiply-adds are
XLA's (:mod:`repro_torch.numerics`), so the CPU route equals the JAX
package bit for bit.

Inside :func:`repro_torch.models.layers.xla_route` (training) the scan and
the mLSTM take their plain versions on every device (``rglru_scan_ref``,
the chunked ``mlstm_chunk_ref`` at ``run.mlstm_chunk``): no kernel has a
backward.  The sLSTM is plain on every route; its XLA-exact arithmetic
on CPU tensors is differentiable (:mod:`repro_torch.numerics`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import numerics
from ..configs.base import ModelConfig
from ..kernels.mlstm_chunk.ops import mlstm_chunk
from ..kernels.mlstm_chunk.ref import mlstm_chunk_ref
from ..kernels.rglru_scan.ops import rglru_scan
from ..kernels.rglru_scan.ref import rglru_scan_ref
from ..loops import time_loop
from ..parallel import sharding
from .layers import (PARAM_DTYPE, dense_init, dot, gelu, merge_heads,
                     rms_norm, sigmoid, silu, split_heads, xla_active)

RGLRU_C = 8.0
CONV_WIDTH = 4


def init_rglru(cfg: ModelConfig, gen: torch.Generator, *, lead=()) -> dict:
    d, dr = cfg.d_model, cfg.rnn_width
    lead = tuple(lead)
    # Lambda init so that a = sigmoid(Lambda) in (0.9, 0.999)
    lam = np.linspace(0.9, 0.999, dr)
    lam = torch.from_numpy(np.log(lam / (1 - lam)).astype(np.float32))
    return {
        "w_x": dense_init(gen, lead + (d, dr)),       # value branch
        "w_gate": dense_init(gen, lead + (d, dr)),    # gelu gating branch
        "conv": dense_init(gen, lead + (CONV_WIDTH, dr), scale=0.3),
        "w_r": dense_init(gen, lead + (dr, dr)),      # recurrence gate
        "w_i": dense_init(gen, lead + (dr, dr)),      # input gate
        "b_r": torch.zeros(lead + (dr,), dtype=PARAM_DTYPE,
                           device=gen.device),
        "b_i": torch.zeros(lead + (dr,), dtype=PARAM_DTYPE,
                           device=gen.device),
        "lam": lam.to(gen.device).expand(lead + (dr,)).clone(),
        "w_down": dense_init(gen, lead + (dr, d)),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv, width CONV_WIDTH. x: (B, S, dr), w: (W, dr).

    state: (B, W-1, dr) previous taps for decode; returns (y, new_state)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros_like(x[:, :W - 1])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(W))
    return y, xp[:, -(W - 1):]


def _rglru_gates(p, xc):
    r = sigmoid(dot(xc, p["w_r"].to(xc.dtype)) + p["b_r"].to(xc.dtype))
    i = sigmoid(dot(xc, p["w_i"].to(xc.dtype)) + p["b_i"].to(xc.dtype))
    log_a_base = -numerics.softplus(-p["lam"].float())  # log sigmoid
    log_a = RGLRU_C * r.float() * log_a_base
    a = numerics.exp(log_a)
    beta = numerics.sqrt(torch.clamp_min(
        1.0 - numerics.exp(2.0 * log_a), 1e-12))
    return a, beta * (i.float() * xc.float())


def apply_rglru(cfg: ModelConfig, p: dict, x, cache=None):
    """x: (B, S, d). cache: {"h": (B, dr), "conv": (B, W-1, dr)} for decode.

    Returns (y (B,S,d), new_cache); the new cache's tensors are new."""
    dt = x.dtype
    xv = dot(x, p["w_x"].to(dt))
    gate = dot(x, p["w_gate"].to(dt))
    conv_state = None if cache is None else cache["conv"]
    xc, new_conv = _causal_conv(xv, p["conv"], conv_state)
    a, b = _rglru_gates(p, xc)
    if cache is None:
        h0 = torch.zeros_like(a[:, 0])
    else:
        h0 = cache["h"].float()
    h = (rglru_scan_ref if xla_active() else rglru_scan)(a, b, h0)
    y = gelu(gate) * h.to(dt)
    y = dot(y, p["w_down"].to(dt))
    return y, {"h": h[:, -1].contiguous(), "conv": new_conv.float()}


def init_rglru_cache(cfg: ModelConfig, batch: int, *, lead=(),
                     device=None) -> dict:
    dr, lead = cfg.rnn_width, tuple(lead)
    return {"h": torch.zeros(lead + (batch, dr), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, CONV_WIDTH - 1, dr),
                                dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# mLSTM (chunkwise parallel)
# ---------------------------------------------------------------------------

def init_mlstm(cfg: ModelConfig, gen: torch.Generator, *, lead=()) -> dict:
    d, H, lead = cfg.d_model, cfg.n_heads, tuple(lead)
    di = 2 * d  # xLSTM up-projection factor 2

    def full(fill):
        return torch.full(lead + (H,), fill, dtype=PARAM_DTYPE,
                          device=gen.device)

    return {
        "w_up": dense_init(gen, lead + (d, di)),
        "w_gate": dense_init(gen, lead + (d, di)),
        "wq": dense_init(gen, lead + (di, di)),
        "wk": dense_init(gen, lead + (di, di)),
        "wv": dense_init(gen, lead + (di, di)),
        "wi": dense_init(gen, lead + (di, H), scale=0.02),
        "wf": dense_init(gen, lead + (di, H), scale=0.02),
        "bf": full(3.0),  # open forget gates
        "bi": full(-2.0),
        "w_down": dense_init(gen, lead + (di, d)),
    }


def mlstm_scan_chunked(q, k, v, log_f, log_i, C0, n0, chunk: int, *,
                       out=None):
    """The JAX model's chunkwise mLSTM: q/k/v (B, S, H, dh), log_f/log_i
    (B, S, H) f32, (C0, n0) the state; returns (h f32, C, n), C and n in
    ``out`` when it is given.  The function
    :func:`repro_torch.kernels.mlstm_chunk.ops.mlstm_chunk` computes (its
    plain version on CPU tensors and inside the XLA route, the kernels on
    the card)."""
    if xla_active() and out is None:
        return mlstm_chunk_ref(q, k, v, log_f, log_i, C0, n0, chunk)
    return mlstm_chunk(q, k, v, log_f, log_i, C0, n0, chunk=chunk, out=out)


def apply_mlstm(cfg: ModelConfig, p: dict, x, cache=None, chunk: int = 256):
    """x: (B, S, d) -> (y, cache).  cache: {"C", "n"} for decode (one step
    from the cached state, chunk 1).  On the card the decode step writes
    the new state into the cache's own tensors and returns them; on the
    CPU (the JAX form) the new cache's tensors are new."""
    B, S, _ = x.shape
    H, dt = cfg.n_heads, x.dtype
    up = dot(x, p["w_up"].to(dt))
    gate = dot(x, p["w_gate"].to(dt))
    di = up.shape[-1]
    dh = di // H
    q = split_heads(dot(up, p["wq"].to(dt)), H, dh)
    k = split_heads(dot(up, p["wk"].to(dt)), H, dh)
    v = split_heads(dot(up, p["wv"].to(dt)), H, dh)
    log_f = -numerics.softplus(-(dot(up, p["wf"].to(dt)).float()
                                 + p["bf"].float()))
    log_i = torch.clamp_max(dot(up, p["wi"].to(dt)).float()
                            + p["bi"].float(), 10.0)
    if cache is None:
        C0 = torch.zeros((B, H, dh, dh), dtype=torch.float32,
                         device=x.device)
        n0 = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
    else:
        C0, n0, chunk = cache["C"], cache["n"], 1
    in_place = cache is not None and x.is_cuda and not xla_active()
    out = (C0, n0) if in_place else None
    h, C, n = mlstm_scan_chunked(q, k, v, log_f, log_i, C0, n0, chunk,
                                 out=out)
    y = merge_heads(h).to(dt) * silu(gate)
    return dot(y, p["w_down"].to(dt)), {"C": C, "n": n}


def init_mlstm_cache(cfg: ModelConfig, batch: int, *, lead=(),
                     device=None) -> dict:
    di, H, lead = 2 * cfg.d_model, cfg.n_heads, tuple(lead)
    dh = di // H
    return {"C": torch.zeros(lead + (batch, H, dh, dh), dtype=torch.float32,
                             device=device),
            "n": torch.zeros(lead + (batch, H, dh), dtype=torch.float32,
                             device=device)}


# ---------------------------------------------------------------------------
# sLSTM (sequential)
# ---------------------------------------------------------------------------

def init_slstm(cfg: ModelConfig, gen: torch.Generator, *, lead=()) -> dict:
    d, H, lead = cfg.d_model, cfg.n_heads, tuple(lead)
    dh = d // H

    def const(fill):
        return torch.full(lead + (d,), fill, dtype=PARAM_DTYPE,
                          device=gen.device)

    return {
        "wz": dense_init(gen, lead + (d, d)),
        "wi": dense_init(gen, lead + (d, d), scale=0.02),
        "wf": dense_init(gen, lead + (d, d), scale=0.02),
        "wo": dense_init(gen, lead + (d, d)),
        # block-diagonal recurrent weights, one (dh, dh) block per head
        "rz": dense_init(gen, lead + (H, dh, dh)),
        "ri": dense_init(gen, lead + (H, dh, dh), scale=0.02),
        "rf": dense_init(gen, lead + (H, dh, dh), scale=0.02),
        "ro": dense_init(gen, lead + (H, dh, dh)),
        "bf": const(3.0),
        "bi": const(0.0),
        "w_down": dense_init(gen, lead + (d, d)),
        "norm": const(1.0),
    }


def slstm_step(p, carry, xt, H: int):
    """One sLSTM step. carry: (c, n, m, h) each (B, d) f32; xt: (B, d)
    f32."""
    c, n, m, h = carry
    B, d = xt.shape
    # on a mesh's DTensors h is whole along d where it splits into heads
    # and merges back, forward and backward (its width may be sharded over
    # more ranks than there are heads)
    hb = sharding.constrain(h, sharding.data_axes(), None).reshape(
        B, H, d // H)

    def pre(w, r):
        return (numerics.einsum("bd,de->be", xt, p[w].float())
                + sharding.pin(numerics.einsum("bhd,hde->bhe", hb,
                                               p[r].float()).reshape(B, d)))

    z = numerics.tanh(pre("wz", "rz"))
    o = sigmoid(pre("wo", "ro"))
    li = pre("wi", "ri") + p["bi"].float()
    # log sigmoid
    lf = -numerics.softplus(-(pre("wf", "rf") + p["bf"].float()))
    m_new = torch.maximum(lf + m, li)
    decay = numerics.exp(lf + m - m_new)
    gate = numerics.exp(li - m_new)
    c_new = numerics.muladd(decay, c, gate * z)
    n_new = numerics.muladd(decay, n, gate)
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return c_new, n_new, m_new, h_new


def apply_slstm(cfg: ModelConfig, p: dict, x, cache=None):
    """x: (B, S, d) -> (y, cache {c, n, m, h}); the JAX model's
    ``lax.scan`` over time as a Python loop (:func:`loops.time_loop`)."""
    B, S, d = x.shape
    if cache is None:
        zeros = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, torch.full_like(zeros, -1e30), zeros)
    else:
        carry = (cache["c"], cache["n"], cache["m"], cache["h"])
    names = sorted(p)

    def step(consts, carry, t):
        carry = slstm_step(dict(zip(names, consts[1:])), carry,
                           consts[0][:, t], cfg.n_heads)
        return carry, carry[3]

    carry, hs = time_loop(step, carry, (x.float(), *(p[k] for k in names)),
                          S)
    h = rms_norm(torch.stack(hs, 1), p["norm"], cfg.norm_eps)
    y = dot(h.to(x.dtype), p["w_down"].to(x.dtype))
    return y, dict(zip(("c", "n", "m", "h"), carry))


def init_slstm_cache(cfg: ModelConfig, batch: int, *, lead=(),
                     device=None) -> dict:
    shape = tuple(lead) + (batch, cfg.d_model)
    zeros = torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c": zeros, "n": zeros.clone(),
            "m": torch.full(shape, -1e30, dtype=torch.float32,
                            device=device),
            "h": zeros.clone()}
