"""Recurrent blocks of the PyTorch port: RG-LRU (RecurrentGemma).

The RG-LRU half of the JAX package's ``models/recurrent.py``, with its
names and dtypes: a diagonal linear recurrence h_t = a_t h_{t-1} +
sqrt(1 - a_t^2) (i_t x_t), a_t = exp(c r_t log sigmoid(Lambda)), after a
width-4 depthwise causal conv.  Projections and the gates' sigmoids are
bf16; softplus, exp and the scan are f32 (on CPU tensors rounded as the
JAX package's CPU backend rounds them, :mod:`repro_torch.numerics`).
Prefill and decode both run the scan through
:func:`repro_torch.kernels.rglru_scan.ops.rglru_scan` — on the card the
CUDA kernel, prefill from h0 = 0 and decode one step from the cached h
(the JAX model's prefill runs ``lax.associative_scan`` and its decode
``a h0 + b``, which the scan's plain version reproduces bit for bit).
The mLSTM and sLSTM blocks are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import numerics
from ..configs.base import ModelConfig
from ..kernels.rglru_scan.ops import rglru_scan
from .layers import PARAM_DTYPE, dense_init, dot, gelu, sigmoid

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
    h = rglru_scan(a, b, h0)
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
