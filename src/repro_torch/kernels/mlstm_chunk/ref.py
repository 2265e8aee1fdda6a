"""The plain PyTorch versions of the mLSTM (the ground truth the CUDA
kernel is held to, and the CPU route).

* :func:`mlstm_ref`: the sequential (definitional) oracle of the JAX
  package's ``kernels/mlstm_chunk/ref.py``, (BH, S, dh) in, f32 out —
  :func:`mlstm_seq` in the model's (B, S, H, dh) layout from a state::

      C_t = f_t C_{t-1} + i_t k_t v_t^T ;  n_t = f_t n_{t-1} + i_t k_t
      h_t = (q_t . C_t) / max(|q_t . n_t|, 1),   q scaled by 1/sqrt(dh)

* :func:`mlstm_chunk_ref`: the chunkwise form with the state carried in
  and out — the ``body`` of the JAX model's ``mlstm_scan_chunked``
  (``models/recurrent.py``) at chunk ``K``, the tail padded with f = 1
  and i -> -1e30.  (B, S, H, dh) q/k/v, (B, S, H) log gates, (C0, n0) in;
  (h f32, C, n) out.  The intra-chunk cumulative sum of log f is taken
  in XLA's CPU order (:func:`repro_torch.numerics.cumsum`) on every
  device, which is also the CUDA kernel's order.

On CPU tensors both equal their JAX counterparts bit for bit
(:mod:`repro_torch.numerics` rounds as XLA's CPU backend does).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import numerics


def mlstm_seq(q, k, v, log_f, log_i, C0, n0):
    """The definitional recurrence, one step at a time, from the state
    (C0, n0): q/k/v (B, S, H, dh), log_f/log_i (B, S, H); returns (h
    (B, S, H, dh) f32, C, n)."""
    dh = q.shape[-1]
    # q / sqrt(dh): XLA multiplies by the f32 reciprocal of the f32 root
    qf = q.float() * float(np.float32(1) / np.float32(math.sqrt(dh)))
    kf, vf = k.float(), v.float()
    f = numerics.exp(log_f.float())
    i = numerics.exp(torch.clamp_max(log_i.float(), 30.0))
    C, n, hs = C0, n0, []
    for t in range(q.shape[1]):
        qt, kt, vt, ft, it = qf[:, t], kf[:, t], vf[:, t], f[:, t], i[:, t]
        C = numerics.muladd(ft[..., None, None], C,
                            (it[..., None, None] * kt[..., :, None])
                            * vt[..., None, :])
        n = numerics.muladd(ft[..., None], n, it[..., None] * kt)
        num = numerics.einsum("bhd,bhde->bhe", qt, C)
        den = numerics.einsum("bhd,bhd->bh", qt, n).abs()
        hs.append(num / torch.clamp_min(den, 1.0)[..., None])
    return torch.stack(hs, 1), C, n


def mlstm_ref(q, k, v, log_f, log_i):
    """q/k/v: (BH, S, dh); log_f/log_i: (BH, S) -> h (BH, S, dh) f32,
    from the zero state."""
    BH, S, dh = q.shape
    C0 = torch.zeros((BH, 1, dh, dh), dtype=torch.float32, device=q.device)
    n0 = torch.zeros((BH, 1, dh), dtype=torch.float32, device=q.device)
    h, _, _ = mlstm_seq(q[:, :, None], k[:, :, None], v[:, :, None],
                        log_f[:, :, None], log_i[:, :, None], C0, n0)
    return h[:, :, 0]


def mlstm_chunk_ref(q, k, v, log_f, log_i, C0, n0, K: int):
    """q/k/v: (B, S, H, dh); log_f/log_i: (B, S, H) f32; C0: (B, H, dh,
    dh) f32; n0: (B, H, dh) f32.  Returns (h (B, S, H, dh) f32, C, n)."""
    B, S, H, dh = q.shape
    K = min(K, S)
    if S % K:
        # pad the tail: f = 1 (log 0) keeps the state; i -> -1e30 adds nothing
        pad = K - S % K
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
        log_f = torch.nn.functional.pad(log_f, (0, 0, 0, pad))
        log_i = torch.nn.functional.pad(log_i, (0, 0, 0, pad),
                                        value=-1e30)
        h, C, n = mlstm_chunk_ref(q, k, v, log_f, log_i, C0, n0, K)
        return h[:, :S], C, n
    scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))
    causal = torch.tril(torch.ones((K, K), dtype=torch.bool,
                                   device=q.device))
    C, n, hs = C0, n0, []
    for c0 in range(0, S, K):
        qc = q[:, c0:c0 + K].float() * scale
        kc, vc = k[:, c0:c0 + K].float(), v[:, c0:c0 + K].float()
        lf, li = log_f[:, c0:c0 + K], log_i[:, c0:c0 + K]
        d_cum = numerics.cumsum(lf, 1)  # (B, K, H)
        # inter-chunk: q_j decayed by d_cum_j reads the carried state (XLA
        # folds the scale into the decay: q (exp(d) scale), not
        # (q scale) exp(d))
        q_dec = q[:, c0:c0 + K].float() * (numerics.exp(d_cum)
                                           * scale)[..., None]
        inter = numerics.einsum("bkhd,bhde->bkhe", q_dec, C)
        inter_n = numerics.einsum("bkhd,bhd->bkh", q_dec, n)
        # intra-chunk: the decay from l to j is exp(d_j - d_l), gated by i_l
        rel = d_cum[:, :, None, :] - d_cum[:, None, :, :] + li[:, None]
        rel = torch.where(causal[None, :, :, None], rel,
                          torch.tensor(-float("inf"), device=q.device))
        w = numerics.exp(torch.clamp_max(rel, 30.0))
        raw = numerics.einsum("bjhd,blhd->bjlh", qc, kc)
        scores = raw * w
        intra_n = numerics.sum_product(raw, w, 2)
        if K == 1:  # XLA makes the one-term product a multiply, fused
            num = numerics.muladd(vc, scores[:, :, 0, :, None], inter)
        else:
            num = inter + numerics.einsum("bjlh,blhe->bjhe", scores, vc)
        den = (inter_n + intra_n).abs()
        hs.append(num / torch.clamp_min(den, 1.0)[..., None])
        # the state update: decay to the end of the chunk
        d_end = d_cum[:, -1]  # (B, H)
        k_gate = numerics.exp(d_end[:, None] - d_cum + li)[..., None]
        k_dec = kc * k_gate
        C = numerics.muladd(C, numerics.exp(d_end)[..., None, None],
                            numerics.einsum("blhd,blhe->bhde", k_dec, vc))
        n = numerics.muladd(n, numerics.exp(d_end)[..., None],
                            numerics.sum_product(kc, k_gate, 1))
    return torch.cat(hs, 1), C, n

