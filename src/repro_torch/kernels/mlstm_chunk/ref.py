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

The CUDA kernels' own arithmetic, in plain PyTorch (the CPU tests hold it
to the JAX package; on the card it is a reference only):

* :func:`mlstm_tc_ref`: the prefill's two passes at the kernels' chunk of
  64 — :func:`mlstm_scores_ref` (the gated scores once a chunk, their row
  sums, the decays and the chunk's share of n) then
  :func:`mlstm_state_ref` (the state carried over the chunks) — with every
  f32 operand of a tensor-core product (the state C, the scores, g v)
  split into three bf16 parts (:func:`split_bf16`: exact) and q, k, v
  unsplit, products of bf16 values summed in f32, each chunk's update of
  C added to it with one fused multiply-add.
* :func:`mlstm_decode_ref`: the decode step (S = 1) in place: n first,
  then C, then h from the new state.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import numerics
from ...loops import time_loop


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

    def chunk(consts, carry, i):
        q, k, v, log_f, log_i = consts
        C, n = carry
        c0 = i * K
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
        rel = torch.where(causal[None, :, :, None], rel, -float("inf"))
        w = numerics.exp(torch.clamp_max(rel, 30.0))
        raw = numerics.einsum("bjhd,blhd->bjlh", qc, kc)
        scores = raw * w
        intra_n = numerics.sum_product(raw, w, 2)
        if K == 1:  # XLA makes the one-term product a multiply, fused
            num = numerics.muladd(vc, scores[:, :, 0, :, None], inter)
        else:
            num = inter + numerics.einsum("bjlh,blhe->bjhe", scores, vc)
        den = (inter_n + intra_n).abs()
        h = num / torch.clamp_min(den, 1.0)[..., None]
        # the state update: decay to the end of the chunk
        d_end = d_cum[:, -1]  # (B, H)
        k_gate = numerics.exp(d_end[:, None] - d_cum + li)[..., None]
        k_dec = kc * k_gate
        C = numerics.muladd(C, numerics.exp(d_end)[..., None, None],
                            numerics.einsum("blhd,blhe->bhde", k_dec, vc))
        n = numerics.muladd(n, numerics.exp(d_end)[..., None],
                            numerics.sum_product(kc, k_gate, 1))
        return (C, n), h

    # a scan over the chunks (counted from one chunk by the dry run's
    # analyzer, as the JAX model's lax.scan is)
    (C, n), hs = time_loop(chunk, (C0, n0), (q, k, v, log_f, log_i), S // K)
    return torch.cat(hs, 1), C, n



def split_bf16(x, parts: int = 3):
    """x (f32) as ``parts`` bf16 values (as f32), each the bf16 rounding of
    what the earlier ones leave: the operands the kernels give the tensor
    cores for an f32 one.  Two parts carry 16 of its 24 mantissa bits (a
    relative error of about 2^-17), three all of them."""
    out = []
    for _ in range(parts):
        p = x.bfloat16().float()
        out.append(p)
        x = x - p
    return tuple(out)


def _chunks(x, K: int, fill: float = 0.0):
    """(B, S, H, ...) -> (B, H, n_chunks, K, ...), the tail padded with
    ``fill``."""
    S = x.shape[1]
    pad = -S % K
    if pad:
        widths = [0, 0] * (x.dim() - 2) + [0, pad]
        x = torch.nn.functional.pad(x, widths, value=fill)
    x = x.movedim(1, 2) if x.dim() > 3 else x.transpose(1, 2)
    return x.reshape(x.shape[:2] + (-1, K) + x.shape[3:])


def mlstm_scores_ref(q, k, log_f, log_i, K: int = 64,
                     parts: int = 3) -> dict:
    """The scores pass: q/k (B, S, H, dh), log_f/log_i (B, S, H).  Per
    (B, H, chunk): ``s_parts`` the gated scores (K, K) as ``parts`` bf16
    parts,
    ``rowsum`` (K) their row sums (of the unsplit scores), ``eq`` (K)
    exp(d_j) / sqrt(dh), ``g`` (K) exp(d_end - d_l + log i_l), ``e_end``
    exp(d_end) and ``u`` (dh) sum_l g_l k_l.  Rows and columns past S are
    zero, as the tail's log f = 0 and log i = -1e30 make them."""
    B, S, H, dh = q.shape
    scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))
    qf, kf = _chunks(q.float(), K), _chunks(k.float(), K)
    lf, li = _chunks(log_f.float(), K), _chunks(log_i.float(), K, -1e30)
    d = numerics.cumsum(lf, -1)
    d_end = d[..., -1:]
    pos = torch.arange(qf.shape[2] * K, device=q.device).reshape(-1, K)
    live = (torch.tril(torch.ones((K, K), dtype=torch.bool,
                                  device=q.device))
            & (pos < S)[:, :, None])
    rel = d[..., :, None] - d[..., None, :] + li[..., None, :]
    raw = qf @ kf.transpose(-1, -2)
    s = torch.where(live, raw * scale * torch.exp(torch.clamp_max(rel, 30.0)),
                    torch.zeros((), device=q.device))
    g = torch.exp((d_end - d) + li)
    return {"s_parts": split_bf16(s, parts), "rowsum": s.sum(-1),
            "eq": torch.exp(d) * scale, "g": g,
            "e_end": torch.exp(d_end[..., 0]),
            "u": (g[..., None] * kf).sum(-2)}


def mlstm_state_ref(q, k, v, sc: dict, C0, n0, parts=(3, 3)):
    """The state-and-output pass over the chunks of :func:`mlstm_scores_ref`
    from (C0, n0), with C and g v in ``parts`` bf16 parts: returns (h (B,
    S, H, dh) f32, C, n)."""
    S = q.shape[1]
    K = sc["s_parts"][0].shape[-1]
    qf, kf, vf = (_chunks(x.float(), K) for x in (q, k, v))
    C, n, hs = C0, n0, []
    for c in range(qf.shape[2]):
        qc, kc, vc = qf[:, :, c], kf[:, :, c], vf[:, :, c]
        inter = sum(qc @ p for p in split_bf16(C, parts[0]))
        intra = sum(p[:, :, c] @ vc for p in sc["s_parts"])
        eq = sc["eq"][:, :, c]
        qn = (qc * n[:, :, None, :]).sum(-1)
        den = torch.clamp_min((eq * qn + sc["rowsum"][:, :, c]).abs(), 1.0)
        hs.append((eq[..., None] * inter + intra) / den[..., None])
        gv = split_bf16(sc["g"][:, :, c, :, None] * vc, parts[1])
        e_end = sc["e_end"][:, :, c]
        kt = kc.transpose(-1, -2)
        C = numerics.muladd(C, e_end[..., None, None],
                            sum(kt @ p for p in gv))
        n = numerics.muladd(n, e_end[..., None], sc["u"][:, :, c])
    h = torch.stack(hs, 2).flatten(2, 3)[:, :, :S]
    return h.transpose(1, 2), C, n


def mlstm_tc_ref(q, k, v, log_f, log_i, C0, n0, K: int = 64,
                 parts=(3, 3, 3)):
    """The prefill's kernels, both passes: q/k/v (B, S, H, dh), log_f/
    log_i (B, S, H) f32, (C0, n0) the state; C, the scores and g v in
    ``parts`` bf16 parts (the kernels': three each); returns (h f32, C,
    n)."""
    sc = mlstm_scores_ref(q, k, log_f, log_i, K, parts[1])
    return mlstm_state_ref(q, k, v, sc, C0, n0, (parts[0], parts[2]))


def mlstm_decode_ref(q, k, v, log_f, log_i, C, n):
    """The decode step in place: q/k/v (B, 1, H, dh), log_f/log_i (B, 1,
    H); C (B, H, dh, dh) and n (B, H, dh) f32 are overwritten with the new
    state (n = f n + i k, then C = f C + i k v^T); returns h (B, 1, H, dh)
    f32 = (q / sqrt(dh)) . C / max(|(q / sqrt(dh)) . n|, 1)."""
    dh = q.shape[-1]
    scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))
    f = torch.exp(log_f[:, 0].float())[..., None]
    i = torch.exp(torch.clamp_max(log_i[:, 0].float(), 30.0))[..., None]
    qs = q[:, 0].float() * scale
    ik = i * k[:, 0].float()
    n.copy_(numerics.muladd(f, n, ik))
    den = torch.clamp_min((qs * n).sum(-1).abs(), 1.0)
    C.copy_(numerics.muladd(f[..., None], C, ik[..., :, None]
                            * v[:, 0].float()[..., None, :]))
    h = (qs[..., :, None] * C).sum(-2) / den[..., None]
    return h[:, None]
