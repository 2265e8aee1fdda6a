"""The plain Qwen3 reference: the decoder, its next-token loss and AdamW,
in float32 with TF32 off, written from the published architecture
(hf:Qwen/Qwen3-1.7B, ``Qwen3ForCausalLM``) and imported from nothing of
the program.

Architecture: token embedding; per layer a pre-norm (RMSNorm) grouped-
query attention block — q, k, v projections without bias, an RMSNorm over
each head's dimension of q and of k (qk-norm), rotary embedding of the
two halves of each head (``rope_theta``), causal softmax attention with
query head h reading key/value head ``h // (heads / kv_heads)``, the
output projection — then a pre-norm SwiGLU MLP (``silu(x W1) * (x W3)
W2``); a final RMSNorm and the output head tied to the embedding.

The training recipe is the configuration's: the loss is the mean next-
token cross-entropy plus ``z_loss`` times the mean squared log-sum-exp;
AdamW clips the gradients by their global norm, keeps float32 moments,
takes a linear warmup of the learning rate (at count k, after its
increment, ``lr * (k + 1) / warmup``), bias-corrects both moments and
decays every weight but the norms.

Parameters are a dict of float32 tensors in the layout the benchmark
draws them in: ``tok`` [vocab rows, d] (rows past the published
vocabulary are padding the loss never reads), ``final_norm`` [d], and per
layer, stacked over the layers, ``ln1``, ``ln2`` [L, d], ``wq`` [L, d,
H hd], ``wk``, ``wv`` [L, d, Hkv hd], ``wo`` [L, H hd, d], ``q_norm``,
``k_norm`` [L, hd], ``w1``, ``w3`` [L, d, ff], ``w2`` [L, ff, d].

``quant`` gives the controls, the reference in a precision below the
configuration's: ``"fp8"`` rounds every matmul operand to float8 (e4m3,
scaled by its largest magnitude) on the way forward, the gradient passed
straight through; ``"bf16_scores"`` computes the attention's q·kᵀ, its
softmax and p·v in bfloat16 (forward and backward), where the
configuration states float32, the rest as without ``quant``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NO_DECAY = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
# the per-layer leaves, stacked over the layers, in ``_layer``'s order
QUANTS = ("fp8", "bf16_scores")
STACKED = ("ln1", "wq", "wk", "wv", "wo", "q_norm", "k_norm", "ln2",
           "w1", "w2", "w3")


@contextlib.contextmanager
def strict_f32():
    """float32 matmuls without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


def _mm(a, b, quant: Optional[str]):
    if quant == "fp8":
        a, b = _FP8.apply(a), _FP8.apply(b)
    elif quant not in (None, "bf16_scores"):
        raise ValueError(f"quant {quant!r}")
    return a @ b


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd))
    ang = pos[:, None].float() * inv                 # (S, hd/2)
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(c: Dict, quant, x, ln1, wq, wk, wv, wo, qn, kn, ln2, w1, w2, w3):
    B, S, d = x.shape
    H, Hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    eps = c["rms_norm_eps"]
    h = _rms(x, ln1, eps)
    q = _mm(h, wq, quant).view(B, S, H, hd)
    k = _mm(h, wk, quant).view(B, S, Hkv, hd)
    v = _mm(h, wv, quant).view(B, S, Hkv, hd)
    q, k = _rms(q, qn, eps), _rms(k, kn, eps)
    pos = torch.arange(S, device=x.device)
    q, k = _rope(q, pos, c["rope_theta"]), _rope(k, pos, c["rope_theta"])
    rep = H // Hkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, hd)
    if quant == "bf16_scores":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    s = _mm(q, k.transpose(-1, -2), quant) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = _mm(torch.softmax(s, dim=-1), v, quant).float()
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    x = x + _mm(o, wo, quant)
    h = _rms(x, ln2, eps)
    g = _mm(h, w1, quant)
    return x + _mm(F.silu(g) * _mm(h, w3, quant), w2, quant)


def loss(c: Dict, p: Dict, tokens, *, z_loss: float,
         quant: Optional[str] = None):
    """(loss, ce) of a batch of token ids (B, S): each layer checkpointed,
    so a backward keeps one layer's activations at a time."""
    x = F.embedding(tokens, p["tok"])
    for i in range(c["num_hidden_layers"]):
        x = checkpoint(_layer, c, quant, x, *(p[k][i] for k in STACKED),
                       use_reentrant=False)
    x = _rms(x, p["final_norm"], c["rms_norm_eps"])[:, :-1]
    logits = _mm(x, p["tok"][:c["vocab_size"]].T, quant)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, tokens[:, 1:, None])[..., 0]
    n = lse.numel()
    ce = (lse - tgt).sum() / n
    return ce + z_loss * (lse * lse).sum() / n, ce


def _lr(o: Dict, k: int) -> float:
    if k < o["warmup_steps"]:
        return o["learning_rate"] * (k + 1) / max(o["warmup_steps"], 1)
    prog = min(1.0, (k - o["warmup_steps"])
               / max(o["total_steps"] - o["warmup_steps"], 1))
    return 0.5 * o["learning_rate"] * (1.0 + math.cos(math.pi * prog))


def train(c: Dict, o: Dict, p: Dict, batches: Sequence[torch.Tensor], *,
          quant: Optional[str] = None, on_step=None) -> List[float]:
    """AdamW steps of ``p`` (updated in place) on ``batches``; returns
    each step's loss.  ``on_step(k, p, m)`` sees the state after step k
    (1-based)."""
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses = []
    for k, toks in enumerate(batches, start=1):
        leaves = {n: t.detach().requires_grad_(True) for n, t in p.items()}
        with strict_f32():
            lo, _ = loss(c, leaves, toks, z_loss=o["z_loss"], quant=quant)
            grads = torch.autograd.grad(lo, list(leaves.values()))
        losses.append(float(lo.detach()))
        g = dict(zip(leaves, grads))
        del leaves, grads, lo
        with torch.no_grad():
            gn = torch.sqrt(sum((t.double() ** 2).sum() for t in g.values()))
            scale = min(1.0, o["grad_clip"] / max(float(gn), 1e-12))
            lr = _lr(o, k)
            bc1, bc2 = 1 - o["b1"] ** k, 1 - o["b2"] ** k
            for n in p:
                gk = g.pop(n) * scale
                m[n].mul_(o["b1"]).add_(gk, alpha=1 - o["b1"])
                v2[n].mul_(o["b2"]).addcmul_(gk, gk, value=1 - o["b2"])
                adam = (m[n] / bc1) / ((v2[n] / bc2).sqrt() + o["eps"])
                wd = 0.0 if n in NO_DECAY else o["weight_decay"]
                p[n].sub_(lr * (adam + wd * p[n]))
        if on_step is not None:
            on_step(k, p, m)
    return losses
