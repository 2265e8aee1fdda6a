"""Model primitives: norms, rope, activations, attention (PyTorch port).

The JAX package's ``models/layers.py`` with the same dtypes and the same
rounding points: parameters are stored f32 and cast at use, compute is
bf16 with f32 softmax and normalisation.  ``init_*`` return plain dicts of
tensors drawn from an explicit ``torch.Generator`` (on its device);
``init_attn`` / ``init_mlp`` take a leading shape so that a stack of
layers is drawn as one tensor per leaf.

:func:`attention` has two forms.  The plain one is the JAX package's
query-chunked attention (``_sdpa`` under the causal / window / ``kv_len``
masks, exact softmax over the whole key range of a chunk, probabilities
cast to v's dtype before P V); it runs on CPU tensors.  On CUDA tensors
the route goes to the hand-written kernels instead — the ``pallas``
route that ``RunConfig.attn_impl`` names: prefill to flash attention,
decode (one query position against a cache of ``kv_len`` live positions)
to flash-decode.  Those compute their TPU kernels' function, which keeps
the probabilities in f32 for P V, so the two routes differ at the bf16
rounding of P.

No kernel has a backward (nor has any TPU kernel of the JAX package), so
training runs the plain forms on every device, as the JAX package trains
through its XLA forms: inside :func:`xla_route` attention, the RG-LRU
scan and the mLSTM take their plain versions on CUDA tensors too, and
:func:`checkpoint` (``torch.utils.checkpoint``, non-reentrant) recomputes
under the route its first run saw.  The route is a context, not a mode:
the encoder runs in mode ``"train"`` while serving and keeps its kernel.
``chunk_remat`` checkpoints each query chunk of the plain attention.
:func:`attn_qkv` and :func:`attn_out` hold the heads' layout points on a
mesh's DTensors (``lm``'s docstring lists them all); on any other tensor
they change nothing.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import numerics
from ..configs.base import ModelConfig
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from ..parallel import sharding

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32

NEG_INF = -1e30

_ROUTE = threading.local()


def xla_active() -> bool:
    """Whether the plain (XLA) route is on in this thread."""
    return getattr(_ROUTE, "on", False)


@contextlib.contextmanager
def xla_route(on: bool = True):
    """Run the model's plain forms on every device (``on``), or the
    kernels on CUDA tensors (``on=False``), inside the block."""
    prev = xla_active()
    _ROUTE.on = on
    try:
        yield
    finally:
        _ROUTE.on = prev


class _Recompute:
    """:func:`checkpoint`'s recompute context: ``inner`` and the route of
    the first run, entered afresh at every recompute.  Re-enterable, a
    stack per thread: a frame is recomputed once for each backward pass
    that reaches it, on the thread the autograd engine runs it on (a
    CUDA graph's nodes run on the engine's device thread)."""

    def __init__(self, inner, on: bool):
        self.inner, self.on = inner, on
        self.local = threading.local()

    def __enter__(self):
        stack = contextlib.ExitStack()
        stack.enter_context(self.inner)
        stack.enter_context(xla_route(self.on))
        self.local.__dict__.setdefault("stacks", []).append(stack)

    def __exit__(self, *exc):
        return self.local.stacks.pop().__exit__(*exc)


def checkpoint(fn, *args, context_fn=None):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)`` whose
    recompute runs under the route of this call.  ``context_fn`` (e.g.
    ``create_selective_checkpoint_contexts``) gives the (forward,
    recompute) contexts to enter as well."""
    on = xla_active()

    def contexts():
        fwd, rec = (context_fn() if context_fn is not None
                    else (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, _Recompute(rec, on)

    # the model draws no random numbers: no RNG state to save and restore
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             context_fn=contexts,
                                             preserve_rng_state=False)


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None):
    """Normal(0, 1) * scale, f32, on the generator's device; the default
    scale is 1/sqrt(fan_in) with fan_in = shape[-2] (shape[-1] for a
    vector), so a leading stack dimension does not change it."""
    shape = tuple(shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=PARAM_DTYPE,
                    device=gen.device)
    return w.mul_(scale)


def dot(x, w):
    """x @ w for operands of one dtype, accumulated in f32 and rounded to
    that dtype.  On CPU tensors it is the f32 product of the upcast
    operands, the order XLA's CPU backend sums in (bit-equal to the JAX
    package's einsums; PyTorch's own bf16 CPU GEMM sums in another order
    and differs in the last bit); on the card, cuBLAS's GEMM in the
    operands' dtype."""
    if numerics.exact_forms(x) and x.dtype != torch.float32:
        return (x.float() @ w.float()).to(x.dtype)
    # on a mesh's DTensors the product's gradient comes back in its
    # output's layout (a product cannot take one sharded along the
    # sequence and flattened with the batch)
    return sharding.pin(x @ w)


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = numerics.mean_sq(x)
    out = x * numerics.rsqrt(var + eps) * w.float()
    return out.to(dt)


def sigmoid(x):
    """``jax.nn.sigmoid`` as XLA evaluates it: 1 / (1 + exp(-x)), each op
    rounded to x's dtype (bit-equal in bf16, where ``torch.sigmoid``
    rounds once and differs in the last bit)."""
    return 1.0 / (1.0 + numerics.exp(-x))


def silu(x):
    """``jax.nn.silu``: x * sigmoid(x), rounded as XLA rounds it."""
    return x * sigmoid(x)


def gelu(x):
    """``jax.nn.gelu(approximate=True)``.  On CPU tensors as XLA evaluates
    it, op by op in x's dtype with its constants rounded to that dtype
    (bit-equal to the JAX package); on the card PyTorch's fused tanh gelu,
    rounded once."""
    if not numerics.exact_forms(x):
        return F.gelu(x, approximate="tanh")
    c0 = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    c1 = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c0 * (x + c1 * (x * (x * x))))))


def act_fn(name: str):
    return {"swiglu": silu, "geglu": gelu, "gelu": gelu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def whole_heads(*ts) -> bool:
    """Whether these are a mesh's DTensors sharded over whole heads
    (dimension 2) and the batch alone: no head_dim shard, no partial
    sum."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ps = [p for t in ts if isinstance(t, DTensor) for p in t.placements]
    return (any(p == Shard(2) for p in ps)
            and all(p in (Replicate(), Shard(0), Shard(2)) for p in ps))


def per_head(fn, q, k, v, mask):
    """``fn(q, k, v, mask)``, attention over heads of q, k, v at dimension
    2, row by row.  Where they are a mesh's DTensors sharded over whole
    heads (:func:`whole_heads`), each rank runs it on its own batch rows
    and heads (:func:`sharding.local_map`): its products would otherwise
    flatten batch and heads, both sharded, into one dimension, which
    DTensor refuses.  Otherwise (any plain tensor) ``fn`` itself."""
    if not whole_heads(q, k, v):
        return fn(q, k, v, mask)
    return sharding.local_map(fn, (q, k, v, mask), ((0, 2),) * 3 + ((0,),),
                              (0, 2))


def _sdpa(q, k, v, mask, scale: float):
    """q: (B, Sq, Hkv, G, hd); k/v: (B, Skv, Hkv, hd); mask: (B, Sq, Skv).

    GQA convention throughout the framework: query head hq = hkv * G + g.
    Both products take their operands in the input dtype and accumulate
    in f32 (the JAX einsums' ``preferred_element_type`` and bf16 dot);
    each rank's own heads on a mesh (:func:`per_head`)."""
    return per_head(functools.partial(_sdpa_rows, scale=scale), q, k, v,
                    mask)


def _sdpa_rows(q, k, v, mask, scale: float):
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    # a Python scalar: a scalar tensor made on the card is a host copy
    # that waits for the device
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.to(v.dtype)


def attention_plain(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0, kv_len: Optional[int] = None,
                    chunk: int = 0, chunk_remat: bool = False):
    """The plain form of :func:`attention` (the JAX package's, chunked
    over queries when ``chunk`` divides Sq and Sq > chunk; with
    ``chunk_remat`` each chunk is checkpointed, so its backward keeps one
    chunk's probabilities at a time and recomputes them)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, G, hd)
    dev = q.device
    kv_pos = torch.arange(Skv, device=dev)

    def mask_for(q_positions):
        m = torch.ones((q_positions.shape[0], Skv), dtype=torch.bool,
                       device=dev)
        if causal:
            m &= kv_pos[None, :] <= q_positions[:, None]
        if window:
            m &= kv_pos[None, :] > q_positions[:, None] - window
        if kv_len is not None:
            m &= kv_pos[None, :] < kv_len
        return m[None].expand((B,) + m.shape)

    use_chunks = chunk and Sq > chunk and Sq % chunk == 0
    if not use_chunks:
        q_positions = q_offset + torch.arange(Sq, device=dev)
        out = _sdpa(qg, k, v, mask_for(q_positions), scale)
        return out.reshape(B, Sq, Hq, hd)

    def sdpa(*a):
        if chunk_remat and torch.is_grad_enabled():
            return checkpoint(_sdpa, *a)
        return _sdpa(*a)

    outs = []
    if window and window + chunk < Skv:
        # local attention: only the [pos-window, pos] key band is live.
        band = window + chunk
        k_pad = F.pad(k, (0, 0, 0, 0, window, 0))
        v_pad = F.pad(v, (0, 0, 0, 0, window, 0))
        for i in range(Sq // chunk):
            start = i * chunk  # band begins at (start - window) + pad = start
            kb = k_pad[:, start:start + band]
            vb = v_pad[:, start:start + band]
            q_positions = q_offset + start + torch.arange(chunk, device=dev)
            b_pos = start - window + torch.arange(band, device=dev)
            m = (b_pos[None, :] >= 0)
            if causal:
                m = m & (b_pos[None, :] <= q_positions[:, None])
            m = m & (b_pos[None, :] > q_positions[:, None] - window)
            m = m[None].expand(B, chunk, band)
            outs.append(sdpa(qg[:, start:start + chunk], kb, vb, m, scale))
    else:
        for i in range(Sq // chunk):
            start = i * chunk
            q_positions = q_offset + start + torch.arange(chunk, device=dev)
            outs.append(sdpa(qg[:, start:start + chunk], k, v,
                             mask_for(q_positions), scale))
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, hd)


def attention(q, k, v, *, causal: bool, window: int = 0,
              q_offset: int = 0, kv_len: Optional[int] = None,
              chunk: int = 0, chunk_remat: bool = False):
    """Grouped-query attention with optional causal mask / local window.

    q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd).
    ``q_offset``: absolute position of q[0].  ``kv_len``: number of valid
    kv positions (decode with a preallocated cache), a host int.
    ``chunk``, ``chunk_remat``: the plain form's query chunk and its
    checkpointing (no effect on the kernels).

    CUDA tensors go to a kernel: one query position, not causal, no
    window, against a cache of ``kv_len`` live positions (self-attention
    decode) or against the whole of it (cross-attention decode: ``kv_len``
    is then Skv) to flash-decode; every other full-sequence form (no
    ``kv_len``, ``q_offset`` 0: prefill, the encoder, cross-attention
    prefill) to flash attention; any other form raises.  CPU tensors, and
    every tensor inside :func:`xla_route`, take the plain form of this
    function, the JAX model's."""
    if q.device.type != "cuda" or xla_active():
        return attention_plain(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len, chunk=chunk,
                               chunk_remat=chunk_remat)
    if q.shape[1] == 1 and not causal and not window:
        return decode_attention(q, k, v,
                                k.shape[1] if kv_len is None else kv_len)
    if kv_len is None and q_offset == 0:
        return flash_attention(q, k, v, causal=causal, window=window)
    raise NotImplementedError(
        f"no attention kernel for causal={causal}, window={window}, "
        f"q_offset={q_offset}, kv_len={kv_len}, Sq={q.shape[1]}")


# ---------------------------------------------------------------------------
# Attention block (params + apply)
# ---------------------------------------------------------------------------

def init_attn(cfg: ModelConfig, gen: torch.Generator, *, lead=(),
              cross: bool = False) -> dict:
    """Self-attention's projections, or cross-attention's (``cross``: no
    qkv bias; q from the decoder, k and v from the encoder's output)."""
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (d, nq * hd)),
        "wk": dense_init(gen, lead + (d, nkv * hd)),
        "wv": dense_init(gen, lead + (d, nkv * hd)),
        "wo": dense_init(gen, lead + (nq * hd, d)),
    }

    def const(n, fill):
        return torch.full(lead + (n,), fill, dtype=PARAM_DTYPE,
                          device=gen.device)

    if cfg.qkv_bias and not cross:
        p["bq"] = const(nq * hd, 0.0)
        p["bk"] = const(nkv * hd, 0.0)
        p["bv"] = const(nkv * hd, 0.0)
    if cfg.qk_norm:
        p["q_norm"] = const(hd, 1.0)
        p["k_norm"] = const(hd, 1.0)
    return p


def split_heads(t, n_heads: int, hd: int, layout_heads=None):
    """(B, S, n_heads * hd) -> (B, S, n_heads, hd).  On a mesh's DTensor
    (a no-op on any other tensor) the flat projection is first laid out
    as :func:`sharding.head_axes` says for ``layout_heads`` heads
    (default ``n_heads``), sharded over whole heads or not at all, and
    the heads then take that layout: GSPMD pads a split of a sharded
    width that does not divide, DTensor refuses it, so the port
    constrains where the JAX model lets the partitioner choose."""
    h_ax, hd_ax = sharding.head_axes(layout_heads or n_heads, hd)
    t = sharding.constrain(t, sharding.data_axes(), None, h_ax)
    t = t.reshape(*t.shape[:2], n_heads, hd)
    return sharding.constrain(t, sharding.data_axes(), None, h_ax, hd_ax)


def attn_qkv(cfg: ModelConfig, p: dict, x, positions=None):
    """Project + rope. x: (B, S, D) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd)."""
    B, S, _ = x.shape
    hd, nq, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = dot(x, p["wq"].to(x.dtype))
    k = dot(x, p["wk"].to(x.dtype))
    v = dot(x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    # q takes K/V's layout, so that its heads split into (kv head, group)
    # evenly in the attention
    q = split_heads(q, nq, hd, layout_heads=nkv)
    k = split_heads(k, nkv, hd)
    v = split_heads(v, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(cfg: ModelConfig, p: dict, o):
    return dot(merge_heads(o), p["wo"].to(o.dtype))


def merge_heads(o):
    """(B, S, H, hd) -> (B, S, H * hd).  On a mesh's DTensor (a no-op on
    any other tensor) the heads are merged whole, forward and backward: a
    DTensor sharded on head_dim merges into a strided layout the next
    product cannot take, and the gradient of the merged width cannot
    split into heads that do not divide the axis."""
    B, S, H, hd = o.shape
    h_ax, _ = sharding.head_axes(H, hd)
    o = sharding.constrain(o, sharding.data_axes(), None, h_ax, None)
    return sharding.constrain(o.reshape(B, S, H * hd), sharding.data_axes(),
                              None, h_ax)


# ---------------------------------------------------------------------------
# MLP block
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, *, lead=(),
             d_ff: Optional[int] = None) -> dict:
    """A gated (swiglu, geglu) or plain MLP of width ``d_ff`` (default
    ``cfg.d_ff``; the MoE's shared experts are one MLP of their summed
    width)."""
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    lead = tuple(lead)
    p = {"w1": dense_init(gen, lead + (d, ff)),
         "w2": dense_init(gen, lead + (ff, d))}
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = dense_init(gen, lead + (d, ff))
    return p


def apply_mlp(cfg: ModelConfig, p: dict, x):
    a = act_fn(cfg.act)
    h = a(dot(x, p["w1"].to(x.dtype)))
    if "w3" in p:
        h = h * dot(x, p["w3"].to(x.dtype))
    return dot(h, p["w2"].to(x.dtype))
