"""f32 arithmetic rounded as the JAX package's CPU backend rounds it.

XLA compiles for the CPU with floating-point contraction on: every
multiply whose only use is an add becomes one fused multiply-add, rounded
once (``a * h + b`` in the RG-LRU scan and in the polynomials below).
Its ``exp`` and ``log1p`` are its own polynomials, not the C library's,
and both differ from PyTorch's in the last bit of a few per cent of
their f32 results; its ``sqrt`` is correctly rounded, which PyTorch's
vectorised CPU ``sqrt`` is not always; it sums a row in windows of 32
(:func:`mean_sq`).  On CPU tensors the functions here reproduce XLA's
(the constants and the order of operations are those of XLA's CPU
lowering), so the port's CPU route equals the JAX package bit for bit.
Its ``tanh`` is a rational function evaluated with fused multiply-adds
(:func:`tanh`); its ``cumsum`` (a ``reduce-window`` that the CPU pipeline
rewrites) sums in blocks of 16 (:func:`cumsum`); its dots and fused sums
of products keep their own orders (:func:`einsum`, :func:`sum_product`).
Its ``cos``, ``sin`` and ``pow`` are the C library's ``cosf``, ``sinf``
and ``powf`` (:func:`cos`, :func:`sin`, :func:`power`: called on each
distinct value), and it folds ``1 / a ** b`` into ``a ** -b``.
One function cannot be reproduced: XLA's ``rsqrt`` refines the CPU's
own hardware estimate with two Newton steps, so its last bit depends on
the processor; :func:`rsqrt` rounds correctly, which agrees with it on
almost every input.  On CUDA tensors every function but :func:`fma` and
:func:`cumsum` is PyTorch's own: the card route is held to bounds, not
bits.

:func:`fma` is exact on every device: the product in f64 is exact, and
the f64 sum rounded to odd (TwoSum's error sets the last bit) then to f32
is the correctly rounded f32 result.

Every function is differentiable.  Those that build their value from bit
patterns (``int`` views and shifts, which autograd cannot follow) run as
a ``torch.autograd.Function`` whose forward is that exact value and whose
backward is the JAX package's own VJP rule for the operation — exp: g
ans; tanh: (g + g ans)(1 - ans); fma(a, b, c): (g b, g a, g); a sum, an
einsum or a cumulative sum: the VJP of PyTorch's plain form (a reverse
cumulative sum) — evaluated in PyTorch's arithmetic: gradients are held
to bounds, not bits.  The forward bits do not change under autograd.
"""
from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch


def _f32(pattern: str) -> float:
    """An f32 constant from the 64-bit pattern LLVM prints it with."""
    return float(np.array(int(pattern, 16), np.uint64).view(np.float64))


def _tensor(x, like):
    return x if torch.is_tensor(x) else torch.tensor(
        x, dtype=torch.float32, device=like.device)


def _fma(a, b, c):
    """round_f32(a * b + c), one rounding.  Any operand may be a float."""
    like = next(x for x in (a, b, c) if torch.is_tensor(x))
    a, b, c = (_tensor(x, like).double() for x in (a, b, c))
    return _add_exact(a * b, c)  # the f64 product is exact: 48 bits


def _add_exact(p, c):
    """round_f32(p + c) for an f64 ``p`` that holds an exact product of
    two f32 values and f64-held f32 ``c``: the f64 sum rounded to odd
    (TwoSum's error sets the last bit), then to f32."""
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # TwoSum: s + err == p + c exactly
    bits = s.view(torch.int64)
    to_odd = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(to_odd, bits + step, bits).view(torch.float64).float()


# XLA's f32 exp: range reduction by ln 2 in two parts, a degree-6
# polynomial, then the power of two built in the exponent bits
_EXP_LO, _EXP_HI = _f32("0xC055F33340000000"), _f32("0x4056333340000000")
_LOG2E = _f32("0x3FF7154760000000")
_LN2_HI, _LN2_LO = _f32("0x3FE6300000000000"), _f32("0xBF2BD01060000000")
_EXP_P = [_f32(h) for h in (
    "0x3F2A0D2CE0000000", "0x3F56E879C0000000", "0x3F81112100000000",
    "0x3FA5553820000000", "0x3FC5555540000000")]


def _exp_xla(x):
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    fx = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(fx, -_LN2_HI, x)
    r = _fma(fx, -_LN2_LO, r)
    p = _fma(r, _EXP_P[0], _EXP_P[1])
    for c in (*_EXP_P[2:], 0.5):
        p = _fma(p, r, c)
    p = _fma(p, r * r, r) + 1.0
    return p * ((fx.to(torch.int32) << 23) + 0x3F800000).view(torch.float32)


# XLA's f32 log1p: a rational function for |x| < sqrt(2) - 1, else the
# log of 1 + x (mantissa in [sqrt(1/2), sqrt(2)), a degree-8 polynomial)
_L1P_SMALL = _f32("0x3FDA8279A0000000")
_L1P_Q = [_f32(h) for h in (
    "0x402E2035A0000000", "0x4054C30B60000000", "0x406BB865A0000000",
    "0x4073519460000000", "0x406B0DB140000000", "0x404E0F3040000000")]
_L1P_P = [_f32(h) for h in (
    "0x3F07BC0960000000", "0x3FDFE818A0000000", "0x401A509F40000000",
    "0x403DE97380000000", "0x404E798EC0000000", "0x404C8E75A0000000",
    "0x40340A2020000000")]
_LOG_P = [_f32(h) for h in (
    "0x3FB2043760000000", "0xBFBD7A3700000000", "0xBFBFCBA9E0000000",
    "0x3FC23D37E0000000", "0x3FC999D580000000", "0xBFCFFFFF80000000",
    "0x3FBDE4A340000000", "0xBFC555CA00000000", "0x3FD5555540000000")]
_SQRT_HALF, _FLT_MIN = _f32("0x3FE6A09E60000000"), _f32("0x3810000000000000")


def _log1p_xla(x):
    x2 = x * x
    q = torch.ones_like(x)
    for c in _L1P_Q:
        q = _fma(q, x, c)
    p = torch.full_like(x, _L1P_P[0])
    for c in _L1P_P[1:]:
        p = _fma(p, x, c)
    small = x + _fma(x2, -0.5, (x * x2) * (p / q))

    x1 = x + 1.0
    bits = torch.clamp_min(x1, _FLT_MIN).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    lt = m < _SQRT_HALF
    e = e - lt.float()
    z = (m - 1.0) + torch.where(lt, m, torch.zeros_like(m))
    zz = z * z
    z3 = zz * z
    c = _LOG_P
    pa = _fma(_fma(z, c[0], c[1]), z, c[6])
    pb = _fma(_fma(z, c[2], c[3]), z, c[7])
    pc = _fma(_fma(z, c[4], c[5]), z, c[8])
    poly = _fma(_fma(pa, z3, pb), z3, pc)
    big = _fma(e, _LN2_HI, _fma(zz, -0.5, z) + _fma(poly, z3, e * _LN2_LO))
    big = torch.where(x1 == float("inf"), x1, big)
    big = torch.where(x1 == 0, torch.full_like(x1, -float("inf")), big)
    big = torch.where(~(x1 >= 0), torch.full_like(x1, float("nan")), big)
    return torch.where(x.abs() < _L1P_SMALL, small, big)


# XLA's f32 tanh: x itself below 0.0004, +-1 from 20 on, else the rational
# function of the argument clamped to +-7.9999 (Horner's rule in fused
# multiply-adds over x^2)
_TANH_SMALL = _f32("0x3F3A36E2E0000000")
_TANH_CLAMP = _f32("0x401FFEC880000000")
_TANH_P = [_f32(h) for h in (
    "0xBCB3E4B800000000", "0x3D4C266FC0000000", "0xBDD7A6FFE0000000",
    "0x3E6B800820000000", "0x3EEF286940000000", "0x3F44E1BDA0000000",
    "0x3F740B3B80000000")]
_TANH_Q = [_f32(h) for h in (
    "0x3EB41A7B00000000", "0x3F1F12BAC0000000", "0x3F629540A0000000",
    "0x3F740B3BA0000000")]


def _tanh_xla(x):
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    p = _fma(x2, _TANH_P[0], _TANH_P[1])
    for c in _TANH_P[2:]:
        p = _fma(x2, p, c)
    q = _fma(x2, _TANH_Q[0], _TANH_Q[1])
    for c in _TANH_Q[2:]:
        q = _fma(x2, q, c)
    out = torch.where(x.abs() < _TANH_SMALL, x, (xc * p) / q)
    return torch.where(x.abs() >= 20.0, torch.copysign(
        torch.ones_like(x), x), out)


_CARD_FORMS = [False]


@contextlib.contextmanager
def card_forms():
    """Inside the block CPU tensors take the card's forms too: every
    function here, and ``models.layers``' ``dot`` and ``gelu``, run
    PyTorch's plain operators instead of XLA's CPU arithmetic.  For the
    dry run (``launch.dryrun``), which counts the operators of the card's
    program while tracing on CPU tensors; nothing else enters it, so every
    CPU result keeps its exact arithmetic.  Process-wide, not a thread's:
    a checkpoint's recompute may run on the autograd engine's thread."""
    prev = _CARD_FORMS[0]
    _CARD_FORMS[0] = True
    try:
        yield
    finally:
        _CARD_FORMS[0] = prev


def exact_forms(x) -> bool:
    """Whether ``x`` takes XLA's exact CPU forms: a CPU tensor outside
    :func:`card_forms`."""
    return x.device.type == "cpu" and not _CARD_FORMS[0]


# ---------------------------------------------------------------------------
# autograd: each function above that builds its value from bit patterns is
# wrapped in a torch.autograd.Function whose forward is that exact value
# and whose backward is the JAX package's own VJP rule for the operation
# (evaluated with PyTorch's arithmetic: gradients are held to bounds)
# ---------------------------------------------------------------------------

def _unbroadcast(g, like):
    """The VJP of broadcasting ``like`` to g's shape: g summed over the
    broadcast dimensions, in ``like``'s dtype; None for a float operand."""
    if not torch.is_tensor(like):
        return None
    while g.dim() > like.dim():
        g = g.sum(0)
    for i, n in enumerate(like.shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g.to(like.dtype)


class _Fma(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c):
        ctx.consts = [None if torch.is_tensor(x) else x for x in (a, b, c)]
        ctx.save_for_backward(*(x if torch.is_tensor(x) else None
                                for x in (a, b, c)))
        return _fma(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b, c = (t if k is None else k
                   for t, k in zip(ctx.saved_tensors, ctx.consts))
        need = ctx.needs_input_grad
        return (_unbroadcast(g * b, a) if need[0] else None,
                _unbroadcast(g * a, b) if need[1] else None,
                _unbroadcast(g, c) if need[2] else None)


def _unary(name: str, value, vjp):
    """``value(x)`` with the VJP ``vjp(g, x, ans)``, as an autograd
    Function's ``apply``."""

    def forward(ctx, x):
        ans = value(x)
        ctx.save_for_backward(x, ans)
        return ans

    def backward(ctx, g):
        x, ans = ctx.saved_tensors
        return vjp(g, x, ans)

    cls = type(name, (torch.autograd.Function,),
               {"forward": staticmethod(forward),
                "backward": staticmethod(backward)})
    return cls.apply


_exp_cpu = _unary("_Exp", lambda x: _exp_xla(x.float()).to(x.dtype),
                  lambda g, x, ans: g * ans)
_log1p_cpu = _unary("_Log1p", lambda x: _log1p_xla(x.float()).to(x.dtype),
                    lambda g, x, ans: g / (x + 1))
_tanh_cpu = _unary("_Tanh", lambda x: _tanh_xla(x.float()).to(x.dtype),
                   lambda g, x, ans: (g + g * ans) * (1 - ans))
_LIBM = []


def _libm():
    """The C library's math functions, loaded once."""
    if not _LIBM:
        import ctypes
        import ctypes.util
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        for name, n in (("cosf", 1), ("sinf", 1), ("powf", 2)):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float] * n
        _LIBM.append(lib)
    return _LIBM[0]


@functools.lru_cache(maxsize=64)
def _libm_table(name: str, key: bytes, *first) -> np.ndarray:
    """The C library's f32 ``name(*first, v)`` of each f32 v in ``key`` (a
    rope's angles recur in every layer of a forward)."""
    fn = getattr(_libm(), name)
    return np.array([fn(*first, float(v))
                     for v in np.frombuffer(key, np.float32)], np.float32)


def _libm_f32(name: str, x, *first):
    """The C library's f32 ``name(*first, v)`` of every element v of an
    f32 ``x``, computed once for each distinct value; of a fake tensor
    (the operator count, which reads no values), PyTorch's own."""
    from torch._subclasses.fake_tensor import FakeTensor
    if isinstance(x, FakeTensor):
        return {"cosf": torch.cos, "sinf": torch.sin,
                "powf": lambda t: first[0] ** t}[name](x)
    vals, inv = torch.unique(x.detach(), return_inverse=True)
    table = _libm_table(name, vals.numpy().tobytes(), *first)
    return torch.from_numpy(table)[inv].to(x.dtype)


_cos_cpu = _unary("_Cos", lambda x: _libm_f32("cosf", x),
                  lambda g, x, ans: -g * torch.sin(x))
_sin_cpu = _unary("_Sin", lambda x: _libm_f32("sinf", x),
                  lambda g, x, ans: g * torch.cos(x))
_sqrt_cpu = _unary("_Sqrt", lambda x: torch.sqrt(x.double()).to(x.dtype),
                   lambda g, x, ans: g * (0.5 / ans))
_rsqrt_cpu = _unary("_Rsqrt", lambda x: torch.rsqrt(x.double()).to(x.dtype),
                    lambda g, x, ans: g * (-0.5 * (ans / x)))


def _settled(x):
    """A DTensor's pending partial sums reduced first (``Partial`` becomes
    ``Replicate``): the bit operations of :func:`fma` and :func:`cumsum`
    are not linear, and DTensor would carry a partial sum through them.
    Any other value as it is."""
    pl = getattr(x, "placements", None)
    if pl is None or not any(p.is_partial() for p in pl):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in pl])


def fma(a, b, c):
    """round_f32(a * b + c), one rounding, on every device.  Any operand
    may be a float; differentiable (VJP: g b, g a, g)."""
    a, b, c = _settled(a), _settled(b), _settled(c)
    if any(torch.is_tensor(x) and x.requires_grad for x in (a, b, c)):
        return _Fma.apply(a, b, c)
    return _fma(a, b, c)


def exp(x):
    """exp in x's dtype (bf16 computes in f32 and rounds once, as XLA
    does); VJP g * ans."""
    if not exact_forms(x):
        return torch.exp(x)
    return _exp_cpu(x)


def log1p(x):
    """VJP g / (1 + x)."""
    if not exact_forms(x):
        return torch.log1p(x)
    return _log1p_cpu(x)


def sqrt(x):
    """Correctly rounded (via f64 on the CPU: rounding twice is exact for
    a square root); VJP g * (0.5 / ans)."""
    if not exact_forms(x):
        return torch.sqrt(x)
    return _sqrt_cpu(x)


def tanh(x):
    """VJP (g + g * ans) * (1 - ans)."""
    if not exact_forms(x):
        return torch.tanh(x)
    return _tanh_cpu(x)


def muladd(a, b, c):
    """``a * b + c`` as the JAX package's CPU backend contracts it: one
    fused multiply-add (:func:`fma`) on CPU tensors; on the card
    PyTorch's multiply and add."""
    like = next(x for x in (a, b, c) if torch.is_tensor(x))
    return fma(a, b, c) if exact_forms(like) else a * b + c


def _softplus_value(x):
    out = torch.clamp_min(x, 0.0) + log1p(exp(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


_softplus = _unary("_Softplus", _softplus_value,
                   lambda g, x, ans: g * torch.exp(x - ans))


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``; VJP g * exp(x - ans)
    (``logaddexp``'s own rule)."""
    return _softplus(x)


def cos(x):
    """cos of an f32 tensor: on the CPU the C library's ``cosf``, which
    XLA's CPU backend calls (PyTorch's vectorised cos differs in the last
    bit of some results); VJP -g sin(x)."""
    if not exact_forms(x):
        return torch.cos(x)
    return _cos_cpu(x)


def sin(x):
    """sin of an f32 tensor: on the CPU the C library's ``sinf``, as
    :func:`cos`; VJP g cos(x)."""
    if not exact_forms(x):
        return torch.sin(x)
    return _sin_cpu(x)


def power(base: float, x):
    """``base ** x`` for an f32 tensor ``x``: on the CPU the C library's
    ``powf`` (XLA's CPU pow) of ``base`` rounded to f32; no gradient (the
    rope's frequencies are constants)."""
    if not exact_forms(x):
        return base ** x
    return _libm_f32("powf", x, float(np.float32(base)))


def rsqrt(x):
    """1 / sqrt(x), correctly rounded on the CPU (see the module's note);
    VJP g * (-0.5 * ans / x)."""
    if not exact_forms(x):
        return torch.rsqrt(x)
    return _rsqrt_cpu(x)


def _plain_vjp(plain, g, needs, *args):
    """The VJP of ``plain(*args)`` (the same function in PyTorch's
    differentiable operations) at the tensors of ``args`` that ``needs``
    marks, None elsewhere."""
    with torch.enable_grad():
        xs = [a.detach().requires_grad_(n) if torch.is_tensor(a) else a
              for a, n in zip(args, needs)]
        wrt = [x for x, n in zip(xs, needs) if n]
        grads = iter(torch.autograd.grad(plain(*xs), wrt, g)) if wrt else None
    return tuple(next(grads) if n else None for n in needs)


class _Exact(torch.autograd.Function):
    """``exact(*args)``'s value with ``plain(*args)``'s VJP."""

    @staticmethod
    def forward(ctx, exact, plain, *args):
        ctx.plain = plain
        ctx.consts = [None if torch.is_tensor(a) else a for a in args]
        ctx.save_for_backward(*(a if torch.is_tensor(a) else None
                                for a in args))
        return exact(*args)

    @staticmethod
    def backward(ctx, g):
        args = [t if k is None else k
                for t, k in zip(ctx.saved_tensors, ctx.consts)]
        return (None, None) + _plain_vjp(ctx.plain, g,
                                         ctx.needs_input_grad[2:], *args)


def _exact(exact, plain, *args):
    """``exact(*args)``, differentiable through ``plain`` when a tensor
    argument requires grad."""
    if any(torch.is_tensor(a) and a.requires_grad for a in args):
        return _Exact.apply(exact, plain, *args)
    return exact(*args)


_WINDOW = 32  # XLA's CPU reduction splits a row into windows of this size


def _sum_rows(x):
    """Sum the last axis left to right."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _sum_last(x, y):
    """XLA's CPU order for the sum over the last axis of ``x * y``, the
    product fused into the reduction: a row of at most 32
    accumulates ``acc = fma(x_i, y_i, acc)`` from 0; a longer row
    multiplies first, pads to a multiple of 32 with zeros (half on each
    side, the odd one on the right), sums each window left to right and
    reduces the window sums the same way until at most 32 remain, which it
    sums left to right."""
    n = x.shape[-1]
    if n <= _WINDOW:
        acc = torch.zeros_like(x[..., 0])
        for i in range(n):
            acc = _fma(x[..., i], y[..., i], acc)
        return acc
    x = x * y
    while x.shape[-1] > _WINDOW:
        m = -(-x.shape[-1] // _WINDOW)
        pad = m * _WINDOW - x.shape[-1]
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = _sum_rows(x.reshape(x.shape[:-1] + (m, _WINDOW)))
    return _sum_rows(x)


def mean_sq(x):
    """mean(x * x) over the last axis of f32 ``x``, keeping the axis; on
    the CPU in XLA's order (:func:`_sum_last`).  The mean multiplies by
    1/N rounded to f32."""
    if not exact_forms(x):
        return torch.mean(x * x, dim=-1, keepdim=True)
    return _exact(_mean_sq_xla, lambda t: torch.mean(t * t, dim=-1,
                                                     keepdim=True), x)


def _mean_sq_xla(x):
    return (_sum_last(x, x) * float(np.float32(1.0 / x.shape[-1])))[..., None]


def sum_product(x, y, dim: int):
    """``jnp.sum(x * y, axis=dim)`` (the product broadcast, fused into the
    reduction): on CPU tensors in XLA's order (:func:`_sum_last`), on the
    card PyTorch's."""
    if not exact_forms(x):
        return (x * y).sum(dim)
    return _exact(_sum_product_xla, lambda a, b, d: (a * b).sum(d), x, y,
                  dim)


def _sum_product_xla(x, y, dim: int):
    x, y = torch.broadcast_tensors(x, y)
    return _sum_last(x.movedim(dim, -1), y.movedim(dim, -1))


_TILE = 8  # rows of a tile of XLA's CPU matrix-vector emitter


def einsum(eq: str, a, b):
    """An f32 ``jnp.einsum`` of two operands over one contracted index.

    On CPU tensors in the order of XLA's CPU dot emitters: one fused
    multiply-add a term, in the contraction's order, from 0 (Eigen's
    kernels, and the tiled matrix-vector emitter's rows).  When one
    operand has no free index (a matrix-vector product) and the matrix's
    rows leave one row past the last whole tile of 8, that row adds its
    first 8 terms as rounded products, one by one, and fuses the rest.
    That is XLA's order wherever each free size is 1 or 17 to 64, the
    batch is not 1 and the contraction is 8 to 129 long (the mLSTM and
    sLSTM at their SMOKE width); on the card it is ``torch.einsum``
    (of a mesh's DTensors, each rank's product of its shards:
    :func:`repro_torch.parallel.sharding.einsum`)."""
    if not exact_forms(a):
        from .parallel import sharding
        return sharding.einsum(eq, a, b)
    return _exact(_einsum_xla, torch.einsum, eq, a, b)


def _einsum_xla(eq: str, a, b):
    ins, out = eq.split("->")
    sa, sb = ins.split(",")
    (c,) = [x for x in sa if x in sb and x not in out]
    size = {**dict(zip(sa, a.shape)), **dict(zip(sb, b.shape))}
    ra, rb = sa.replace(c, ""), sb.replace(c, "")
    # every term's product, exact in f64 (the contraction index kept)
    terms = torch.einsum(f"{sa},{sb}->{c}{out}", a.double(), b.double())
    acc = terms[0].float() + 0.0  # fma(x, y, +0): -0 becomes +0
    for t in terms[1:]:
        acc = _add_exact(t, acc.double())
    rows = [[x for x in ra if x not in rb], [x for x in rb if x not in ra]]
    if all(math.prod(size[x] for x in r) > 1 for r in rows):
        return acc
    # a matrix-vector product: the matrix's rows in tiles of 8
    (row,) = max(rows, key=lambda r: math.prod(size[x] for x in r)) or [
        None]
    m = size[row] if row else 1
    if m % _TILE != 1:
        return acc
    edge = terms[0].float()
    for i, t in enumerate(terms[1:], 1):
        edge = edge + t.float() if i < _TILE else _add_exact(t,
                                                             edge.double())
    if row is None:
        return edge
    k = out.index(row)
    acc = acc.movedim(k, 0).clone()
    acc[-1] = edge.movedim(k, 0)[-1]
    return acc.movedim(0, k)


_BLOCK = 16  # XLA's CPU pipeline splits a cumulative sum into blocks of this


def _prefix_rows(x):
    """Inclusive prefix sums of the last axis, left to right from +0."""
    acc = torch.zeros_like(x[..., 0])
    out = []
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        out.append(acc)
    return torch.stack(out, -1)


def _blocked_prefix(x):
    n = x.shape[-1]
    if n <= _BLOCK:
        return _prefix_rows(x)
    nb = -(-n // _BLOCK)
    x = torch.nn.functional.pad(x, (0, nb * _BLOCK - n))
    inner = _prefix_rows(x.reshape(x.shape[:-1] + (nb, _BLOCK)))
    totals = _blocked_prefix(inner[..., -1])  # (..., nb), inclusive
    excl = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    out = inner + excl[..., None]
    return out.reshape(x.shape)[..., :n]


def cumsum(x, dim: int):
    """``jnp.cumsum`` along ``dim`` in XLA's CPU order, on every device (the
    mLSTM kernel sums in this order, and its plain version with it): up
    to 16 elements left to right from +0; longer, the axis padded with
    zeros to blocks of 16, each block's prefix left to right, and each
    element plus the sum of the earlier blocks' totals (their inclusive
    prefix, in the same order, shifted by one)."""
    return _exact(_cumsum_xla, torch.cumsum, _settled(x), dim)


def _cumsum_xla(x, dim: int):
    return _blocked_prefix(x.movedim(dim, -1)).movedim(-1, dim)
