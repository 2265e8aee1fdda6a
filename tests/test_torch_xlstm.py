"""The port's xLSTM path (mLSTM and sLSTM blocks, xlstm-350m serving)
against the JAX package's, on the CPU.

Held to the JAX package compiled with ``xla_allow_excess_precision`` off:

* ``repro_torch.numerics``: XLA's CPU tanh (a rational function in fused
  multiply-adds) and cumulative sum (blocks of 16), bit for bit; its dot
  and fused-reduction orders (``einsum``, ``sum_product``) at the mLSTM's
  shapes, bit for bit.
* The mLSTM's plain versions: ``mlstm_ref`` (the sequential oracle) and
  ``mlstm_chunk_ref`` (the model's ``mlstm_scan_chunked`` with the state
  carried in and out) bit for bit against their JAX counterparts;
  ``mlstm_chunk_ref`` against the Pallas kernel in interpret mode at the
  kernel tests' bound (``tests/test_kernels.py:165-166``, atol 3e-4 /
  rtol 3e-3).  Where the port's CPU order stops being XLA's: several
  chunks of 21 to 32 positions (XLA's loop vectorizer reassociates the
  fused sums inside its scan), larger matrices (Eigen's other kernels)
  and a dot with a batch of one (XLA fuses it into a loop); there the
  two agree to the last few bits, and
  ``test_chunked_outside_xla_order_agrees_closely`` holds them to 1e-5.
  The model tests use chunks of 17 and 20 (several chunks, the padded
  tail) and the default 256 (one chunk).
* The blocks (``apply_mlstm``, ``apply_slstm``), prefill then decode:
  bit for bit.
* xlstm-350m ``SMOKE`` (4 layers: mLSTM x 3, sLSTM): every cache leaf bit
  for bit after prefill and each decode step; the logits within the bf16
  bound (2e-2 + 2e-2 |x|) and their argmax outside near-ties — the
  head's and the final norm's rsqrt (``numerics.rsqrt``, correctly
  rounded, where XLA refines the processor's estimate) may flip a last
  bf16 bit, as in ``test_torch_recurrent.py``; ``ServeEngine``'s tokens
  equal the strict JAX engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels.mlstm_chunk.ops import mlstm as jax_mlstm_pallas
from repro.kernels.mlstm_chunk.ref import mlstm_ref as jax_mlstm_ref
from repro.models import lm as jax_lm
from repro.models import recurrent as jax_rec
from repro_torch import configs, numerics
from repro_torch.kernels.mlstm_chunk import ops as mops
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_ref, mlstm_ref,
                                                 mlstm_seq)
from repro_torch.models import lm
from repro_torch.models import recurrent as rec
from repro_torch.models.interop import params_from_numpy, params_to_numpy
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_recurrent import (Strict, _assert_caches_equal, _bits_equal,
                                  _leaves, _near_tie_or_same_argmax, _np,
                                  _serve, _teacher_forced,
                                  _within_bf16_bound, strict)

ARCH = "xlstm-350m"
MLSTM_ATOL, MLSTM_RTOL = 3e-4, 3e-3  # tests/test_kernels.py:165-166
# (BH, S, dh, K): tests/test_kernels.py:149-154
KERNEL_CASES = [(2, 128, 64, 32), (4, 256, 128, 64), (1, 256, 64, 256),
                (1, 128, 64, 1)]
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _jax_in_f32():
    """The references are the JAX package's f32 functions.  Its core
    modules turn on ``jax_enable_x64`` when they are imported (by another
    test file in the same process, say), and then the mLSTM's numpy
    constants (``1 / np.sqrt(dh)``) promote it to f64: keep x64 off while
    this module runs."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", was)


def _gates(rng, shape):
    """log f = log sigmoid of N(0, 2^2), log i ~ N(0, 1), as
    tests/test_kernels.py draws them."""
    log_f = -np.log1p(np.exp(-2 * rng.standard_normal(shape)))
    return log_f.astype(np.float32), rng.standard_normal(shape).astype(
        np.float32)


def _mlstm_inputs(B, S, H, dh, seed, state=True):
    """bf16-valued q/k/v (B, S, H, dh) as f32, gates, and a state (zero
    or N(0, 0.1^2))."""
    rng = np.random.default_rng(seed)
    q, k, v = (np.array(jnp.asarray(rng.standard_normal((B, S, H, dh)),
                                      jnp.bfloat16).astype(jnp.float32))
               for _ in range(3))
    log_f, log_i = _gates(rng, (B, S, H))
    C0 = 0.1 * rng.standard_normal((B, H, dh, dh))
    n0 = 0.1 * rng.standard_normal((B, H, dh))
    if not state:
        C0, n0 = 0 * C0, 0 * n0
    return q, k, v, log_f, log_i, C0.astype(np.float32), n0.astype(
        np.float32)


def _bf16_pair(*xs):
    return ([jnp.asarray(x).astype(jnp.bfloat16) for x in xs],
            [T(x).to(torch.bfloat16) for x in xs])


# ---------------------------------------------------------------------------
# numerics: XLA's CPU tanh, cumsum, dot and reduction orders
# ---------------------------------------------------------------------------

def test_tanh_equals_xla_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(1 << 17) * 4,              # the bulk
        np.exp(rng.uniform(-104, -7, 1 << 14)),        # tiny, denormals
        -np.exp(rng.uniform(-104, -7, 1 << 14)),
        rng.uniform(-30, 30, 1 << 14),                 # past the clamp
        np.exp(rng.uniform(3, 88, 1 << 12)) * rng.choice([-1, 1], 1 << 12),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 4e-4, -4e-4, 3.9999e-4,
         7.99990, 8.0, -8.0, 20.0, -20.0, 19.999998, 1e-45, 3.4e38]]
    ).astype(np.float32)
    _bits_equal(numerics.tanh(T(x)), strict(jnp.tanh, x), "tanh")
    assert numerics.tanh(torch.zeros(3, dtype=torch.bfloat16)).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("first", [1, 51, 101, 151, 201, 251])
def test_cumsum_equals_xla_bit_for_bit(first):
    """Lengths 1-300 (50 a case): the plain order up to 16, then blocks
    of 16, then blocks of blocks past 256."""
    lens = range(first, first + 50)
    rng = np.random.default_rng(first)
    xs = [rng.standard_normal((2, n, 3)).astype(np.float32) for n in lens]
    want = strict(lambda *a: [jnp.cumsum(x, axis=1) for x in a], *xs)
    for n, x, w in zip(lens, xs, want):
        _bits_equal(numerics.cumsum(T(x), 1), w, f"length {n}")
    # and along the last axis, past 256 blocks of blocks
    x = rng.standard_normal((3, 4100)).astype(np.float32)
    _bits_equal(numerics.cumsum(T(x), -1), strict(
        lambda a: jnp.cumsum(a, axis=-1), x), "length 4100")


EINSUMS = ["bkhd,bhde->bkhe", "bkhd,bhd->bkh", "bjhd,blhd->bjlh",
           "bjlh,blhe->bjhe", "blhd,blhe->bhde"]


@pytest.mark.parametrize("K", [1, 17, 19, 40, 64])
def test_einsum_and_sum_product_in_xla_order(K):
    """The chunked mLSTM's five products at SMOKE width (B 2, H 4, dh 32)
    and its fused sums of products over the chunk."""
    rng = np.random.default_rng(K)
    B, H, dh = 2, 4, 32
    x = {c: rng.standard_normal(s).astype(np.float32) for c, s in (
        ("q", (B, K, H, dh)), ("k", (B, K, H, dh)), ("C", (B, H, dh, dh)),
        ("n", (B, H, dh)), ("s", (B, K, K, H)))}
    ops = dict(zip(EINSUMS, [("q", "C"), ("q", "n"), ("q", "k"), ("s", "k"),
                             ("q", "k")]))
    for eq, (a, b) in ops.items():
        want = strict(lambda u, w: jnp.einsum(eq, u, w), x[a], x[b])
        _bits_equal(numerics.einsum(eq, T(x[a]), T(x[b])), want, eq)
    w = rng.uniform(0, 2, (B, K, K, H)).astype(np.float32)
    _bits_equal(numerics.sum_product(T(x["s"]), T(w), 2),
                strict(lambda u, v: jnp.sum(u * v, axis=2), x["s"], w),
                "sum over l")


# ---------------------------------------------------------------------------
# the mLSTM's plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("BH,S,dh", [(3, 12, 32), (2, 12, 64), (2, 10, 128),
                                     (2, 12, 48)])
def test_mlstm_ref_equals_jax_bit_for_bit(BH, S, dh):
    rng = np.random.default_rng(BH * S + dh)
    q, k, v = (rng.standard_normal((BH, S, dh)).astype(np.float32)
               for _ in range(3))
    log_f, log_i = _gates(rng, (BH, S))
    want = strict(jax_mlstm_ref, q, k, v, log_f, log_i)
    _bits_equal(mlstm_ref(*map(T, (q, k, v, log_f, log_i))), want, "h")


@pytest.mark.parametrize("case", KERNEL_CASES, ids=str)
def test_chunk_ref_matches_the_pallas_kernel(case):
    """tests/test_kernels.py's cases, f32 q/k/v: the port's chunked plain
    version at the kernel's K against the Pallas kernel in interpret mode
    and against JAX's sequential oracle."""
    BH, S, dh, K = case
    rng = np.random.default_rng(BH + S + dh + K)
    q, k, v = (rng.standard_normal((BH, S, dh)).astype(np.float32)
               for _ in range(3))
    log_f, log_i = _gates(rng, (BH, S))
    want = np.asarray(jax_mlstm_pallas(q, k, v, log_f, log_i, K=K,
                                       interpret=True))
    zeros = torch.zeros((BH, 1, dh, dh)), torch.zeros((BH, 1, dh))
    got, _, _ = mlstm_chunk_ref(*(T(x)[:, :, None] for x in (
        q, k, v, log_f, log_i)), *zeros, K)
    np.testing.assert_allclose(_np(got[:, :, 0]), want, atol=MLSTM_ATOL,
                               rtol=MLSTM_RTOL)
    np.testing.assert_allclose(
        _np(got[:, :, 0]), np.asarray(jax_mlstm_ref(q, k, v, log_f, log_i)),
        atol=MLSTM_ATOL, rtol=MLSTM_RTOL)


# (B, S, H, dh, chunk): one chunk (the default 256 over 19); several, the
# tail padded (40 over 17) and not (40 over 20, 128 over 64, 74 over 37);
# chunk 1 (decode)
CHUNKED = [(2, 19, 4, 32, 256), (2, 40, 4, 32, 17), (2, 40, 4, 32, 20),
           (2, 128, 4, 32, 64), (2, 74, 4, 32, 37), (2, 5, 4, 32, 1)]


@pytest.mark.parametrize("case", CHUNKED, ids=str)
def test_mlstm_scan_chunked_equals_jax_bit_for_bit(case):
    B, S, H, dh, chunk = case
    q, k, v, log_f, log_i, C0, n0 = _mlstm_inputs(B, S, H, dh, sum(case))
    (jq, jk, jv), (tq, tk, tv) = _bf16_pair(q, k, v)
    want = strict(lambda *a: jax_rec.mlstm_scan_chunked(*a, chunk=chunk),
                  jq, jk, jv, log_f, log_i, C0, n0)
    got = rec.mlstm_scan_chunked(tq, tk, tv, *map(T, (log_f, log_i, C0,
                                                       n0)), chunk)
    for name, g, w in zip("hCn", got, want):
        _bits_equal(g, w, name)


@pytest.mark.parametrize("case", [(2, 48, 4, 32, 24), (1, 100, 2, 64, 33)],
                         ids=str)
def test_chunked_outside_xla_order_agrees_closely(case):
    """Several chunks of 24, and dh 64: XLA sums some products in another
    order there; the port's plain version stays within 1e-5."""
    B, S, H, dh, chunk = case
    q, k, v, log_f, log_i, C0, n0 = _mlstm_inputs(B, S, H, dh, sum(case))
    (jq, jk, jv), (tq, tk, tv) = _bf16_pair(q, k, v)
    want = strict(lambda *a: jax_rec.mlstm_scan_chunked(*a, chunk=chunk),
                  jq, jk, jv, log_f, log_i, C0, n0)
    got = rec.mlstm_scan_chunked(tq, tk, tv, *map(T, (log_f, log_i, C0,
                                                       n0)), chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_state_carries_across_calls():
    """Two halves with (C, n) handed across equal one run over the whole,
    bit for bit; the chunked form against the sequential recurrence from
    the same nonzero state within the kernel tests' bound."""
    q, k, v, log_f, log_i, C0, n0 = map(T, _mlstm_inputs(2, 40, 4, 32, 5))
    h, C, n = mlstm_chunk_ref(q, k, v, log_f, log_i, C0, n0, 8)
    h1, C1, n1 = mlstm_chunk_ref(q[:, :24], k[:, :24], v[:, :24],
                                 log_f[:, :24], log_i[:, :24], C0, n0, 8)
    h2, C2, n2 = mlstm_chunk_ref(q[:, 24:], k[:, 24:], v[:, 24:],
                                 log_f[:, 24:], log_i[:, 24:], C1, n1, 8)
    _bits_equal(torch.cat([h1, h2], 1), h, "h")
    _bits_equal(C2, C, "C")
    _bits_equal(n2, n, "n")
    hs, Cs, ns = mlstm_seq(q, k, v, log_f, log_i, C0, n0)
    for g, w in ((h, hs), (C, Cs), (n, ns)):
        np.testing.assert_allclose(_np(g), _np(w), atol=MLSTM_ATOL,
                                   rtol=MLSTM_RTOL)


def test_mlstm_op_takes_the_plain_version_on_the_cpu():
    args = list(map(T, _mlstm_inputs(2, 21, 4, 32, 6)))
    args[:3] = [x.to(torch.bfloat16) for x in args[:3]]
    n0 = mops.mlstm_chunk.launches
    for chunk in (1, 8, 64):
        got = mops.mlstm_chunk(*args, chunk=chunk)
        for g, w in zip(got, mlstm_chunk_ref(*args, chunk)):
            _bits_equal(g, w)
    assert mops.mlstm_chunk.launches == n0  # no kernel on the CPU
    assert [tuple(x.shape) for x in got] == [(2, 21, 4, 32), (2, 4, 32, 32),
                                             (2, 4, 32)]


def test_mlstm_op_rejects_what_it_does_not_take():
    q, k, v, log_f, log_i, C0, n0 = map(T, _mlstm_inputs(2, 8, 4, 32, 7))
    with pytest.raises(TypeError, match="float32"):
        mops.mlstm_chunk(q, k, v, log_f.double(), log_i, C0, n0)
    with pytest.raises(TypeError, match="bfloat16"):
        mops.mlstm_chunk(q.half(), k.half(), v.half(), log_f, log_i, C0, n0)
    with pytest.raises(ValueError, match="expected"):
        mops.mlstm_chunk(q, k, v, log_f, log_i, C0[:, :, :-1], n0)
    with pytest.raises(ValueError, match="expected"):
        mops.mlstm_chunk(q, k[:, :-1], v, log_f, log_i, C0, n0)
    with pytest.raises(ValueError, match="S must be"):
        mops.mlstm_chunk(q[:, :0], k[:, :0], v[:, :0], log_f[:, :0],
                         log_i[:, :0], C0, n0)
    with pytest.raises(ValueError, match="on cpu"):
        mops.mlstm_chunk(q.to("meta"), k, v, log_f, log_i, C0, n0)
    with pytest.raises(ValueError, match="unsupported device"):
        mops.mlstm_chunk(*(x.to("meta") for x in (q, k, v, log_f, log_i,
                                                  C0, n0)))


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blocks():
    cfg = jax_configs.get_smoke(ARCH)
    out = {}
    for kind in ("mlstm", "slstm"):
        jp = getattr(jax_rec, f"init_{kind}")(cfg, jax.random.PRNGKey(3))
        out[kind] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu"))
    return cfg, configs.get_smoke(ARCH), out


@pytest.mark.parametrize("kind,S,chunk", [("mlstm", 19, 256),
                                          ("mlstm", 40, 17),
                                          ("slstm", 19, 256),
                                          ("slstm", 24, 256)])
def test_blocks_prefill_and_decode_equal_jax(blocks, kind, S, chunk):
    cfg, tcfg, params = blocks
    jp, tp = params[kind]
    if kind == "mlstm":
        f = Strict(lambda p, x, c: jax_rec.apply_mlstm(cfg, p, x, c,
                                                       chunk=chunk))
        g = lambda p, x, c: rec.apply_mlstm(tcfg, p, x, c, chunk=chunk)
    else:
        f = Strict(lambda p, x, c: jax_rec.apply_slstm(cfg, p, x, c))
        g = lambda p, x, c: rec.apply_slstm(tcfg, p, x, c)
    rng = np.random.default_rng(S)
    wc = gc = None
    for step, n in enumerate((S, 1, 1, 1)):
        x = rng.standard_normal((2, n, cfg.d_model)).astype(np.float32)
        (jx,), (tx,) = _bf16_pair(x)
        wy, wc = f(jp, jx, wc)
        gy, gc = g(tp, tx, gc)
        _bits_equal(gy, wy, f"step {step} y")
        assert sorted(gc) == sorted(wc)
        for leaf in wc:
            _bits_equal(gc[leaf], wc[leaf], f"step {step} {leaf}")


def test_slstm_step_numerics_equal_jax(blocks):
    """One step from a random carry (m finite, so both exp branches
    matter): every leaf bit for bit."""
    cfg, tcfg, params = blocks
    jp, tp = params["slstm"]
    rng = np.random.default_rng(11)
    carry = [rng.standard_normal((3, cfg.d_model)).astype(np.float32)
             for _ in range(4)]
    xt = (4 * rng.standard_normal((3, cfg.d_model))).astype(np.float32)
    want = strict(lambda p, c, x: jax_rec.slstm_step(p, tuple(c), x,
                                                     cfg.n_heads),
                  jp, carry, xt)
    got = rec.slstm_step(tp, tuple(map(T, carry)), T(xt), cfg.n_heads)
    for name, g, w in zip("cnmh", got, want):
        _bits_equal(g, w, name)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_layout_and_cache_equal_jax(blocks, kind):
    cfg, tcfg, params = blocks
    want = jax.tree.map(np.asarray, params[kind][0])
    got = params_to_numpy(getattr(rec, f"init_{kind}")(
        tcfg, torch.Generator().manual_seed(0), lead=(2,)))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == (2,) + w.shape and g.dtype == w.dtype, name
        if name.startswith("b") or name == "norm":  # constants
            np.testing.assert_array_equal(g[1], w)
        else:
            scale = 0.02 if name[0] in "wr" and name[1] in "if" else \
                1 / np.sqrt(w.shape[-2])
            assert abs(g.std() / scale - 1) < 0.15, name
    jc = getattr(jax_rec, f"init_{kind}_cache")(cfg, 3)
    tc = getattr(rec, f"init_{kind}_cache")(tcfg, 3, device="cpu")
    _assert_caches_equal(tc, jc, f"{kind} cache")


# ---------------------------------------------------------------------------
# xlstm-350m SMOKE: the model and the engine
# ---------------------------------------------------------------------------

def _model(mlstm_chunk, decode_budget, n_layers=None):
    cfg, tcfg = jax_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    kw = dict(mlstm_chunk=mlstm_chunk, remat_policy="none",
              decode_budget=decode_budget)
    run, trun = jax_configs.RunConfig(**kw), configs.RunConfig(**kw)
    jp = jax_lm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, run, jp, tcfg, trun, tp


# (prompt length, mlstm_chunk, decode steps): several chunks with the
# padded tail; one chunk at the default chunk
MODEL_CASES = [(40, 17, 3), (19, 256, 4)]


@pytest.mark.parametrize("plen,chunk,steps", MODEL_CASES,
                         ids=["chunks_of_17", "one_chunk"])
def test_prefill_and_decode_equal_strict_jax(plen, chunk, steps):
    m = _model(chunk, steps)
    rng = np.random.default_rng(plen)
    toks = rng.integers(0, m[0].vocab, (2, plen)).astype(np.int32)
    feed = rng.integers(0, m[0].vocab, (2, steps)).astype(np.int32)
    for step, (gl, wl, gc, wc) in enumerate(_teacher_forced(m, toks, feed)):
        assert gl.dtype == torch.bfloat16
        _assert_caches_equal(gc, wc, f"step {step}")
        _within_bf16_bound(gl, wl, f"logits, step {step}")
        _near_tie_or_same_argmax(gl, wl, m[0].vocab, f"step {step}")


def test_forward_train_equals_jax():
    cfg, run, jp, tcfg, trun, tp = _model(20, 4)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 40)).astype(
        np.int32)
    want = strict(lambda p, b: jax_lm.forward(cfg, run, p, b)[0], jp,
                  {"tokens": jnp.asarray(toks)})
    got, aux, cache = lm.forward(tcfg, trun, tp,
                                 {"tokens": T(toks).long()})
    assert cache is None and float(aux) == 0.0
    _within_bf16_bound(got, want, "logits")
    _near_tie_or_same_argmax(got[:, -1], np.asarray(want)[:, -1], cfg.vocab,
                             "last position")


def test_serve_engine_equals_strict_jax_engine():
    """Prompts of 20 and 17 tokens (padded to 20, one chunk of 20), 6 new
    tokens each."""
    m = _model(20, 6)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, 20).astype(np.int32),
               rng.integers(0, 256, 17).astype(np.int32)]
    got, want = _serve(m, prompts, 6)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_params_tree_carries_across_six_tiles():
    """xlstm-350m's own depth (24 layers: 6 tiles of m, m, m, s, no tail)
    at SMOKE width: the JAX tree carried across and back leaf for leaf;
    the port's own init draws the same tree, shapes and dtypes."""
    cfg, _, jp, tcfg, _, tp = _model(20, 4, n_layers=24)
    assert "tail" not in jp and set(jp["tiles"]) == {"b0", "b1", "b2", "b3"}
    want = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tp["tiles"]["b3"]["slstm"]["rz"].shape[0] == 6
    assert "mlp" not in tp["tiles"]["b0"] and "ln2" not in tp["tiles"]["b0"]
    got = params_to_numpy(lm.init_params(tcfg,
                                         torch.Generator().manual_seed(0)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    jc = jax_lm.init_decode_cache(cfg, 3, 9)
    tc = lm.init_decode_cache(tcfg, 3, 9, device="cpu")
    _assert_caches_equal(tc, jc, "empty cache")


def test_decode_state_is_written_into_the_stacked_cache():
    """Every leaf of every block moves on a decode step (the mLSTM's C, n
    and the sLSTM's c, n, m, h copied back into the stacked cache), and
    the returned cache is the one passed in."""
    cfg, run, jp, tcfg, trun, tp = _model(20, 4)
    toks = torch.arange(12).reshape(2, 6) % cfg.vocab
    _, cache = lm.prefill(tcfg, trun, tp, {"tokens": toks})
    before = lm.tree_map(torch.clone, cache)
    _, after = lm.decode_step(tcfg, trun, tp, cache, toks[:, :1], 6)
    assert after is cache
    for (path, a), (_, b) in zip(_leaves(after), _leaves(before)):
        assert not torch.equal(a, b), path


def test_entry_points_default_to_the_card():
    """Without a card the engine and the op on a CUDA device raise;
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    cfg, run, jp, tcfg, trun, tp = _model(20, 4)
    with pytest.raises(RuntimeError):
        ServeEngine(tcfg, trun, tp)
    with pytest.raises(RuntimeError):
        lm.init_decode_cache(tcfg, 1, 4)
    args = [torch.zeros((1, 1, 1, 32), dtype=torch.bfloat16)] * 3 + [
        torch.zeros((1, 1, 1)), torch.zeros((1, 1, 1)),
        torch.zeros((1, 1, 32, 32)), torch.zeros((1, 1, 32))]
    with pytest.raises((RuntimeError, AssertionError)):
        mops.mlstm_chunk(*(x.to("cuda") for x in args))
    assert Request(np.arange(3, dtype=np.int32)).max_new_tokens == 16
