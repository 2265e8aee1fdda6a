"""The port's RG-LRU path and recurrentgemma-2b serving against the JAX
package's, on the CPU.

Three layers, each held to the JAX package compiled with
``xla_allow_excess_precision`` off (``STRICT``):

* ``repro_torch.numerics`` (XLA's CPU exp, log1p, sqrt, fused
  multiply-add and row-sum order) and the scan's plain versions
  (``rglru_scan_ref``, the associative scan with its odd/even order, and
  ``rglru_scan_seq``): bit for bit; against the Pallas kernel in
  interpret mode at the kernel tests' bound (``tests/test_kernels.py:131``,
  atol 1e-5 / rtol 1e-4) and bit for bit against the sequential one.
* ``apply_rglru`` prefill and decode: bit for bit.
* recurrentgemma-2b ``SMOKE`` (pattern R, R, local attention with window
  16) with 3 layers and with 5 (a tail of R, R): every cache leaf bit for
  bit after prefill and each decode step, prompts shorter and longer than
  the window, the banded prefill (small ``attn_chunk``), decode past the
  ring.  The logits are held to the bf16 bound elementwise (2e-2 + 2e-2 |x|)
  and their argmax to the reference's outside near-ties: XLA's rsqrt
  refines the processor's estimate where ``numerics.rsqrt`` rounds
  correctly (a rare norm differs in a last bit), and in decode PyTorch's
  CPU GEMM on the B rows sums in another order than XLA's, which flips a
  last bf16 bit of a rare logit.  The prefill head runs over all B * S
  rows on the CPU, as XLA's does: where the backbone agrees bit for bit,
  so do the prefill logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as jax_configs
from repro.kernels.rglru_scan.ops import rglru as jax_rglru_pallas
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref
from repro.kernels.rglru_scan.ref import rglru_scan_seq as jax_scan_seq
from repro.models import lm as jax_lm
from repro.models import recurrent as jax_rec
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import configs, numerics
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref, rglru_scan_seq
from repro_torch.models import layers, lm
from repro_torch.models import recurrent as rec
from repro_torch.models.interop import params_from_numpy, params_to_numpy
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "recurrentgemma-2b"
STRICT = {"xla_allow_excess_precision": False}
ATOL = RTOL = 2e-2  # tests/test_kernels.py:27, bf16
SCAN_ATOL, SCAN_RTOL = 1e-5, 1e-4  # tests/test_kernels.py:131
# (B, S, dr): tests/test_kernels.py:118-122, then odd S and dr
SCAN_CASES = [(2, 256, 256), (1, 512, 512), (3, 128, 1024),
              (2, 1, 300), (2, 100, 333), (1, 777, 64)]
PALLAS_TILES = {(2, 256, 256): (64, 128), (1, 512, 512): (128, 512),
                (3, 128, 1024): (32, 256)}


def strict(fn, *args):
    """``fn`` compiled with excess precision off, called once."""
    return jax.jit(fn).lower(*args).compile(STRICT)(*args)


class Strict:
    """A JAX function compiled with excess precision off, once per input
    shapes."""

    def __init__(self, fn):
        self.fn, self.done = jax.jit(fn), {}

    def __call__(self, *args):
        key = str(jax.tree.map(lambda a: (jnp.shape(a), jnp.result_type(a)),
                               args))
        if key not in self.done:
            self.done[key] = self.fn.lower(*args).compile(STRICT)
        return self.done[key](*args)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _bits_equal(got, want, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    same = (g.view(np.int32) == w.view(np.int32)) | (np.isnan(g)
                                                     & np.isnan(w))
    assert same.all(), (f"{what}: {int((~same).sum())} of {g.size} differ, "
                        f"max {np.nanmax(np.abs(g - w))}")


def _scan_inputs(case, seed):
    """tests/test_kernels.py's RG-LRU inputs, from numpy: a decay in (0, 1),
    b at scale 0.5, h0 standard normal."""
    B, S, dr = case
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, dr))))
    b = 0.5 * rng.standard_normal((B, S, dr))
    h0 = rng.standard_normal((B, dr))
    return tuple(x.astype(np.float32) for x in (a, b, h0))


# ---------------------------------------------------------------------------
# numerics: XLA's CPU arithmetic
# ---------------------------------------------------------------------------

def _domain(name, rng):
    n = 1 << 16
    if name in ("exp",):
        return rng.uniform(-87, 88, n)
    if name == "log1p":
        return np.concatenate([rng.uniform(-0.999, 5, n // 2),
                               rng.uniform(-0.4, 0.4, n // 4),
                               np.exp(rng.uniform(-10, 30, n // 4))])
    if name in ("sqrt", "rsqrt"):
        return np.exp(rng.uniform(-30, 30, n))
    return rng.standard_normal(n) * 8


NUMERICS = {
    "exp": (jnp.exp, numerics.exp),
    "log1p": (jnp.log1p, numerics.log1p),
    "softplus": (jax.nn.softplus, numerics.softplus),
    "sqrt": (jnp.sqrt, numerics.sqrt),
}


@pytest.mark.parametrize("name", list(NUMERICS))
def test_numerics_equal_xla_bit_for_bit(name):
    x = _domain(name, np.random.default_rng(0)).astype(np.float32)
    jf, tf = NUMERICS[name]
    _bits_equal(tf(torch.from_numpy(x)), strict(jf, x), name)


def test_bf16_exp_rounds_once_like_xla():
    """Every finite bf16 value: exp computed in f32 and rounded once."""
    allb = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    x = allb[torch.isfinite(allb) & (allb.float().abs() < 80)]
    want = strict(lambda v: jnp.exp(v).astype(jnp.float32),
                  jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    _bits_equal(numerics.exp(x), want, "bf16 exp")


def test_fma_is_one_rounding_as_xla_contracts():
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal(1 << 16).astype(np.float32) for _ in "ab")
    c = (rng.standard_normal(1 << 16) * 1e-3).astype(np.float32)
    got = numerics.fma(*(torch.from_numpy(v) for v in (a, b, c)))
    _bits_equal(got, strict(lambda x, y, z: x * y + z, a, b, c), "a*b+c")
    # rounding twice (f64, then f32) gets this one wrong: the exact sum
    # 1 + 2^-23 + 2^-24 - 2^-70 is just under a tie of f32 values, its f64
    # rounding is the tie, and the tie rounds to even
    x = torch.tensor([1 + 2.0 ** -23])
    y = torch.tensor([2.0 ** -24 - 2.0 ** -47])
    assert float((x.double() * y + x).float()) == 1 + 2.0 ** -22
    assert float(numerics.fma(x, y, x)) == 1 + 2.0 ** -23


@pytest.mark.parametrize("n", [16, 64, 100, 2560])
def test_mean_sq_sums_in_xla_order(n):
    x = (np.random.default_rng(n).standard_normal((512, n)) * 2).astype(
        np.float32)
    want = strict(lambda v: jnp.mean(v * v, axis=-1, keepdims=True), x)
    _bits_equal(numerics.mean_sq(torch.from_numpy(x)), want, f"n={n}")


def test_rsqrt_is_correctly_rounded():
    """XLA refines the processor's own estimate, so the port rounds
    correctly instead; both are within one ulp of each other."""
    x = _domain("rsqrt", np.random.default_rng(2)).astype(np.float32)
    got = numerics.rsqrt(torch.from_numpy(x)).numpy()
    want = (1 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    xla = strict(lax.rsqrt, x)
    assert (np.abs(xla - got) <= np.spacing(got)).all()


# ---------------------------------------------------------------------------
# the scan's plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_scan_plain_versions_equal_jax_bit_for_bit(case):
    a, b, h0 = _scan_inputs(case, 0)
    ta, tb, th = (torch.from_numpy(x) for x in (a, b, h0))
    _bits_equal(rglru_scan_ref(ta, tb, th), strict(jax_scan_ref, a, b, h0),
                "associative scan")
    _bits_equal(rglru_scan_seq(ta, tb, th), strict(jax_scan_seq, a, b, h0),
                "sequential scan")


@pytest.mark.parametrize("case", list(PALLAS_TILES), ids=str)
def test_scan_plain_versions_match_the_pallas_kernel(case):
    """The TPU kernel in interpret mode is sequential with one rounding a
    step: equal to ``rglru_scan_seq`` bit for bit, to the associative scan
    within the kernel tests' bound."""
    a, b, h0 = _scan_inputs(case, 1)
    bt, bd = PALLAS_TILES[case]
    want = jax_rglru_pallas(a, b, h0, bt=bt, bd=bd, interpret=True)
    ta, tb, th = (torch.from_numpy(x) for x in (a, b, h0))
    _bits_equal(rglru_scan_seq(ta, tb, th), want, "seq vs pallas")
    np.testing.assert_allclose(_np(rglru_scan_ref(ta, tb, th)), _np(want),
                               atol=SCAN_ATOL, rtol=SCAN_RTOL)


def test_scan_op_takes_the_plain_version_on_the_cpu():
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs((2, 33, 40), 2))
    n0 = scan_ops.rglru_scan.launches
    _bits_equal(scan_ops.rglru_scan(a, b, h0), rglru_scan_ref(a, b, h0))
    assert scan_ops.rglru_scan.launches == n0  # no kernel on the CPU
    # one decode step is one fused multiply-add, as the JAX model's a h0 + b
    one = scan_ops.rglru_scan(a[:, :1], b[:, :1], h0)
    _bits_equal(one[:, 0], strict(lambda x, y, z: x * z + y, a[:, 0].numpy(),
                                  b[:, 0].numpy(), h0.numpy()), "decode step")


def test_scan_op_rejects_what_it_does_not_take():
    a = torch.zeros((2, 4, 8))
    h0 = torch.zeros((2, 8))
    with pytest.raises(TypeError, match="float32"):
        scan_ops.rglru_scan(a.double(), a.double(), h0.double())
    with pytest.raises(ValueError, match="expected"):
        scan_ops.rglru_scan(a, a, torch.zeros((2, 7)))
    with pytest.raises(ValueError, match="S must be"):
        scan_ops.rglru_scan(a[:, :0], a[:, :0], h0)
    with pytest.raises(ValueError, match="unsupported device"):
        m = a.to("meta")
        scan_ops.rglru_scan(m, m, h0.to("meta"))


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    cfg = jax_configs.get_smoke(ARCH)
    jp = jax_rec.init_rglru(cfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, configs.get_smoke(ARCH), jp, tp


def _bf16(x):
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_rglru_prefill_and_decode_equal_jax(block, seed):
    cfg, tcfg, jp, tp = block
    rng = np.random.default_rng(seed)
    jx, tx = _bf16(rng.standard_normal((2, 19, cfg.d_model)).astype(
        np.float32))
    f = Strict(lambda p, x, c: jax_rec.apply_rglru(cfg, p, x, c))
    wy, wc = f(jp, jx, None)
    gy, gc = rec.apply_rglru(tcfg, tp, tx)
    _bits_equal(gy, wy, "prefill y")
    for leaf in ("h", "conv"):
        _bits_equal(gc[leaf], wc[leaf], f"prefill {leaf}")
    for t in range(3):
        jx, tx = _bf16(rng.standard_normal((2, 1, cfg.d_model)).astype(
            np.float32))
        wy, wc = f(jp, jx, wc)
        gy, gc = rec.apply_rglru(tcfg, tp, tx, gc)
        _bits_equal(gy, wy, f"decode {t} y")
        for leaf in ("h", "conv"):
            _bits_equal(gc[leaf], wc[leaf], f"decode {t} {leaf}")


def test_rglru_gates_and_conv_equal_jax(block):
    cfg, _, jp, tp = block
    rng = np.random.default_rng(4)
    jx, tx = _bf16(rng.standard_normal((3, 9, cfg.rnn_width)).astype(
        np.float32))
    wa, wb = strict(lambda p, x: jax_rec._rglru_gates(p, x), jp, jx)
    ga, gb = rec._rglru_gates(tp, tx)
    _bits_equal(ga, wa, "a")
    _bits_equal(gb, wb, "b")
    state = rng.standard_normal((3, rec.CONV_WIDTH - 1, cfg.rnn_width))
    state = state.astype(np.float32)
    wy, ws = strict(lambda x, w, s: jax_rec._causal_conv(x, w, s), jx,
                    jp["conv"], state)
    gy, gs = rec._causal_conv(tx, tp["conv"], torch.from_numpy(state))
    _bits_equal(gy, wy, "conv y")
    _bits_equal(gs, ws, "conv state")


def test_init_rglru_layout_equals_jax(block):
    cfg, tcfg, jp, _ = block
    got = params_to_numpy(rec.init_rglru(tcfg, torch.Generator().manual_seed(
        0), lead=(2,)))
    want = jax.tree.map(np.asarray, jp)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == (2,) + w.shape and g.dtype == w.dtype, k
        if k == "lam":  # deterministic: equal, in every stacked layer
            np.testing.assert_array_equal(g[1], w)
            np.testing.assert_array_equal(g[0], w)
        elif k.startswith("b_"):
            assert not g.any()
        else:
            scale = 0.3 if k == "conv" else 1 / np.sqrt(w.shape[0])
            assert abs(g.std() / scale - 1) < 0.1, k
    cache = rec.init_rglru_cache(tcfg, 3, device="cpu")
    jc = jax_rec.init_rglru_cache(cfg, 3)
    for leaf in ("h", "conv"):
        assert tuple(cache[leaf].shape) == jc[leaf].shape
        assert cache[leaf].dtype == torch.float32 and not cache[leaf].any()


# ---------------------------------------------------------------------------
# recurrentgemma-2b SMOKE: the model and the engine
# ---------------------------------------------------------------------------

def _model(n_layers, attn_chunk, decode_budget):
    cfg = dataclasses.replace(jax_configs.get_smoke(ARCH), n_layers=n_layers)
    tcfg = dataclasses.replace(configs.get_smoke(ARCH), n_layers=n_layers)
    kw = dict(attn_chunk=attn_chunk, remat_policy="none",
              decode_budget=decode_budget)
    run, trun = jax_configs.RunConfig(**kw), configs.RunConfig(**kw)
    jp = jax_lm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, run, jp, tcfg, trun, tp


@pytest.fixture(scope="module", params=[3, 5], ids=["3_layers", "5_tail"])
def n_layers(request):
    return request.param


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         prefix + (k,))]
    return [(prefix, tree)]


def _assert_caches_equal(got, want, what):
    g, w = _leaves(got), _leaves(dict(want))
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == {"float32": torch.float32, "bfloat16":
                           torch.bfloat16, "int32": torch.int32}[
            str(b.dtype)], path
        _bits_equal(a, np.asarray(b).astype(np.float32) if b.dtype ==
                    jnp.int32 else b, f"{what} {'/'.join(path)}")


def _within_bf16_bound(got, want, what):
    g, w = _np(got), _np(want)
    assert np.isfinite(g).all(), what
    over = np.abs(g - w) > ATOL + RTOL * np.abs(w)
    assert not over.any(), f"{what}: {int(over.sum())} over the bf16 bound"


def _teacher_forced(m, toks, feed):
    """Prefill then one decode step per fed token, in both packages:
    [(port logits, JAX logits, port cache copy, JAX cache)] per step."""
    cfg, run, jp, tcfg, trun, tp = m
    jpre = Strict(lambda p, b: jax_lm.prefill(cfg, run, p, b))
    jdec = Strict(lambda p, c, t, pos: jax_lm.decode_step(cfg, run, p, c, t,
                                                          pos))
    wl, wc = jpre(jp, {"tokens": jnp.asarray(toks)})
    gl, gc = lm.prefill(tcfg, trun, tp,
                        {"tokens": torch.from_numpy(toks).long()})
    out = [(gl, wl, lm.tree_map(torch.clone, gc), wc)]
    for t in range(feed.shape[1]):
        pos = toks.shape[1] + t
        wl, wc = jdec(jp, wc, jnp.asarray(feed[:, t:t + 1]), jnp.int32(pos))
        gl, gc2 = lm.decode_step(tcfg, trun, tp, gc, torch.from_numpy(
            feed[:, t:t + 1]).long(), pos)
        assert gc2 is gc  # written in place
        out.append((gl, wl, lm.tree_map(torch.clone, gc), wc))
    return out


# (prompt length, attn_chunk, decode steps): shorter than the window with
# decode past the ring (w = 8, positions 8..19); longer than the window
# through the banded prefill (16 + 8 < 32); the query-chunked prefill whose
# band would not fit (16 + 8 = 24)
MODEL_CASES = [(8, 0, 12), (32, 8, 6), (24, 8, 4)]


@pytest.mark.parametrize("plen,chunk,steps", MODEL_CASES,
                         ids=["short_past_ring", "banded", "chunked"])
def test_prefill_and_decode_equal_strict_jax(n_layers, plen, chunk, steps):
    m = _model(n_layers, chunk, steps)
    rng = np.random.default_rng(plen + n_layers)
    toks = rng.integers(0, m[0].vocab, (2, plen)).astype(np.int32)
    feed = rng.integers(0, m[0].vocab, (2, steps)).astype(np.int32)
    for step, (gl, wl, gc, wc) in enumerate(_teacher_forced(m, toks, feed)):
        assert gl.dtype == torch.bfloat16
        _assert_caches_equal(gc, wc, f"step {step}")
        _within_bf16_bound(gl, wl, f"logits, step {step}")
        _near_tie_or_same_argmax(gl, wl, m[0].vocab, f"step {step}")


def test_prefill_head_over_all_rows_equals_jax():
    """The prefill logits take the head over all B * S rows, then the last
    position, as the JAX package does.  On this input (5 layers, B 2, a
    prompt of 8) the backbone equals JAX's bit for bit and only the head's
    order differed: the product over the last position alone rounds one
    logit's last bit otherwise."""
    cfg, run, jp, tcfg, trun, tp = _model(5, 8, 4)
    toks = np.random.default_rng(408).integers(0, cfg.vocab, (2, 8)).astype(
        np.int32)
    want, _ = Strict(lambda p, b: jax_lm.prefill(cfg, run, p, b))(
        jp, {"tokens": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks).long()}
    got, _ = lm.prefill(tcfg, trun, tp, batch)
    _bits_equal(got, want, "prefill logits")
    x, _, _ = lm._backbone(tcfg, trun, tp, batch, "prefill")
    last_only = layers.dot(x[:, -1], lm._head_weight(tcfg, tp))
    assert (_np(last_only) != _np(want)).any()


def _near_tie_or_same_argmax(got, want, vocab, what):
    g, w = _np(got)[:, :vocab], _np(want)[:, :vocab]
    for i in range(g.shape[0]):
        if g[i].argmax() != w[i].argmax():
            top2 = np.sort(w[i])[-2:]
            assert top2[1] - top2[0] <= 2 * (ATOL + RTOL * abs(top2[1])), (
                what, i)


def test_forward_train_equals_jax(n_layers):
    cfg, run, jp, tcfg, trun, tp = _model(n_layers, 8, 4)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 32)).astype(
        np.int32)
    want = strict(lambda p, b: jax_lm.forward(cfg, run, p, b)[0], jp,
                  {"tokens": jnp.asarray(toks)})
    got, aux, cache = lm.forward(tcfg, trun, tp,
                                 {"tokens": torch.from_numpy(toks).long()})
    assert cache is None and float(aux) == 0.0
    _bits_equal(got, want, "logits")  # the head on all B * S rows, as XLA


def _serve(m, prompts, new):
    cfg, run, jp, tcfg, trun, tp = m
    eng = JaxEngine(cfg, run, jp, max_batch=2)
    eng._prefill = Strict(lambda p, b: jax_lm.prefill(cfg, run, p, b))
    eng._decode = Strict(lambda p, c, t, pos: jax_lm.decode_step(
        cfg, run, p, c, t, pos))
    want = eng.generate([JaxRequest(p, max_new_tokens=new) for p in prompts])
    got = ServeEngine(tcfg, trun, tp, max_batch=2, device="cpu").generate(
        [Request(p, max_new_tokens=new) for p in prompts])
    return (np.stack([o.tokens for o in got]),
            np.stack([o.tokens for o in want]))


def test_serve_engine_equals_strict_jax_engine(n_layers):
    """tests/test_substrate.py:147's prompts (shorter than the window), and
    prompts longer than it; decode past the ring in both."""
    m = _model(n_layers, 8, 10)
    rng = np.random.default_rng(n_layers)
    for prompts in ([np.arange(8, dtype=np.int32),
                     np.arange(5, dtype=np.int32) + 3],
                    [rng.integers(0, 256, 27).astype(np.int32),
                     rng.integers(0, 256, 20).astype(np.int32)]):
        got, want = _serve(m, prompts, 10)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_params_and_cache_trees_equal_jax(n_layers):
    cfg, _, jp, tcfg, _, tp = _model(n_layers, 8, 4)
    tail = n_layers % len(cfg.block_pattern)
    assert ("tail" in jp) == bool(tail)
    want = jax.tree.map(np.asarray, jp)
    # carried across and back, leaf for leaf
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # drawn by the port: the same tree, shapes, dtypes; lam as JAX's
    got = params_to_numpy(lm.init_params(tcfg,
                                         torch.Generator().manual_seed(0)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path[-1].key == "lam":
            np.testing.assert_array_equal(a, b)
    for seq_len in (20, 8):  # ring of min(window 16, seq_len)
        jc = jax_lm.init_decode_cache(cfg, 3, seq_len)
        tc = lm.init_decode_cache(tcfg, 3, seq_len, device="cpu")
        _assert_caches_equal(tc, jc, f"empty cache {seq_len}")


def test_decode_state_is_written_into_the_stacked_cache():
    """Every leaf of every block, tiles and tail, moves on a decode step:
    the RG-LRU state is copied back, the ring written in place."""
    cfg, run, jp, tcfg, trun, tp = _model(5, 8, 4)
    toks = torch.arange(12).reshape(2, 6) % cfg.vocab
    _, cache = lm.prefill(tcfg, trun, tp, {"tokens": toks})
    before = lm.tree_map(torch.clone, cache)
    _, after = lm.decode_step(tcfg, trun, tp, cache, toks[:, :1], 6)
    for (path, a), (_, b) in zip(_leaves(after), _leaves(before)):
        assert not torch.equal(a, b), path


def test_prefill_ring_layout():
    """Position t lives in slot t % w, w = min(window, S); slot_pos holds
    the positions (-1 for none)."""
    cfg, run, jp, tcfg, trun, tp = _model(3, 8, 4)
    for S, w in ((8, 8), (21, 16)):
        toks = torch.zeros((1, S), dtype=torch.long)
        _, cache = lm.prefill(tcfg, trun, tp, {"tokens": toks})
        sp = cache["tiles"]["b2"]["slot_pos"][0]
        want = torch.full((w,), -1, dtype=torch.int32)
        for t in range(max(0, S - w), S):
            want[t % w] = t
        assert torch.equal(sp, want)
        assert cache["tiles"]["b2"]["k"].shape[2] == w


def test_ring_sized_by_the_prompt_drops_a_live_position_as_jax_does():
    """A fault of the reference, kept by the port: prefill sizes the ring
    at min(window, S), so decode at pos = S < window overwrites position 0,
    which is still inside the window.  SMOKE (window 16), a prompt of 8,
    one decode step: the port's logits equal JAX's, and both differ from
    true local attention (the full forward over the 9 tokens)."""
    cfg, run, jp, tcfg, trun, tp = _model(3, 0, 4)
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 9)).astype(
        np.int32)
    assert cfg.window > 8
    _, (gl, wl, _, _) = _teacher_forced((cfg, run, jp, tcfg, trun, tp),
                                        toks[:, :8], toks[:, 8:])
    _within_bf16_bound(gl, wl, "decode logits vs JAX")
    true = strict(lambda p, b: jax_lm.forward(cfg, run, p, b)[0][:, -1], jp,
                  {"tokens": jnp.asarray(toks)})
    err = np.abs(_np(gl) - _np(true))
    assert (err > ATOL + RTOL * np.abs(_np(true))).any(), \
        "the ring kept position 0"
