"""The port's LM serving path against the JAX package's, on the CPU.

qwen3-1.7b ``SMOKE`` (2 layers, d_model 64, GQA 4:2, head dim 16, qk_norm,
tied embeddings) with the JAX package's ``init_params(PRNGKey(0))``
weights carried across.  The port rounds to bf16 where the JAX functions
prescribe it, so it equals JAX compiled with ``xla_allow_excess_precision``
off bit for bit: prefill logits, teacher-forced decode logits and every
cache leaf.  JAX's default build may keep bf16 intermediates in f32 and
differs in the last bits; against it the logits are held to the bf16
bound's relative tolerance in norm (2e-2, per step) and the served tokens
must be equal wherever the JAX logits' top-2 margin exceeds twice the
elementwise bf16 bound (2e-2 + 2e-2 * |logit|), the most that two logits
each within the bound can swap by.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import lm as jax_lm
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import configs
from repro_torch.models import layers, lm
from repro_torch.models.interop import params_from_numpy, params_to_numpy
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "qwen3-1.7b"
STRICT = {"xla_allow_excess_precision": False}
ATOL = RTOL = 2e-2  # tests/test_kernels.py:27, bf16
PROMPTS = [np.arange(8, dtype=np.int32),  # tests/test_substrate.py:147
           np.arange(5, dtype=np.int32) + 3]


@pytest.fixture(scope="module")
def model():
    cfg = jax_configs.get_smoke(ARCH)
    run = jax_configs.RunConfig(attn_chunk=8, remat_policy="none",
                                decode_budget=8)
    jp = jax_lm.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = configs.get_smoke(ARCH)
    trun = configs.RunConfig(attn_chunk=8, remat_policy="none",
                             decode_budget=8)
    return cfg, run, jp, tcfg, trun, tp


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
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _run_jax(model, fn_prefill, fn_decode, toks, feed):
    cfg, run, jp = model[:3]
    logits, cache = fn_prefill(jp, {"tokens": jnp.asarray(toks)})
    out, caches = [logits], [cache]
    for t in range(feed.shape[1]):
        logits, cache = fn_decode(jp, cache, jnp.asarray(feed[:, t:t + 1]),
                                  jnp.int32(toks.shape[1] + t))
        out.append(logits)
        caches.append(cache)
    return out, caches


def _run_port(model, toks, feed):
    tcfg, trun, tp = model[3:]
    logits, cache = lm.prefill(tcfg, trun, tp,
                               {"tokens": torch.from_numpy(toks).long()})
    out, caches = [logits], [lm.tree_map(torch.clone, cache)]
    for t in range(feed.shape[1]):
        logits, cache = lm.decode_step(
            tcfg, trun, tp, cache, torch.from_numpy(feed[:, t:t + 1]).long(),
            toks.shape[1] + t)
        out.append(logits)
        caches.append(lm.tree_map(torch.clone, cache))
    return out, caches


@pytest.mark.parametrize("seed,batch,plen", [(0, 2, 16), (1, 3, 11)])
def test_prefill_and_decode_equal_jax_bit_for_bit(model, seed, batch, plen):
    """Prefill (query-chunked at 16, one shot at 11), then six decode steps
    teacher-forced with the same tokens: logits and caches equal."""
    cfg, run = model[:2]
    toks = _tokens(seed, (batch, plen), cfg.vocab)
    feed = _tokens(seed + 10, (batch, 6), cfg.vocab)
    want, wcaches = _run_jax(
        model, Strict(lambda p, b: jax_lm.prefill(cfg, run, p, b)),
        Strict(lambda p, c, t, pos: jax_lm.decode_step(cfg, run, p, c, t,
                                                       pos)), toks, feed)
    got, gcaches = _run_port(model, toks, feed)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"step {step}")
    for step, (g, w) in enumerate(zip(gcaches, wcaches)):
        for leaf in ("k", "v"):
            np.testing.assert_array_equal(
                _np(g["tiles"]["b0"][leaf]), _np(w["tiles"]["b0"][leaf]),
                err_msg=f"cache {leaf} after step {step}")


def test_prefill_and_decode_within_bf16_bound_of_default_jax(model):
    """Against JAX as its engine compiles it (excess precision allowed)."""
    cfg, run = model[:2]
    toks = _tokens(2, (2, 16), cfg.vocab)
    feed = _tokens(12, (2, 6), cfg.vocab)
    want, _ = _run_jax(
        model, jax.jit(lambda p, b: jax_lm.prefill(cfg, run, p, b)),
        jax.jit(lambda p, c, t, pos: jax_lm.decode_step(cfg, run, p, c, t,
                                                        pos)), toks, feed)
    got, _ = _run_port(model, toks, feed)
    for step, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        assert np.isfinite(g).all()
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= RTOL, f"step {step}: relative L2 {rel}"


def test_forward_train_equals_jax_bit_for_bit(model):
    cfg, run, jp, tcfg, trun, tp = model
    toks = _tokens(3, (2, 16), cfg.vocab)
    want = Strict(lambda p, b: jax_lm.forward(cfg, run, p, b)[0])(
        jp, {"tokens": jnp.asarray(toks)})
    got, aux, cache = lm.forward(tcfg, trun, tp,
                                 {"tokens": torch.from_numpy(toks).long()})
    assert cache is None and float(aux) == 0.0
    np.testing.assert_array_equal(_np(got), _np(want))


def _serve_jax(model, strict: bool):
    cfg, run, jp = model[:3]
    eng = JaxEngine(cfg, run, jp, max_batch=2)
    if strict:
        eng._prefill = Strict(lambda p, b: jax_lm.prefill(cfg, run, p, b))
        eng._decode = Strict(lambda p, c, t, pos: jax_lm.decode_step(
            cfg, run, p, c, t, pos))
    outs = eng.generate([JaxRequest(p, max_new_tokens=4) for p in PROMPTS])
    return np.stack([o.tokens for o in outs])


def _serve_port(model):
    tcfg, trun, tp = model[3:]
    eng = ServeEngine(tcfg, trun, tp, max_batch=2, device="cpu")
    outs = eng.generate([Request(p, max_new_tokens=4) for p in PROMPTS])
    assert all(o.tokens.dtype == np.int32 for o in outs)
    return np.stack([o.tokens for o in outs])


def test_serve_engine_equals_strict_jax_engine(model):
    """tests/test_substrate.py:147's prompts (left-padded, unmasked
    padding), max_batch 2, 4 new tokens: the same tokens."""
    np.testing.assert_array_equal(_serve_port(model),
                                  _serve_jax(model, strict=True))


def test_serve_engine_matches_jax_engine_outside_near_ties(model):
    cfg, run, jp = model[:3]
    got, want = _serve_port(model), _serve_jax(model, strict=False)
    # the JAX engine's logits along its own tokens, teacher-forced
    toks = np.zeros((2, 8), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, 8 - len(p):] = p
    logits, _ = _run_jax(
        model, jax.jit(lambda p, b: jax_lm.prefill(cfg, run, p, b)),
        jax.jit(lambda p, c, t, pos: jax_lm.decode_step(cfg, run, p, c, t,
                                                        pos)), toks, want)
    for i in range(2):
        for t in range(4):
            lg = _np(logits[t])[i, :cfg.vocab]
            top2 = np.sort(lg)[-2:]
            if got[i, t] != want[i, t]:
                margin = top2[1] - top2[0]
                assert margin <= 2 * (ATOL + RTOL * abs(top2[1])), (i, t)
                break  # the histories differ from here on


def test_serve_engine_behaviour(model):
    tcfg, trun, tp = model[3:]
    eng = ServeEngine(tcfg, trun, tp, max_batch=2, device="cpu")
    with pytest.raises(AssertionError, match="decode budget"):
        eng.generate([Request(PROMPTS[0], max_new_tokens=9)])
    toks, plen = eng._pad_batch([Request(p) for p in PROMPTS])
    assert plen == 8 and toks[1, :3].tolist() == [0, 0, 0]  # left-padded
    a = eng.generate([Request(p, max_new_tokens=4) for p in PROMPTS])
    b = eng.generate([Request(p, max_new_tokens=4) for p in PROMPTS])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
    with pytest.raises(ValueError, match="engine runs on"):
        ServeEngine(tcfg, trun, tp, device="meta")


def test_entry_points_default_to_the_card(model):
    tcfg, trun, tp = model[3:]
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tcfg, trun, tp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_decode_cache(tcfg, 1, 4)


def test_params_carry_across(model):
    cfg, _, jp, tcfg, _, tp = model
    want = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_init_params_and_cache_layout_equal_jax(model):
    """Same tree, shapes and dtypes as JAX's; norms ones; weights drawn
    with the JAX scales (std 1/sqrt(fan_in), embedding 1/sqrt(d))."""
    cfg, _, jp, tcfg = model[:4]
    tp = lm.init_params(tcfg, torch.Generator().manual_seed(0))
    want = jax.tree.map(np.asarray, jp)
    got = params_to_numpy(tp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for path, a in jax.tree_util.tree_leaves_with_path(got):
        b = want
        for k in path:
            b = b[k.key]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        name = path[-1].key
        if "norm" in name or name.startswith("ln"):
            np.testing.assert_array_equal(a, np.ones_like(a))
        else:
            fan_in = cfg.d_model if name == "tok" else a.shape[-2]
            assert abs(a.std() * np.sqrt(fan_in) - 1) < 0.1, path
    jc = jax_lm.init_decode_cache(cfg, 3, 20)
    tc = lm.init_decode_cache(tcfg, 3, 20, device="cpu")
    for leaf in ("k", "v"):
        t, j = tc["tiles"]["b0"][leaf], jc["tiles"]["b0"][leaf]
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
        assert not t.any()


def test_configs_equal_jax():
    assert configs.ARCHS == jax_configs.ARCHS
    for arch in jax_configs.ARCHS:
        for get in ("get_config", "get_smoke"):
            a = getattr(configs, get)(arch)
            b = getattr(jax_configs, get)(arch)
            assert dataclasses.asdict(a) == dataclasses.asdict(b), (arch, get)
            assert (a.hd, a.padded_vocab, a.rnn_width, a.sub_quadratic,
                    a.n_params(), a.n_active_params(), a.layer_kinds()) == (
                b.hd, b.padded_vocab, b.rnn_width, b.sub_quadratic,
                b.n_params(), b.n_active_params(), b.layer_kinds())
        assert ([s.name for s in configs.applicable_shapes(
            configs.get_config(arch))] == [s.name for s in
                                           jax_configs.applicable_shapes(
                                               jax_configs.get_config(arch))])
    assert [dataclasses.asdict(s) for s in configs.LM_SHAPES] == [
        dataclasses.asdict(s) for s in jax_configs.LM_SHAPES]
    assert dataclasses.asdict(configs.RunConfig()) == dataclasses.asdict(
        jax_configs.RunConfig())


NOT_PORTED = {
    "moe": dict(moe=jax_configs.MoeConfig(n_experts=4, top_k=2,
                                          d_ff_expert=32)),
    "encdec": dict(kind="encdec", enc_layers=2, frontend="audio"),
    "frontend": dict(frontend="patch"),
}


@pytest.mark.parametrize("name", list(NOT_PORTED))
def test_not_ported_features_raise(model, name):
    """The features the port once raised on (experts, the encoder-decoder,
    a frontend) now run: qwen3-1.7b SMOKE with each added initialises, is
    served, and its prefill equals strict JAX's bit for bit."""
    jcfg = dataclasses.replace(model[0], **NOT_PORTED[name])
    cfg = dataclasses.replace(model[3], **NOT_PORTED[name])
    trun = model[4]
    lm.init_params(cfg, torch.Generator().manual_seed(0))
    jp = jax_lm.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    outs = ServeEngine(cfg, trun, tp, device="cpu").generate(
        [Request(p, max_new_tokens=2) for p in PROMPTS])
    assert [len(o.tokens) for o in outs] == [2, 2]
    toks = _tokens(7, (2, 8), cfg.vocab)
    jb, tb = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.from_numpy(toks).long()}
    if name != "moe":
        e = np.random.default_rng(8).standard_normal((2, 2, cfg.d_model))
        key = "enc_emb" if name == "encdec" else "prefix_emb"
        jb[key] = jnp.asarray(e, jnp.float32)
        tb[key] = torch.from_numpy(e.astype(np.float32))
    want, _ = Strict(lambda p, b: jax_lm.prefill(jcfg, model[1], p, b))(
        jp, jb)
    got, _ = lm.prefill(cfg, trun, tp, tb)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_every_config_outside_the_slice_raises():
    """No config raises any more: every config the JAX package defines
    initialises and runs one SMOKE prefill on the CPU, finite logits of
    the padded vocabulary."""
    run = configs.RunConfig(attn_chunk=8, decode_budget=2)
    for arch in configs.ARCHS:
        cfg = configs.get_smoke(arch)
        params = lm.init_params(cfg, torch.Generator().manual_seed(0))
        batch = {"tokens": torch.arange(8).reshape(1, 8) % cfg.vocab}
        if cfg.kind == "encdec":
            batch["enc_emb"] = torch.ones((1, 2, cfg.d_model))
        elif cfg.frontend is not None:
            batch["prefix_emb"] = torch.ones((1, 2, cfg.d_model))
        logits, cache = lm.prefill(cfg, run, params, batch)
        assert logits.shape == (1, cfg.padded_vocab), arch
        assert torch.isfinite(logits.float()).all(), arch
        assert cache["tiles"], arch
    assert not hasattr(lm, "check_ported")


def test_layers_primitives_equal_jax():
    """rms_norm, rope, silu and gelu in bf16 from the same inputs: bit for
    bit."""
    from repro.models import layers as jl
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    for name, j, t in (
            ("rms_norm", jl.rms_norm(jx, jnp.asarray(w)),
             layers.rms_norm(tx, torch.from_numpy(w))),
            ("rope", jl.apply_rope(jx, jnp.asarray(pos), 1e6),
             layers.apply_rope(tx, torch.from_numpy(pos), 1e6)),
            ("silu", jax.nn.silu(jx), layers.silu(tx)),
            ("gelu", jl.gelu(jx), layers.gelu(tx))):
        np.testing.assert_array_equal(_np(t), _np(j), err_msg=name)
