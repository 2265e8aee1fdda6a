"""The port's modality-frontend decoder and encoder-decoder against the
JAX package's, on the CPU.

llava-next-34b ``SMOKE`` (2 layers, d_model 64, GQA 4:2, a ``patch``
frontend: ``prefix_emb`` projected by ``frontend_proj`` before the tokens,
cut before the final norm) and seamless-m4t-medium ``SMOKE`` (2 encoder
and 2 decoder layers, an ``audio`` frontend into the encoder, a
cross-attention in each decoder block whose K/V of the encoder output
sit in the cache as ``xk``/``xv``), with the JAX package's
``init_params(PRNGKey(0))`` weights carried across.  Against JAX
compiled with ``xla_allow_excess_precision`` off: prefill logits,
teacher-forced decode logits and every cache leaf bit for bit, and
``forward``'s logits; against JAX's default build the bf16 bound and the
served tokens equal outside near-ties; ``init_decode_cache`` and
``init_params`` have the JAX layout.
"""
import numpy as np
import pytest
import torch

from repro.models import lm as jax_lm
from repro_torch.models import lm
from repro_torch.serve.engine import model_input

from _lm_parity import (Model, Strict, assert_init_layout_equals_jax,
                        assert_prefill_and_decode_equal,
                        assert_serve_matches_default_jax_outside_near_ties,
                        assert_within_bf16_bound_of_default_jax,
                        leaves_with_paths, np32, serve_jax, serve_port)

ARCHS = ["llava-next-34b", "seamless-m4t-medium"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return Model.build(request.param)


@pytest.mark.parametrize("seed,batch,plen", [(0, 2, 16), (1, 3, 11)])
def test_prefill_and_decode_equal_jax_bit_for_bit(model, seed, batch, plen):
    """Prefill (query-chunked at 16, one shot at 11), then four decode
    steps teacher-forced: logits and every cache leaf."""
    assert_prefill_and_decode_equal(model, seed, batch, plen)


def test_forward_train_equals_jax_bit_for_bit(model):
    m = model
    jb, tb = m.batches(3, 2, 16, extra=5)
    want = Strict(lambda p, b: jax_lm.forward(m.cfg, m.run, p, b)[0])(
        m.jp, jb)
    got, aux, cache = lm.forward(m.tcfg, m.trun, m.tp, tb)
    assert cache is None and float(aux) == 0.0
    assert got.shape[1] == 16  # the prefix's positions are cut
    np.testing.assert_array_equal(np32(got), np32(want))


def test_serve_engine_equals_strict_jax_engine(model):
    """tests/test_substrate.py:147's prompts, max_batch 2, 4 new tokens:
    the zero prefix (or encoder input) of max(8 // div, 1) positions and
    the decode positions past it, as the JAX engine's."""
    np.testing.assert_array_equal(serve_port(model),
                                  serve_jax(model, strict=True))


def test_serve_engine_matches_jax_engine_outside_near_ties(model):
    assert_within_bf16_bound_of_default_jax(model)
    assert_serve_matches_default_jax_outside_near_ties(model)


def test_engine_batch_has_the_prefix_or_the_encoder_input(model):
    m = model
    toks = torch.zeros((2, 12), dtype=torch.long)
    batch, npfx = model_input(m.tcfg, toks, 12)
    key = "enc_emb" if m.cfg.kind == "encdec" else "prefix_emb"
    assert tuple(batch[key].shape) == (2, 12 // m.cfg.frontend_len_div, 64)
    assert not batch[key].any() and batch[key].dtype == torch.float32
    assert npfx == (0 if m.cfg.kind == "encdec" else 3)
    _, npfx = model_input(m.tcfg, toks[:, :2], 2)  # at least one position
    assert npfx == (0 if m.cfg.kind == "encdec" else 1)


def test_init_params_and_decode_cache_layout_equal_jax(model):
    """frontend_proj; enc_tiles, enc_norm, ln_x and xattn (no qkv bias)
    for the encoder-decoder: the JAX tree, shapes and dtypes, the weights
    carried across; the decode cache's leaves (xk/xv of seq_len // div
    positions) as JAX's, all zero."""
    m = model
    assert_init_layout_equals_jax(m)
    assert "frontend_proj" in m.tp
    assert ("enc_tiles" in m.tp) == (m.cfg.kind == "encdec")
    want = leaves_with_paths(jax_lm.init_decode_cache(m.cfg, 3, 20))
    got = dict(leaves_with_paths(lm.tree_map(
        lambda t: t.float(), lm.init_decode_cache(m.tcfg, 3, 20,
                                                  device="cpu"))))
    assert sorted(got) == sorted(p for p, _ in want)
    for path, x in want:
        assert got[path].shape == x.shape and not got[path].any(), path
    if m.cfg.kind == "encdec":
        assert got["['tiles']['b0']['xk']"].shape == (2, 3, 5, 4, 16)
        assert "bq" not in m.tp["tiles"]["b0"]["xattn"]


def test_decode_leaves_the_cross_attention_cache_alone():
    """The encoder-decoder's decode step reads ``xk``/``xv`` and writes
    only the self-attention rows; the cache it returns is the one passed
    in."""
    m = Model.build("seamless-m4t-medium")
    _, tb = m.batches(6, 2, 8)
    _, cache = lm.prefill(m.tcfg, m.trun, m.tp, tb)
    xk = cache["tiles"]["b0"]["xk"].clone()
    k = cache["tiles"]["b0"]["k"].clone()
    _, out = lm.decode_step(m.tcfg, m.trun, m.tp, cache,
                            torch.zeros((2, 1), dtype=torch.long), 8)
    assert out is cache
    assert torch.equal(cache["tiles"]["b0"]["xk"], xk)
    assert not torch.equal(cache["tiles"]["b0"]["k"], k)
    assert torch.equal(cache["tiles"]["b0"]["k"][:, :, :8], k[:, :, :8])

