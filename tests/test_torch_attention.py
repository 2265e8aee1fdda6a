"""The port's attention against the JAX package's, on the CPU.

Each CUDA kernel's plain version (the CPU route of its wrapper) is held to
the JAX Pallas kernel run in interpret mode, as ``tests/test_kernels.py``
runs it, on the same numpy inputs; the port's model attention
(``layers.attention`` on CPU tensors) to the JAX ``layers.attention``.
Tolerances are ``tests/test_kernels.py``'s: f32 2e-5, bf16 2e-2 (atol and
rtol), and its 1e-4 for the kernel against the model's chunked form.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models import layers as jax_layers
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import layers

TOLS = {"float32": dict(atol=2e-5, rtol=2e-5),
        "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shapes, dtype, seed):
    """The same seeded values as JAX arrays and torch tensors (bf16 rounds
    to nearest even in both)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, dtype, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(tol or TOLS[dtype]))


# (B, Sq, Skv, Hq, Hkv, hd, causal, window, bq, bk): tests/test_kernels.py's
# cases at its tile 64, then ragged lengths the JAX kernel takes as one tile
FLASH_CASES = [
    (2, 128, 128, 4, 4, 64, True, 0, 64, 64),      # MHA causal
    (1, 256, 256, 8, 2, 64, True, 0, 64, 64),      # GQA 4:1
    (2, 128, 128, 4, 1, 128, True, 0, 64, 64),     # MQA
    (1, 256, 256, 4, 4, 64, False, 0, 64, 64),     # bidirectional
    (1, 256, 256, 4, 2, 64, True, 64, 64, 64),     # local window
    (1, 512, 512, 2, 2, 128, True, 128, 64, 64),   # longer + window
    (2, 100, 100, 4, 2, 32, True, 0, 100, 100),    # ragged
    (1, 77, 120, 4, 2, 16, False, 0, 77, 120),     # ragged, Sq != Skv
    (1, 60, 40, 2, 1, 16, True, 8, 60, 40),        # rows past Skv-1+window
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_plain_matches_jax_kernel(case, dtype):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, bq, bk = case
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)], dtype, 0)
    want = jax_flash(jq, jk, jv, causal=causal, window=window, bq=bq, bk=bk,
                     interpret=True)
    n0 = fops.flash_attention.launches
    got = fops.flash_attention(q, k, v, causal=causal, window=window)
    assert fops.flash_attention.launches == n0  # no kernel on the CPU
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("bq,bk", [(32, 32), (64, 128), (128, 64)])
def test_flash_plain_matches_jax_block_shapes(bq, bk):
    (jq, jk, jv), (q, k, v) = _inputs(
        [(1, 256, 4, 64), (1, 256, 2, 64), (1, 256, 2, 64)], "float32", 1)
    want = jax_flash(jq, jk, jv, causal=True, bq=bq, bk=bk, interpret=True)
    _close(fops.flash_attention(q, k, v, causal=True), want, "float32")


def test_flash_plain_matches_model_attention():
    """As tests/test_kernels.py:67: the kernel's function agrees with the
    model's chunked attention (1e-4), here both in the port."""
    _, (q, k, v) = _inputs(
        [(2, 256, 8, 64), (2, 256, 2, 64), (2, 256, 2, 64)], "float32", 2)
    got = fops.flash_attention(q, k, v, causal=True)
    want = layers.attention(q, k, v, causal=True, chunk=64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


# (B, Skv, Hq, Hkv, hd, kv_len, bk): tests/test_kernels.py's cases at its
# tile 128, then kv_len off the tile, 0 and past the cache (one tile)
DECODE_CASES = [
    (2, 512, 8, 2, 64, 512, 128),
    (2, 512, 8, 2, 64, 300, 128),   # masked tail
    (1, 1024, 4, 1, 128, 1000, 128),
    (4, 256, 4, 4, 64, 256, 128),
    (3, 200, 8, 2, 32, 77, 200),    # ragged cache, kv_len off the tile
    (1, 64, 4, 2, 16, 0, 64),       # every position masked
    (1, 64, 4, 2, 16, 100, 64),     # kv_len past the cache
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_plain_matches_jax_kernel(case, dtype):
    B, Skv, Hq, Hkv, hd, kv_len, bk = case
    (jq, jk, jv), (q, k, v) = _inputs(
        [(B, 1, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)], dtype, 3)
    want = jax_decode(jq, jk, jv, jnp.int32(kv_len), bk=bk, interpret=True)
    n0 = dops.decode_attention.launches
    got = dops.decode_attention(q, k, v, kv_len)
    assert dops.decode_attention.launches == n0  # no kernel on the CPU
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype)


def test_decode_plain_matches_full_attention_last_row():
    """As tests/test_kernels.py:103: decode of token t equals row t of full
    causal attention."""
    _, (q, k, v) = _inputs(
        [(1, 256, 8, 64), (1, 256, 2, 64), (1, 256, 2, 64)], "float32", 4)
    full = fops.flash_attention(q, k, v, causal=True)
    got = dops.decode_attention(q[:, -1:], k, v, 256)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-5, rtol=2e-5)


# the model attention's forms: (Sq, Skv, causal, window, chunk, kv_len)
MODEL_FORMS = [
    (32, 32, True, 0, 0, None),     # one shot
    (32, 32, True, 0, 8, None),     # query chunks
    (32, 32, True, 4, 8, None),     # window band (window + chunk < Skv)
    (32, 32, True, 24, 8, None),    # window without the band
    (24, 24, False, 0, 8, None),    # bidirectional, chunked
    (1, 40, False, 0, 0, 29),       # decode against a cache
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", MODEL_FORMS, ids=str)
def test_model_attention_matches_jax(form, dtype):
    Sq, Skv, causal, window, chunk, kv_len = form
    (jq, jk, jv), (q, k, v) = _inputs(
        [(2, Sq, 4, 16), (2, Skv, 2, 16), (2, Skv, 2, 16)], dtype, 5)
    want = jax_layers.attention(jq, jk, jv, causal=causal, window=window,
                                chunk=chunk, kv_len=kv_len)
    got = layers.attention(q, k, v, causal=causal, window=window,
                           chunk=chunk, kv_len=kv_len)
    assert got.dtype == q.dtype
    _close(got, want, dtype)


def test_wrappers_check_their_operands():
    q = torch.zeros((1, 4, 4, 16))
    with pytest.raises(ValueError, match="kv heads"):
        fops.flash_attention(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(TypeError):
        fops.flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="one query position"):
        dops.decode_attention(q, q, q, 3)
    with pytest.raises(TypeError):
        dops.decode_attention(q[:, :1], q, q, 2.5)
