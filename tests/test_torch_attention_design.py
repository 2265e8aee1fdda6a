"""The arithmetic of the redesigned attention kernels, on the CPU, in
their plain versions (the kernels run only on the card:
``tests/test_torch_cuda.py``, ``chip_smoke.py``).

* Flash attention in bf16 runs on the tensor cores: the same function as
  the TPU kernel but for one extra rounding, P rounded to bf16 before P V
  (the denominator sums P unrounded).  ``attention_tc_ref`` computes that;
  it is held to the plain version (``attention_ref``) and to the JAX
  Pallas kernel in interpret mode within the bf16 bound
  (``tests/test_kernels.py:27``: atol and rtol 2e-2) at every head dim the
  kernel takes, causal, windowed and with rows that have no live key.
* Flash-decode splits the cache into ``split_count`` slices and merges
  their partials (max, denominator, unnormalised output) in slice order.
  ``decode_split_ref`` computes that; it is held to the plain version
  within the f32 bound (2e-5) for every split layout the chooser gives,
  kv_len 0 (every position masked) and past Skv included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp_compat import given, settings, st
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      decode_split_ref)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_tc_ref)

BF16 = dict(atol=2e-2, rtol=2e-2)  # tests/test_kernels.py:27
F32 = dict(atol=2e-5, rtol=2e-5)


def _bf16(rng, shape):
    """Seeded N(0, 1) values as bf16 torch and JAX arrays (the same
    values: both round to nearest even)."""
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).bfloat16(), jnp.asarray(a).astype(jnp.bfloat16)


# (Sq, Skv, causal, window): causal; windowed; bidirectional with Sq != Skv;
# a window whose rows past Skv - 1 + window have no live key
FLASH_FORMS = [(128, 128, True, 0), (192, 192, True, 48),
               (96, 160, False, 0), (120, 64, True, 16)]


@pytest.mark.parametrize("form", FLASH_FORMS, ids=str)
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
def test_bf16_probabilities_stay_within_the_bf16_bound(hd, form):
    """(B 1, 4 query heads to 2 kv heads.)"""
    Sq, Skv, causal, window = form
    rng = np.random.default_rng(hd + Sq)
    (q, jq), (k, jk), (v, jv) = (_bf16(rng, s) for s in (
        (1, Sq, 4, hd), (1, Skv, 2, hd), (1, Skv, 2, hd)))

    def heads(x):  # (B, S, H, hd) -> (B * H, S, hd), the kernel's layout
        return x.transpose(1, 2).reshape(-1, x.shape[1], hd)

    got = attention_tc_ref(heads(q), heads(k), heads(v), causal=causal,
                           window=window)
    want = attention_ref(heads(q), heads(k), heads(v), causal=causal,
                         window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **BF16)
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window, bq=Sq,
                       bk=Skv, interpret=True)
    pallas = np.asarray(pallas, np.float32).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.float().numpy(),
                               pallas.reshape(-1, Sq, hd), **BF16)


def _decode_inputs(seed, bh, G, Skv, hd):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((bh, G, hd), (bh, Skv, hd), (bh, Skv, hd)))


# (B * Hkv, G, Skv, kv_len, hd): the qwen3-1.7b decode shape (5 splits),
# one split, many, kv_len 0 and past Skv under several splits
DECODE_LAYOUTS = [(64, 2, 576, 529, 128), (264, 2, 512, 500, 16),
                  (2, 4, 4096, 4000, 16), (1, 4, 2048, 0, 16),
                  (8, 2, 1024, 5000, 64), (1, 16, 999, 998, 16)]


@pytest.mark.parametrize("layout", DECODE_LAYOUTS, ids=str)
def test_split_and_merge_equal_the_plain_decode(layout):
    bh, G, Skv, kv_len, hd = layout
    q, k, v = _decode_inputs(sum(layout), bh, G, Skv, hd)
    nsplit = dops.split_count(Skv, kv_len, bh)
    got = decode_split_ref(q, k, v, kv_len, nsplit)
    want = decode_attention_ref(q, k, v, kv_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


@settings(max_examples=40, deadline=None)
@given(Skv=st.integers(1, 3000), kv_len=st.integers(-2, 3200),
       bh=st.integers(1, 300))
def test_every_split_layout_of_the_chooser_equals_the_plain_decode(
        Skv, kv_len, bh):
    """Any cache length, kv_len (<= 0: every position masked; past Skv)
    and batch x kv heads: the chooser's split count covers the card twice
    where each split keeps at least 64 positions, and the split-and-merge
    equals the plain version."""
    nsplit = dops.split_count(Skv, kv_len, bh)
    n = min(kv_len, Skv) if kv_len >= 1 else Skv
    assert 1 <= nsplit <= max(1, n // dops.MIN_SPLIT)
    if nsplit > 1:
        assert n // nsplit >= dops.MIN_SPLIT
        assert bh * (nsplit - 1) < 2 * dops.H100_SMS
    assert bh * nsplit >= 2 * dops.H100_SMS or nsplit == max(
        1, n // dops.MIN_SPLIT)
    rows = min(bh, 2)  # the rows are independent: two stand for all
    q, k, v = _decode_inputs(Skv + kv_len + bh, rows, 2, Skv, 16)
    got = decode_split_ref(q, k, v, kv_len, nsplit)
    want = decode_attention_ref(q, k, v, kv_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
