"""The arithmetic of the mLSTM's CUDA kernels, on the CPU, in their plain
versions (the kernels run only on the card: ``tests/test_torch_cuda.py``,
``chip_smoke.py``).

* Prefill runs two kernels: a scores pass (the gated scores once a chunk
  of 64, their row sums, the decays and the chunk's share of n) and a
  state-and-output pass over the chunks, every product on the tensor
  cores, every f32 operand (the state C, the scores, g v) split into
  three bf16 parts.  ``mlstm_tc_ref`` computes that;
  it is held to the JAX model's ``mlstm_scan_chunked`` (from the same
  nonzero state) and to the
  Pallas kernel in interpret mode (``tests/test_kernels.py:149-163``, from
  the zero state) within the kernel tests' bound (atol 3e-4 / rtol 3e-3),
  at head dims 32 to 512, with tail chunks, and with the state carried
  across two calls.
* Decode (S = 1) is a step in place: ``mlstm_decode_ref`` overwrites the
  state it is given (n, then C) and is held to the same references from a
  nonzero state; the op's ``out=`` writes the caller's tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.ops import mlstm as jax_mlstm_pallas
from repro.models import recurrent as jax_rec
from repro_torch.kernels.mlstm_chunk import ops as mops
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_ref,
                                                 mlstm_decode_ref,
                                                 mlstm_scores_ref, mlstm_seq,
                                                 mlstm_tc_ref, split_bf16)

TOL = dict(atol=3e-4, rtol=3e-3)  # tests/test_kernels.py:165-166
K = 64  # the kernels' chunk
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _jax_in_f32():
    """The references are the JAX package's f32 functions: keep x64 off
    while this module runs (another test file's imports may turn it on)."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", was)


def _inputs(B, S, H, dh, seed, state=True):
    """bf16-valued q/k/v (B, S, H, dh) as f32 numpy, log f = log sigmoid
    of N(0, 2^2), log i ~ N(0, 1) (as tests/test_kernels.py draws them),
    and a state N(0, 0.1^2) (or zero)."""
    rng = np.random.default_rng(seed)
    q, k, v = (np.asarray(T(rng.standard_normal((B, S, H, dh)).astype(
        np.float32)).bfloat16().float()) for _ in range(3))
    log_f = -np.log1p(np.exp(-2 * rng.standard_normal((B, S, H))))
    log_i = rng.standard_normal((B, S, H))
    scale = 0.1 if state else 0.0
    C0 = scale * rng.standard_normal((B, H, dh, dh))
    n0 = scale * rng.standard_normal((B, H, dh))
    return tuple(x.astype(np.float32) for x in (q, k, v, log_f, log_i, C0,
                                                n0))


def _torch(q, k, v, log_f, log_i, C0, n0):
    return (*(T(x).bfloat16() for x in (q, k, v)),
            *(T(x) for x in (log_f, log_i, C0, n0)))


def _jax_chunked(q, k, v, log_f, log_i, C0, n0, chunk=K):
    """The JAX model's chunkwise mLSTM from the state: (h, C, n) numpy."""
    out = jax_rec.mlstm_scan_chunked(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(log_f), jnp.asarray(log_i), jnp.asarray(C0),
        jnp.asarray(n0), chunk=chunk)
    return [np.asarray(x) for x in out]


def _pallas(q, k, v, log_f, log_i):
    """The TPU kernel in interpret mode from the zero state, (B, S, H, dh)
    in and out; S is padded to a multiple of K as the model pads its tail
    (q, k, v 0, log f 0, log i -1e30: the rows before it do not move)."""
    B, S, H, dh = q.shape
    pad = -S % K

    def heads(x, fill=0.0):
        x = np.moveaxis(x, 2, 1).reshape((B * H, S) + x.shape[3:])
        widths = [(0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 2)
        return np.pad(x, widths, constant_values=fill)

    h = jax_mlstm_pallas(heads(q), heads(k), heads(v), heads(log_f),
                         heads(log_i, -1e30), K=K, interpret=True)
    h = np.asarray(h)[:, :S].reshape(B, H, S, dh)
    return np.moveaxis(h, 1, 2)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _spread(seed):
    """f32 values over twelve decades, both signs."""
    rng = np.random.default_rng(seed)
    return T((rng.standard_normal(4096) * 10.0 ** rng.integers(
        -6, 6, 4096)).astype(np.float32))


def test_split_keeps_sixteen_bits():
    """hi + lo carries x to 2^-16 of its size (16 of 24 mantissa bits):
    the split the kernels' operands outgrew (three parts, below)."""
    x = _spread(0)
    hi, lo = split_bf16(x, 2)
    assert torch.equal(hi, hi.bfloat16().float())
    assert torch.equal(lo, lo.bfloat16().float())
    assert ((hi + lo - x).abs() <= 2.0 ** -16 * x.abs()).all()


def test_split_in_three_is_exact():
    """The kernels' three parts: each a bf16 value, their sum x exactly
    (8 + 8 + 8 mantissa bits; each difference is exact in f32)."""
    x = _spread(1)
    parts = split_bf16(x, 3)
    for p in parts:
        assert torch.equal(p, p.bfloat16().float())
    assert torch.equal((parts[0] + parts[1]) + parts[2], x)


# (B, S, H, dh): head dims 32 to 512 (on and off the state pass's
# 64-column blocks), tail chunks (100, 70, 130), one chunk, several
PREFILL = [(2, 100, 2, 32), (2, 70, 2, 64), (1, 130, 2, 96),
           (2, 128, 1, 128), (1, 70, 1, 512)]


@pytest.mark.parametrize("case", PREFILL, ids=str)
def test_prefill_passes_match_jax_and_the_pallas_kernel(case):
    """Both passes with the bf16 splits: from a nonzero state against the
    JAX model's chunked form (h, C, n); from the zero state against the
    Pallas kernel (h)."""
    B, S, H, dh = case
    x = _inputs(B, S, H, dh, sum(case))
    got = mlstm_tc_ref(*_torch(*x))
    for g, w in zip(got, _jax_chunked(*x)):
        _close(g, w)
    zero = x[:5] + (0 * x[5], 0 * x[6])
    h, _, _ = mlstm_tc_ref(*_torch(*zero))
    _close(h, _pallas(*x[:5]))


def test_scores_pass_masks_the_future_and_the_tail():
    """The scores pass: nothing above the diagonal or past S, the row sums
    those of the scores its three parts add up to, and u the g-weighted
    sum of the chunk's keys."""
    B, S, H, dh = 1, 100, 2, 64
    q, k, _, log_f, log_i, _, _ = _torch(*_inputs(B, S, H, dh, 3))
    sc = mlstm_scores_ref(q, k, log_f, log_i)
    hi, mid, lo = sc["s_parts"]
    s = (hi + mid) + lo
    assert s.shape == (B, H, 2, K, K)
    upper = ~torch.tril(torch.ones((K, K), dtype=torch.bool))
    assert (s[..., upper] == 0).all()
    assert (s[:, :, 1, S - K:] == 0).all()          # rows past S
    assert (sc["g"][:, :, 1, S - K:] == 0).all()    # no input past S
    np.testing.assert_allclose(s.sum(-1).numpy(), sc["rowsum"].numpy(),
                               rtol=1e-4, atol=1e-5)
    kf = k.float().transpose(1, 2)
    u0 = (sc["g"][:, :, 0, :, None] * kf[:, :, :K]).sum(-2)
    np.testing.assert_allclose(sc["u"][:, :, 0].numpy(), u0.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dh", [32, 128, 512])
def test_decode_in_place_from_a_nonzero_state(dh):
    """One step from a nonzero state, written into it: against the JAX
    model's chunked form at chunk 1 (its decode) and the sequential
    recurrence; after a prefill from zero (both passes), the step's h
    against the Pallas kernel's last row over the whole sequence."""
    B, S, H = 2, 1, 2
    x = _inputs(B, S, H, dh, dh)
    q, k, v, log_f, log_i, C0, n0 = _torch(*x)
    C, n = C0.clone(), n0.clone()
    ptrs = C.data_ptr(), n.data_ptr()
    h = mlstm_decode_ref(q, k, v, log_f, log_i, C, n)
    assert (C.data_ptr(), n.data_ptr()) == ptrs
    for g, w in zip((h, C, n), _jax_chunked(*x, chunk=1)):
        _close(g, w)
    for g, w in zip((h, C, n), mlstm_seq(q, k, v, log_f, log_i, C0, n0)):
        _close(g, w)
    # prefill 69 positions from zero, then the 70th as a decode step
    x = _inputs(B, 70, H, dh, dh + 1, state=False)
    q, k, v, log_f, log_i, C0, n0 = _torch(*x)
    _, C, n = mlstm_tc_ref(q[:, :69], k[:, :69], v[:, :69], log_f[:, :69],
                           log_i[:, :69], C0, n0)
    h = mlstm_decode_ref(q[:, 69:], k[:, 69:], v[:, 69:], log_f[:, 69:],
                         log_i[:, 69:], C, n)
    _close(h, _pallas(*x[:5])[:, 69:])


def test_state_carries_across_two_calls():
    """Prefill in two calls with (C, n) handed across, then a decode step
    in place: against the JAX model over the whole sequence from the same
    nonzero state (h of every position, the final C and n), and h against
    the Pallas kernel from zero."""
    B, S, H, dh = 2, 150, 2, 64
    x = _inputs(B, S, H, dh, 11)
    q, k, v, log_f, log_i, C0, n0 = _torch(*x)
    cut, last = 90, S - 1

    def part(a, b, C, n):
        return mlstm_tc_ref(q[:, a:b], k[:, a:b], v[:, a:b], log_f[:, a:b],
                            log_i[:, a:b], C, n)

    h1, C, n = part(0, cut, C0, n0)
    h2, C, n = part(cut, last, C, n)
    h3 = mlstm_decode_ref(q[:, last:], k[:, last:], v[:, last:],
                          log_f[:, last:], log_i[:, last:], C, n)
    h = torch.cat([h1, h2, h3], 1)
    hw, Cw, nw = _jax_chunked(*x)
    for g, w in ((h, hw), (C, Cw), (n, nw)):
        _close(g, w)
    zero = (C0 * 0, n0 * 0)
    h1, C, n = part(0, cut, *zero)
    h2, C, n = part(cut, last, C, n)
    h3 = mlstm_decode_ref(q[:, last:], k[:, last:], v[:, last:],
                          log_f[:, last:], log_i[:, last:], C, n)
    _close(torch.cat([h1, h2, h3], 1), _pallas(*x[:5]))


def test_op_writes_out_and_keeps_the_jax_form_on_the_cpu():
    """``out=(C, n)``: the op returns the caller's tensors holding what it
    returns without ``out`` (the JAX form on the CPU), bit for bit; at
    S = 1 they may be the state itself; at S > 1 they may not overlap it,
    nor may either tensor overlap the other state tensor."""
    args = list(_torch(*_inputs(2, 1, 2, 32, 5)))
    fresh = mops.mlstm_chunk(*args, chunk=1)
    C, n = args[5].clone(), args[6].clone()
    got = mops.mlstm_chunk(*args[:5], C, n, chunk=1, out=(C, n))
    assert got[1] is C and got[2] is n
    assert all(map(torch.equal, got, fresh))
    assert all(map(torch.equal, fresh, mlstm_chunk_ref(*args, 1)))
    pre = list(_torch(*_inputs(2, 9, 2, 32, 6)))
    with pytest.raises(ValueError, match="in place"):
        mops.mlstm_chunk(*pre, out=(pre[5], pre[6]))
    with pytest.raises(ValueError, match="overlaps"):
        mops.mlstm_chunk(*args, chunk=1,
                         out=(args[5], args[5].view(-1)[:args[6].numel()]
                              .view(args[6].shape)))
    with pytest.raises(ValueError, match="expected"):
        mops.mlstm_chunk(*args, chunk=1, out=(args[5],))
    C, n = torch.empty_like(pre[5]), torch.empty_like(pre[6])
    got = mops.mlstm_chunk(*pre, out=(C, n))
    want = mlstm_chunk_ref(*pre, K)
    assert got[1] is C and all(map(torch.equal, got, want))
