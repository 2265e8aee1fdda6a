"""The port's mixture of experts against the JAX package's, on the CPU.

qwen2-moe-a2.7b ``SMOKE`` (2 layers, d_model 64, 6 experts, top 2, 2
shared) and dbrx-132b ``SMOKE`` (4 experts, top 2, no shared) with the
JAX package's ``init_params(PRNGKey(0))`` weights carried across.  Against
JAX compiled with ``xla_allow_excess_precision`` off the port is equal
bit for bit — prefill logits, teacher-forced decode logits and every
cache leaf — at the default capacity (tokens dropped), uncapped
(``tests/test_arch_smoke.py:35-38``'s capacity factor of E) and with
either expert branch (``RunConfig.moe_expert_scan``); the auxiliary loss
is held to the f32 bound (``tests/test_kernels.py:26``, 2e-5).  A router
input whose probabilities tie pins the order among equals (the lower
expert id first, as ``lax.top_k``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro_torch.models import lm, moe

from _lm_parity import (ATOL, RTOL, Model, Strict,
                        assert_init_layout_equals_jax,
                        assert_prefill_and_decode_equal,
                        assert_serve_matches_default_jax_outside_near_ties,
                        assert_within_bf16_bound_of_default_jax, np32,
                        serve_jax, serve_port)

ARCH = "qwen2-moe-a2.7b"
F32_TOL = 2e-5  # tests/test_kernels.py:26
VARIANTS = {
    "capped": {},
    "uncapped": {"moe": {"capacity_factor": 6.0}},   # E: nothing drops
    "batched": {"moe_expert_scan": False},
}


@pytest.fixture(scope="module")
def models():
    return {}


def _model(models, name):
    if name not in models:
        models[name] = Model.build(ARCH, **VARIANTS[name])
    return models[name]


class DropCount:
    """Counts the slots past capacity of every routing in a run."""

    def __init__(self, monkeypatch):
        self.n, self.route = 0, moe.route
        monkeypatch.setattr(moe, "route", self)

    def __call__(self, *a):
        r = self.route(*a)
        self.n += moe.drops(r)
        return r


class RouteTies:
    """Records, for every routing in a run, which rows route a token at a
    near-tie: the k-th and (k+1)-th router logits within twice the
    elementwise bf16 bound, where the default JAX build, which keeps
    intermediates in f32, may pick the other expert.  A route call is one
    layer of one step (prefill, then each decode step)."""

    def __init__(self, monkeypatch, n_layers: int):
        self.rows, self.route, self.L = [], moe.route, n_layers
        monkeypatch.setattr(moe, "route", self)

    def __call__(self, cfg, *a):
        r = self.route(cfg, *a)
        k = cfg.moe.top_k
        lg = torch.sort(r.logits, -1, descending=True).values
        hi, lo = lg[..., k - 1], lg[..., k]
        tie = (hi - lo <= 2 * (ATOL + RTOL * hi.abs())).any(-1)
        self.rows.append(tie.numpy())
        return r

    def at_or_before(self, step: int, row=None) -> bool:
        """A near-tie in ``row`` (any row) at this step or an earlier one
        (an earlier one changes the cache the step reads)."""
        ties = np.stack(self.rows[:(step + 1) * self.L])
        return bool(ties.any() if row is None else ties[:, row].any())


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_and_decode_equal_jax_bit_for_bit(models, name,
                                                  monkeypatch):
    m = _model(models, name)
    drops = DropCount(monkeypatch)
    assert_prefill_and_decode_equal(m)
    # at 16 tokens the default capacity (7 a row) drops slots
    assert (drops.n > 0) == (name != "uncapped")


@pytest.mark.parametrize("name", ["capped", "batched"])
def test_forward_logits_and_aux_equal_jax(models, name):
    """train mode: logits bit for bit, the aux (load balance + z-loss,
    summed over the blocks) within the f32 bound and not zero."""
    m = _model(models, name)
    jb, tb = m.batches(3, 2, 16)
    jl, jaux, _ = Strict(lambda p, b: jax_lm.forward(m.cfg, m.run, p, b))(
        m.jp, jb)
    tl, taux, cache = lm.forward(m.tcfg, m.trun, m.tp, tb)
    assert cache is None and taux.dtype == torch.float32
    np.testing.assert_array_equal(np32(tl), np32(jl))
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=F32_TOL,
                               atol=F32_TOL)


def test_tied_router_keeps_the_lower_expert_first(models):
    """Router columns 1 and 4 equal, 2 and 3 equal: every row's
    probabilities tie; top-k, the dispatch and the output follow JAX's
    order (the lower id first) bit for bit."""
    m = _model(models, "capped")
    p = jax.tree.map(np.asarray, m.jp["tiles"]["b0"]["moe"])
    p = jax.tree.map(lambda a: a[0], p)
    router = p["router"].copy()
    router[:, 4] = router[:, 1]
    router[:, 3] = router[:, 2]
    p["router"] = router
    x = np.random.default_rng(4).standard_normal((2, 16, 64)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tp = jax.tree.map(torch.from_numpy, p)
    r = moe.route(m.tcfg, tp, tx)
    probs = r.probs.numpy()
    assert np.array_equal(probs[..., 1], probs[..., 4])
    assert np.array_equal(probs[..., 2], probs[..., 3])
    _, want_e = jax.lax.top_k(jnp.asarray(probs), m.cfg.moe.top_k)
    np.testing.assert_array_equal(r.top_e.numpy(), np.asarray(want_e))
    assert ((r.top_e.numpy() == 1) | (r.top_e.numpy() == 2)).any()
    assert not (r.top_e.numpy() == 4).all()
    jp = jax.tree.map(jnp.asarray, p)
    wy, waux = Strict(lambda p_, x_: jax_moe.apply_moe(m.cfg, p_, x_))(jp, jx)
    ty, taux = moe.apply_moe(m.tcfg, tp, tx)
    np.testing.assert_array_equal(np32(ty), np32(wy))
    np.testing.assert_allclose(float(taux), float(waux), rtol=F32_TOL,
                               atol=F32_TOL)


def test_routing_never_mixes_rows(models):
    """A row routed alone is routed as in the batch (no sort, rank or
    capacity crosses rows)."""
    m = _model(models, "capped")
    tp = lm.tree_map(lambda a: a[0], m.tp["tiles"]["b0"]["moe"])
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 16, 64)).astype(np.float32)).to(torch.bfloat16)
    y, _ = moe.apply_moe(m.tcfg, tp, x)
    for i in range(3):
        yi, _ = moe.apply_moe(m.tcfg, tp, x[i:i + 1])
        assert torch.equal(yi[0], y[i])


def test_capacity_equals_jax():
    from repro_torch import configs
    e = configs.get_config(ARCH).moe
    for seq in (1, 16, 64, 512, 1000):
        assert moe.capacity(e, seq) == jax_moe.capacity(e, seq)
    assert moe.capacity(e, 512) == 43 and moe.capacity(e, 1) == 1


def test_dbrx_prefill_equals_jax_bit_for_bit():
    assert_prefill_and_decode_equal(Model.build("dbrx-132b"), steps=1)


def test_serve_engine_equals_strict_jax_engine(models):
    m = _model(models, "capped")
    np.testing.assert_array_equal(serve_port(m), serve_jax(m, strict=True))


def test_serve_engine_matches_jax_engine_outside_near_ties(models,
                                                           monkeypatch):
    """Against JAX's default build: logits within the bf16 bound and
    tokens equal, but where a token or a routing was at a near-tie (a
    routing flip counts as a token flip does)."""
    m = _model(models, "capped")
    ties = RouteTies(monkeypatch, m.cfg.n_layers)
    assert_within_bf16_bound_of_default_jax(m, excused=ties.at_or_before)
    ties.rows.clear()
    assert_serve_matches_default_jax_outside_near_ties(
        m, excused=ties.at_or_before)


def test_init_params_layout_equals_jax(models):
    """moe/router, w1-w3 stacked (n_tiles, E, ...), moe/shared: the JAX
    tree, shapes and dtypes; the weights carry across."""
    m = _model(models, "capped")
    assert_init_layout_equals_jax(m)
    assert m.tp["tiles"]["b0"]["moe"]["w1"].shape == (2, 6, 64, 64)
    assert m.tp["tiles"]["b0"]["moe"]["shared"]["w1"].shape == (2, 64, 128)
