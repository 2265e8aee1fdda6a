"""The port's training loss and gradients against the JAX package's, on
the CPU.

Every entry of ``ARCHS`` at its ``SMOKE`` config, numpy-seeded weights
(``chip_smoke.numpy_params``) given to both packages
(``repro_torch.models.interop``), one ``TokenStream`` batch (2 sequences
of 16 positions, the prefix or encoder frames its config asks for):

* ``lm.loss_fn``'s loss and metrics within 1e-6 relative of JAX's,
  compiled with ``xla_allow_excess_precision`` off (the port's forward is
  that build's bit for bit; the log-sum-exp and the final sums are
  PyTorch's, a few ulps);
* every parameter leaf's gradient within relative L2 2e-2 of
  ``jax.grad`` (the bf16 bound, ``tests/test_kernels.py:26-27``), but a
  leaf whose JAX gradient is below 1e-6 of the whole gradient's norm —
  float noise: the sLSTM's input-gate bias ``bi``, on which the loss does
  not depend (the max-stabiliser absorbs any shift of the input gate) —
  whose port gradient must be that small too;
* every floating leaf gets a gradient, finite and not all zero (the XLA
  arithmetic of ``repro_torch.numerics`` is differentiable).

recurrentgemma-2b, xlstm-350m and seamless-m4t-medium, whose JAX
gradients take longest to compile, are held in
``tests/test_torch_train_families.py``.

The MoE's auxiliary loss under autograd through both expert forms, and
the numerics forwards' bits with and without autograd, are held too.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs.base import ShapeConfig as JaxShape
from repro.data.pipeline import TokenStream as JaxStream
from repro.models import lm as jax_lm
from repro_torch import configs, numerics
from repro_torch.models import layers, lm, recurrent
from repro_torch.models.interop import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train.step import grads_and_metrics, make_train_step

from _lm_parity import Strict

_spec = importlib.util.spec_from_file_location(
    "_chip_smoke_train", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

# the three slowest to compile in JAX run in test_torch_train_families.py
FAMILIES = ("recurrentgemma-2b", "xlstm-350m", "seamless-m4t-medium")
LOSS_RTOL = 1e-6
GRAD_RTOL = 2e-2   # tests/test_kernels.py:26-27, bf16
NOISE = 1e-6       # a leaf's share of the gradient norm that is float noise
RUN = dict(attn_chunk=8, mlstm_chunk=4, remat_policy="none", z_loss=1e-4)
SHAPE = JaxShape("t", 16, 2, "train")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: its tests are many small
    CPU operations, and the suite runs several processes side by side,
    whose thread pools would oversubscribe the cores (6 processes of 8
    threads ran test_training_loss_decreases 15x slower than of one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(arch, **run_kw):
    """(JAX cfg, run, params, batch), (port cfg, run, params, batch)."""
    cfg, tcfg = jax_configs.get_smoke(arch), configs.get_smoke(arch)
    kw = {**RUN, **run_kw}
    weights = SMOKE.numpy_params(arch, 0)
    jp = jax.tree.map(jnp.asarray, weights)
    tp = params_from_numpy(weights, device="cpu")
    b = JaxStream(cfg, SHAPE).batch_at(0)
    return ((cfg, jax_configs.RunConfig(**kw), jp,
             {k: jnp.asarray(v) for k, v in b.items()}),
            (tcfg, configs.RunConfig(**kw), tp,
             {k: torch.from_numpy(v) for k, v in b.items()}))


def port_build(arch, **run_kw):
    """The port's (cfg, run, params from a seeded generator, batch)."""
    tcfg = configs.get_smoke(arch)
    tp = lm.init_params(tcfg, torch.Generator().manual_seed(0))
    b = JaxStream(jax_configs.get_smoke(arch), SHAPE).batch_at(0)
    return (tcfg, configs.RunConfig(**{**RUN, **run_kw}), tp,
            {k: torch.from_numpy(v) for k, v in b.items()})


def port_loss_and_grads(tcfg, trun, tp, tb):
    for t in lm.tree_leaves(tp):
        t.requires_grad_(True)
    loss, metrics = lm.loss_fn(tcfg, trun, tp, tb)
    loss.backward()
    return loss, metrics


def named_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from named_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def assert_loss_and_grads_match_jax(arch):
    """``make_train_step``'s gradient (``grads_and_metrics``) and metrics
    against ``jax.value_and_grad`` of ``repro.models.lm.loss_fn``; then one
    whole step."""
    (cfg, run, jp, jb), (tcfg, trun, tp, tb) = build(arch)
    (jl, jm), jg = Strict(jax.value_and_grad(
        lambda p, b: jax_lm.loss_fn(cfg, run, p, b), has_aux=True))(jp, jb)
    grads, metrics = grads_and_metrics(tcfg, trun, tp, tb)
    for k in ("ce", "z_loss", "aux", "loss"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]),
                                                  rel=LOSS_RTOL, abs=1e-12), k
    want = {tuple(p.key for p in path): np.asarray(g) for path, g in
            jax.tree_util.tree_leaves_with_path(jg)}
    got = dict(named_leaves(grads))
    assert sorted(want) == sorted(got)
    total = np.sqrt(sum(float(np.sum(np.square(g))) for g in want.values()))
    for key, w in want.items():
        g = got[key].numpy()
        err, norm = np.linalg.norm(g - w), np.linalg.norm(w)
        if norm <= NOISE * total:
            assert np.linalg.norm(g) <= NOISE * total, (key, norm)
        else:
            assert err <= GRAD_RTOL * norm, (key, err / norm)
    state = {"params": tp, "opt": adamw.init_opt_state(tp)}
    state, m = make_train_step(tcfg, trun)(state, tb)
    assert float(m["loss"]) == float(metrics["loss"])
    assert int(state["opt"]["step"]) == 1
    assert all(torch.isfinite(t).all() for t in lm.tree_leaves(tp))


@pytest.mark.parametrize("arch", [a for a in jax_configs.ARCHS
                                  if a not in FAMILIES])
def test_loss_and_grads_match_jax(arch):
    assert_loss_and_grads_match_jax(arch)


@pytest.mark.parametrize("arch", jax_configs.ARCHS)
def test_every_leaf_gets_a_gradient(arch):
    """Fails where a bit trick cuts the graph (the RG-LRU's gates and scan,
    the xLSTM's mLSTM and sLSTM before ``numerics`` was differentiable)."""
    tcfg, trun, tp, tb = port_build(arch)
    port_loss_and_grads(tcfg, trun, tp, tb)
    for key, t in named_leaves(tp):
        if not t.is_floating_point():
            continue
        assert t.grad is not None, key
        assert torch.isfinite(t.grad).all(), key
        assert bool((t.grad != 0).any()), key


def test_moe_aux_loss_flows_to_the_router():
    """The aux loss (load balance + router z-loss) alone gives the router
    a gradient, the same under both expert forms (its value is held to
    JAX's by test_loss_and_grads_match_jax)."""
    grads = []
    for expert_scan in (True, False):
        tcfg, trun, tp, tb = port_build("qwen2-moe-a2.7b",
                                        moe_expert_scan=expert_scan)
        router = tp["tiles"]["b0"]["moe"]["router"].requires_grad_(True)
        _, metrics = lm.loss_fn(tcfg, trun, tp, tb)
        grads += torch.autograd.grad(metrics["aux"], [router])
    assert bool((grads[0] != 0).any())
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-2b",
                                  "xlstm-350m", "seamless-m4t-medium"])
def test_loss_calls_no_kernel_wrapper(arch, monkeypatch):
    """The loss runs the plain forms (the XLA route) on every device: the
    kernel wrappers of attention, the RG-LRU scan and the mLSTM are never
    called, so no kernel output can reach a gradient."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called by the loss")

    for mod, name in ((layers, "flash_attention"),
                      (layers, "decode_attention"),
                      (recurrent, "rglru_scan"), (recurrent, "mlstm_chunk")):
        monkeypatch.setattr(mod, name, refuse)
    tcfg, trun, tp, tb = port_build(arch, remat_policy="nothing")
    port_loss_and_grads(tcfg, trun, tp, tb)


def test_numerics_forward_bits_unchanged_under_autograd():
    """Every XLA-exact function gives the same bits with its input
    requiring grad as without, and a gradient of the right shape."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    fns = {
        "exp": lambda a: numerics.exp(a),
        "exp_bf16": lambda a: numerics.exp(a.bfloat16()),
        "log1p": lambda a: numerics.log1p(a.abs()),
        "tanh": lambda a: numerics.tanh(a),
        "sqrt": lambda a: numerics.sqrt(a.abs()),
        "rsqrt": lambda a: numerics.rsqrt(a.abs() + 1),
        "softplus": lambda a: numerics.softplus(a),
        "fma": lambda a: numerics.fma(a, y, 0.5),
        "muladd": lambda a: numerics.muladd(y, a, a),
        "mean_sq": lambda a: numerics.mean_sq(a),
        "sum_product": lambda a: numerics.sum_product(a, y, 1),
        "sum_product_short": lambda a: numerics.sum_product(a[:, :9], y[:, :9],
                                                            1),
        "einsum": lambda a: numerics.einsum("bd,ed->be", a, y),
        "cumsum": lambda a: numerics.cumsum(a, 1),
    }
    for name, f in fns.items():
        want = f(x)
        xg = x.clone().requires_grad_(True)
        got = f(xg)
        assert torch.equal(got.detach().float(), want.float()), name
        (g,) = torch.autograd.grad(got.float().sum(), [xg])
        assert g.shape == x.shape and torch.isfinite(g).all(), name


def test_numerics_vjps_are_jax_rules():
    """The backward of each function against JAX's own VJP on the same
    input (f32 bound, tests/test_kernels.py:26)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 40)).astype(np.float32)
    cases = {
        "exp": (jnp.exp, numerics.exp),
        "tanh": (jnp.tanh, numerics.tanh),
        "softplus": (jax.nn.softplus, numerics.softplus),
        "log1p": (lambda a: jnp.log1p(jnp.abs(a)),
                  lambda a: numerics.log1p(a.abs())),
        "rsqrt": (lambda a: jax.lax.rsqrt(jnp.abs(a) + 1),
                  lambda a: numerics.rsqrt(a.abs() + 1)),
        "sqrt": (lambda a: jnp.sqrt(jnp.abs(a) + 1),
                 lambda a: numerics.sqrt(a.abs() + 1)),
        "mean_sq": (lambda a: jnp.mean(a * a, -1, keepdims=True),
                    numerics.mean_sq),
        "cumsum": (lambda a: jnp.cumsum(a, 1),
                   lambda a: numerics.cumsum(a, 1)),
    }
    for name, (jf, tf) in cases.items():
        out, vjp = jax.vjp(jf, x)
        (want,) = vjp(np.asarray(out) * 0 + x[:, :out.shape[1]])
        xg = torch.from_numpy(x).requires_grad_(True)
        got = tf(xg)
        (g,) = torch.autograd.grad(got, [xg],
                                   torch.from_numpy(x[:, :got.shape[1]]))
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
