"""The port's train step variants and fault-tolerant loop on the CPU, run as
``tests/test_opt_variants.py`` and ``tests/test_fault_tolerance.py`` run
the JAX package's.

* ``attn_chunk_remat`` and the remat policies (``none``, ``nothing``,
  ``dots``, ``full``) change memory, never a bit: loss and every
  gradient equal the plain step's; ``loss_chunk`` (with a remainder
  chunk) gives the same loss bit for bit and gradients within relative L2
  2e-2 (the head's bf16 products are summed a chunk at a time);
  ``microbatch`` within 1e-3 (loss) and 2e-2 / 2e-3 (parameters after a
  step) of the whole batch, ``param_wire_bf16`` within 2e-2 (loss) of
  f32 — the JAX tests' bounds; ``attn_impl="pallas"`` raises.
* ``run_training``: a crash at step 7 then auto-resume equals the
  uninterrupted run bit for bit; the loss decreases, also under
  ``int8_ef``; a checkpoint the JAX package's loop wrote at step 5 resumes
  in the port, whose losses to step 10 are within 2e-2 relative of
  JAX's own 10 steps.
* ``python -m repro_torch.launch.train --device cpu``.
"""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs.base import RunConfig as JaxRun
from repro.configs.base import ShapeConfig as JaxShape
from repro.train import loop as jax_loop
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.loop import InjectedFailure, run_training
from repro_torch.train.step import (grads_and_metrics, init_train_state,
                                    make_serve_steps, make_train_step)

BASE = dict(attn_chunk=8, mlstm_chunk=4, remat_policy="none", z_loss=1e-4)
SHAPE = ShapeConfig("t", 32, 4, "train")
LOOP_CFG = "qwen3-1.7b"
LOOP_SHAPE = (32, 4)
JAX_RTOL = 2e-2  # bf16 bound, tests/test_kernels.py:26-27


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


def batch_for(cfg, shape=SHAPE):
    return {k: torch.from_numpy(v)
            for k, v in TokenStream(cfg, shape).batch_at(0).items()}


def state_for(cfg, run, seed=0):
    return init_train_state(cfg, run, torch.Generator().manual_seed(seed))


def loss_and_grads(cfg, run, params, batch):
    grads, metrics = grads_and_metrics(cfg, run, params, batch)
    return float(metrics["loss"]), tree_leaves(grads)


def assert_same_loss_and_grads(cfg, run_a, run_b, arch, shape=SHAPE,
                               grad_rtol=0.0):
    params = state_for(cfg, run_a)["params"]
    batch = batch_for(cfg, shape)
    la, ga = loss_and_grads(cfg, run_a, params, batch)
    lb, gb = loss_and_grads(cfg, run_b, params, batch)
    assert la == lb, arch
    for a, b in zip(ga, gb):
        if grad_rtol:
            assert float((a - b).norm()) <= grad_rtol * float(a.norm()), arch
        else:
            assert torch.equal(a, b), arch


# -- step variants ---------------------------------------------------------------

def test_loss_chunk_matches_unchunked():
    cfg = get_smoke("qwen3-1.7b")   # 31 targets: 3 chunks of 8 and 7 more
    assert_same_loss_and_grads(cfg, RunConfig(**BASE, loss_chunk=0),
                               RunConfig(**BASE, loss_chunk=8), "qwen3",
                               grad_rtol=JAX_RTOL)


def test_attn_chunk_remat_matches():
    cfg = get_smoke("gemma-7b")
    assert_same_loss_and_grads(cfg, RunConfig(**BASE),
                               RunConfig(**BASE, attn_chunk_remat=True),
                               "gemma")


ALL_POLICIES = ("nothing", "dots", "full")


@pytest.mark.parametrize("arch,policies", [
    ("qwen3-1.7b", ALL_POLICIES), ("recurrentgemma-2b", ALL_POLICIES),
    ("qwen2-moe-a2.7b", ALL_POLICIES),
    # the sLSTM's thousands of small operations make the selective
    # policy's per-operation dispatch slow on the CPU: "dots" is held on
    # the three above ("full" keeps everything, as "none" does)
    ("xlstm-350m", ("nothing",))])
def test_remat_policies_bit_identical(arch, policies):
    cfg = get_smoke(arch)
    plain = RunConfig(**BASE)
    for policy in policies:
        assert_same_loss_and_grads(
            cfg, plain, RunConfig(**{**BASE, "remat_policy": policy}),
            f"{arch} {policy}", shape=ShapeConfig("t", 16, 2, "train"))


def test_microbatch_matches_full_batch():
    cfg = get_smoke("qwen3-1.7b")
    batch = batch_for(cfg)
    run1 = RunConfig(**BASE, microbatch=1)
    run2 = RunConfig(**BASE, microbatch=2)
    s1, m1 = make_train_step(cfg, run1)(state_for(cfg, run1), batch)
    s2, m2 = make_train_step(cfg, run2)(state_for(cfg, run2), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3,
                                   rtol=2e-2)


def test_param_wire_bf16_close_to_f32():
    cfg = get_smoke("qwen3-4b")
    batch = batch_for(cfg)
    run0 = RunConfig(**BASE)
    runb = RunConfig(**BASE, param_wire_bf16=True)
    _, m0 = make_train_step(cfg, run0)(state_for(cfg, run0), batch)
    _, mb = make_train_step(cfg, runb)(state_for(cfg, runb), batch)
    assert float(m0["loss"]) == pytest.approx(float(mb["loss"]), rel=2e-2)


def test_pallas_route_raises_in_a_train_step():
    cfg = get_smoke("qwen3-1.7b")
    with pytest.raises(ValueError, match="backward"):
        make_train_step(cfg, RunConfig(**BASE, attn_impl="pallas"))


def test_serve_steps_are_the_model_entry_points():
    cfg = get_smoke("qwen3-1.7b")
    run = RunConfig(**BASE, decode_budget=4)
    params = state_for(cfg, run)["params"]
    prefill, decode = make_serve_steps(cfg, run)
    toks = batch_for(cfg)["tokens"][:2, :8].long()
    logits, cache = prefill(params, {"tokens": toks})
    want, _ = lm.prefill(cfg, run, params, {"tokens": toks})
    assert torch.equal(logits, want)
    nxt, _ = decode(params, cache, logits.argmax(-1)[:, None], 8)
    assert nxt.shape == logits.shape


# -- the fault-tolerant loop -------------------------------------------------------

def run_cfg(tmp, cls=RunConfig, **kw):
    base = dict(attn_chunk=8, remat_policy="none", warmup_steps=2,
                total_steps=30, learning_rate=3e-3, ckpt_every=5,
                ckpt_dir=str(tmp), z_loss=0.0)
    base.update(kw)
    return cls(**base)


def train(tmp, steps, **kw):
    run_kw = {k: kw.pop(k) for k in list(kw) if k not in (
        "seed", "fail_at_step")}
    return run_training(get_smoke(LOOP_CFG), run_cfg(tmp, **run_kw),
                        ShapeConfig("tiny", *LOOP_SHAPE, "train"),
                        steps=steps, device="cpu", **kw)


def test_crash_resume_bit_exact(tmp_path):
    a = train(tmp_path / "a", 12, seed=11, ckpt_every=4)
    with pytest.raises(InjectedFailure):
        train(tmp_path / "b", 12, seed=11, ckpt_every=4, fail_at_step=7)
    b = train(tmp_path / "b", 12, seed=11, ckpt_every=4)
    assert b.resumed_from == 4
    assert b.losses == a.losses[4:]
    for x, y in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_training_loss_decreases(tmp_path, compression):
    res = train(tmp_path, 30, seed=0, ckpt_every=1000,
                grad_compression=compression)
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5]) - 0.2


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's loop runs 10 steps, checkpointing at 5 and 10;
    the port resumes a copy of its directory without the step-10
    checkpoint (LATEST then names a missing step: the newest valid one,
    step 5, is taken) and runs to step 10."""
    cfg = jax_configs.get_smoke(LOOP_CFG)
    shape = JaxShape("tiny", *LOOP_SHAPE, "train")
    want = jax_loop.run_training(cfg, run_cfg(tmp_path / "jax", JaxRun),
                                 shape, steps=10, seed=3)
    shutil.copytree(tmp_path / "jax", tmp_path / "port",
                    ignore=shutil.ignore_patterns("step_00000010"))
    got = train(tmp_path / "port", 10, seed=3)
    assert got.resumed_from == 5
    np.testing.assert_allclose(got.losses, want.losses[5:], rtol=JAX_RTOL)
    for a, b in zip(jax.tree.leaves(want.state["params"]),
                    tree_leaves(got.state["params"])):
        assert torch.isfinite(b).all() and b.shape == a.shape


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    train_cli.main(["--arch", "qwen3-1.7b", "--steps", "3", "--seq-len",
                    "16", "--global-batch", "2", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "on cpu" in out and "done: 3 steps" in out
    train_cli.main(["--arch", "qwen3-1.7b", "--steps", "4", "--seq-len",
                    "16", "--global-batch", "2", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert "done: 1 steps" in capsys.readouterr().out   # resumed at 3
