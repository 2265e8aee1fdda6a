"""The port's operator roofline (``repro_torch.launch.opanalysis``) against
the JAX package's HLO roofline (``repro.launch.hloanalysis``), on the CPU.

* Dot FLOPs of one step at one device: the port's step traced under
  ``FakeTensorMode``, ``numerics.card_forms`` and ``layers.xla_route``
  (what the dry run counts), the JAX step compiled for the one CPU device
  and read by ``hloanalysis.analyze``; SMOKE configs at batch 4 x 128
  under ``dryrun_runconfig()``.  Equal exactly for the qwen3-1.7b and
  recurrentgemma-2b train steps.
* qwen3-1.7b's prefill: the port's CPU program (XLA's exact forms) applies
  the head to every position, as JAX does, and counts JAX's dots exactly;
  the card's program, which the dry run counts, applies it to the last
  position only, 2 * B * (S - 1) * d * V FLOPs fewer.
* qwen2-moe-a2.7b's train step counts JAX's dots, with and without
  remat: under ``remat_policy="nothing"`` each tile is recomputed in the
  backward; XLA drops the recomputed products whose values the backward
  never reads, and ``torch.utils.checkpoint`` recomputes the tile's
  forward up to the last tensor the backward saved, so the MoE block
  computes its auxiliary loss (whose backward saves tensors) before the
  shared experts' MLP, whose last product's output the backward never
  reads.
* ``_ring_wire_bytes`` equals JAX's for every kind and group size.
"""
import contextlib

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jax_configs
from repro.configs.base import RunConfig as JaxRun
from repro.launch import hloanalysis
from repro.train import step as jax_step
from repro_torch import configs, numerics
from repro_torch.launch import opanalysis
from repro_torch.launch.dryrun import dryrun_runconfig
from repro_torch.models import layers
from repro_torch.train.step import (init_train_state, make_serve_steps,
                                    make_train_step)

B, S = 4, 128


def _run_kwargs(**over):
    run = dryrun_runconfig(**over)
    return {f: getattr(run, f) for f in ("remat_policy", "attn_chunk",
                                         "mlstm_chunk", "decode_budget",
                                         "grad_compression", "z_loss",
                                         "loss_chunk")}


def jax_dot_flops(arch, kind, **over):
    cfg, run = jax_configs.get_smoke(arch), JaxRun(**_run_kwargs(**over))
    st = jax.eval_shape(lambda k: jax_step.init_train_state(cfg, run, k),
                        jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if kind == "train":
        lowered = jax.jit(jax_step.make_train_step(cfg, run)).lower(st, batch)
    else:
        prefill, _ = jax_step.make_serve_steps(cfg, run)
        lowered = jax.jit(prefill).lower(st["params"], batch)
    return hloanalysis.analyze(lowered.compile().as_text()).dot_flops


def port_stats(arch, kind, card=True, **over):
    cfg, run = configs.get_smoke(arch), dryrun_runconfig(**over)
    forms = numerics.card_forms() if card else contextlib.nullcontext()
    with FakeTensorMode(), forms, layers.xla_route():
        st = init_train_state(cfg, run, torch.Generator())
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32)}
        if kind == "train":
            return opanalysis.analyze(make_train_step(cfg, run), st, batch)
        prefill, _ = make_serve_steps(cfg, run)
        return opanalysis.analyze(prefill, st["params"], batch)


@pytest.mark.parametrize("arch,kind,want", [
    ("qwen3-1.7b", "train", 469_368_832),
    ("recurrentgemma-2b", "train", 620_363_776),
])
def test_dot_flops_equal_jax_hlo(arch, kind, want):
    got = port_stats(arch, kind)
    assert jax_dot_flops(arch, kind) == want
    assert got.dot_flops == want
    assert got.mem_bytes > 0 and got.peak_bytes >= got.argument_bytes > 0
    assert not got.collectives


def test_prefill_dot_flops_against_jax_hlo():
    cfg = configs.get_smoke("qwen3-1.7b")
    want = jax_dot_flops("qwen3-1.7b", "prefill")
    assert want == 125_829_120
    assert port_stats("qwen3-1.7b", "prefill", card=False).dot_flops == want
    card = port_stats("qwen3-1.7b", "prefill")
    head_rows_skipped = 2 * B * (S - 1) * cfg.d_model * cfg.padded_vocab
    assert card.dot_flops == want - head_rows_skipped
    assert not card.collectives


def test_moe_dot_flops_equal_jax_hlo():
    got = port_stats("qwen2-moe-a2.7b", "train").dot_flops
    assert got == jax_dot_flops("qwen2-moe-a2.7b", "train") == 760_872_960
    assert (port_stats("qwen2-moe-a2.7b", "train", remat_policy="none")
            .dot_flops
            == jax_dot_flops("qwen2-moe-a2.7b", "train",
                             remat_policy="none"))


@pytest.mark.parametrize("n", [1, 2, 16, 256])
@pytest.mark.parametrize("kind", sorted(hloanalysis.COLLECTIVE_KINDS)
                         + ["send"])
def test_ring_wire_bytes_equal_jax(kind, n):
    for operand, out in [(0, 0), (1000, 16000), (4096, 256), (123457, 7)]:
        assert (opanalysis._ring_wire_bytes(kind, operand, out, n)
                == hloanalysis._ring_wire_bytes(kind, operand, out, n))
    assert opanalysis.COLLECTIVE_KINDS == hloanalysis.COLLECTIVE_KINDS


def test_hardware_and_roofline_terms():
    hw = opanalysis.HW
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (989.4e12, 3.35e12,
                                                      50e9)
    st = opanalysis.OpStats(dot_flops=int(989.4e12), mem_bytes=int(6.7e12))
    st.collectives["all-reduce"] = opanalysis.CollectiveStat(1, 10, int(50e9))
    r = opanalysis.roofline_terms(st)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 2.0, 1.0)
    assert r.dominant == "memory" and r.bound_s == 2.0
    assert set(r.to_dict()) == {"compute_s", "memory_s", "collective_s",
                                "dominant", "dot_flops", "mem_bytes",
                                "wire_bytes"}


def test_analyze_counts_what_runs():
    """Eager loops run every trip; views move no bytes; live bytes peak
    with the temporaries and fall when they die."""
    a, b = torch.randn(64, 32), torch.randn(32, 128)

    def f(a, b):
        out = torch.zeros(())
        for _ in range(3):
            c = a @ b                       # 2*64*32*128 FLOPs a trip
            out = out + c.t().contiguous().sum()
        return out

    st = opanalysis.analyze(f, a, b)
    assert st.dot_flops == 3 * 2 * 64 * 32 * 128
    assert "t" not in st.mem_by_kind and "mm" in st.mem_by_kind
    assert st.mem_by_kind["mm"] == 3 * (64 * 32 + 32 * 128 + 64 * 128) * 4
    assert st.argument_bytes == (64 * 32 + 32 * 128) * 4
    assert st.peak_bytes >= st.argument_bytes + 2 * 64 * 128 * 4


def test_card_forms_is_scoped():
    x = torch.ones(3)
    assert numerics.exact_forms(x)
    with numerics.card_forms():
        assert not numerics.exact_forms(x)
        with numerics.card_forms():
            pass
        assert not numerics.exact_forms(x)
    assert numerics.exact_forms(x)
