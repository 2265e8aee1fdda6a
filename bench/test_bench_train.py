"""The training cell at a tiny size on the CPU (a gloo world of one
rank): the run is correct, and its control and every fault it can have
are not."""
from __future__ import annotations

import pytest
import torch

from bench import calibrate, common, faults, run
from bench.conftest import TINY_TRAIN, tiny_spec, tiny_train_config
from bench.drivers import train
from bench.ref import qwen3


def test_tiny_train_run_is_correct(tiny_root):
    res, checks = run.run_cell(TINY_TRAIN, 2**31 + 3, 4.0, True,
                               device="cpu", spec=tiny_spec(), root=tiny_root,
                               trace_seconds=0.0)
    assert res["correct"], checks
    assert res["attempted"] >= 1
    assert {"train.mfu", "hook.ops_per_step"} <= set(res["metrics"])
    assert res["metrics"]["hook.ops_per_step"]["value"] > 100


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_each_fault_is_caught(tiny_root, fault):
    got = calibrate.readings(TINY_TRAIN, 31, fault=fault, device="cpu",
                             root=tiny_root)
    lim = common.load_workload(TINY_TRAIN, tiny_root)["params"]["limits"]
    assert any(got[k] > lim[k] for k in lim), got


def test_the_control_is_not_correct(tiny_root):
    got = calibrate.readings(TINY_TRAIN, 37, control="fp8", device="cpu",
                             root=tiny_root)
    lim = common.load_workload(TINY_TRAIN, tiny_root)["params"]["limits"]
    assert any(got[k] > lim[k] for k in lim), got


def test_reference_loss_is_the_ports_on_f32_inputs():
    """The plain reference and the port's loss on the same parameters
    and tokens, the port's model run in float32 on the CPU."""
    from repro_torch.models import layers, lm
    cfg = tiny_train_config()
    t = cfg["train"]
    mc, rc = train.port_configs(cfg, t)
    p = train.make_params(cfg, t, 5, "cpu")
    toks = torch.randint(0, cfg["vocab_size"], (2, t["seq_len"]),
                         generator=torch.Generator().manual_seed(1))
    want, _ = qwen3.loss(cfg, p, toks, z_loss=t["z_loss"])
    old = layers.COMPUTE_DTYPE
    try:
        lm.COMPUTE_DTYPE = torch.float32
        got, _ = lm.loss_fn(mc, rc, train.port_tree(p), {"tokens": toks})
    finally:
        lm.COMPUTE_DTYPE = old
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))


def test_leaf_norms_split_stacked_leaves():
    x = {"tok": torch.ones(3, 2), "final_norm": torch.ones(2)}
    x.update({k: torch.ones(2, 4) * (i + 1)
              for i, k in enumerate(qwen3.STACKED)})
    n = train.leaf_norms(lambda k: x[k])
    assert len(n) == 2 + 2 * len(qwen3.STACKED)
    assert n["layers.1.wq"] == pytest.approx(2 * 2.0)
    g, at = train.gap({**n, "tok": n["tok"] * 1.5}, n)
    assert at == "tok" and g > 0
