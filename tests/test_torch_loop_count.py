"""The dry run's loop-aware count: a loop over time (``loops.time_loop``:
the sLSTM's steps, the chunked mLSTM's chunks) counted by
``launch.opanalysis`` from one traced step, as the JAX package's
``hloanalysis`` multiplies a ``while`` body by its trip count.

* On plain fake tensors (xlstm-350m SMOKE's train and prefill steps,
  batch 2 x 16 positions) and on a fake 2 x 2 mesh (a child process: a
  fake world of 4 ranks; the sLSTM block checkpointed, its parameters
  laid out by the sharding rules, batch 4 x 16), the counted loop's dot
  FLOPs, bytes (by operator) and collectives equal the eager loop's
  exactly, forward, under the checkpoint's recompute and backward; its
  peak of live bytes is within 2 % of the eager loop's on plain tensors
  and 5 % on the mesh.
* ``while_trips`` lists the counted loops; outside the analyzer the loop
  is the eager one, bit for bit.
* xlstm-350m's SMOKE train step against the JAX package's one-device HLO
  count (batch 4 x 128), with and without remat: equal but for four
  products, each pinned by name and FLOPs.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs, loops, numerics
from repro_torch.launch import opanalysis
from repro_torch.launch.dryrun import dryrun_runconfig
from repro_torch.models import layers, recurrent
from repro_torch.train.step import (init_train_state, make_serve_steps,
                                    make_train_step)
from test_torch_opanalysis import B, S, jax_dot_flops, port_stats

REPO = pathlib.Path(__file__).parent.parent


def _eager(self, step, carry, consts, n):
    ys = []
    for t in range(n):
        carry, y = step(consts, carry, t)
        ys.append(y)
    return carry, ys


def _stats(kind, counted, batch=2, seq=16, **over):
    cfg, run = configs.get_smoke("xlstm-350m"), dryrun_runconfig(**over)
    loop = opanalysis._Counter.time_loop
    if not counted:
        opanalysis._Counter.time_loop = _eager
    try:
        with FakeTensorMode(), numerics.card_forms(), layers.xla_route():
            st = init_train_state(cfg, run, torch.Generator())
            tokens = {"tokens": torch.empty((batch, seq), dtype=torch.int32)}
            if kind == "train":
                return opanalysis.analyze(make_train_step(cfg, run), st,
                                          tokens)
            prefill, _ = make_serve_steps(cfg, run)
            return opanalysis.analyze(prefill, st["params"], tokens)
    finally:
        opanalysis._Counter.time_loop = loop


@pytest.mark.parametrize("kind,remat,trips", [
    ("train", "nothing", [16, 16, 16]),  # forward, recompute, backward
    ("train", "none", [16, 16]),
    ("prefill", "nothing", [16]),
])
def test_counted_loop_equals_the_eager_loop(kind, remat, trips):
    eager = _stats(kind, False, remat_policy=remat)
    got = _stats(kind, True, remat_policy=remat)
    assert got.dot_flops == eager.dot_flops > 0
    assert got.mem_bytes == eager.mem_bytes
    assert got.mem_by_kind == eager.mem_by_kind
    assert got.collectives == eager.collectives == {}
    assert got.argument_bytes == eager.argument_bytes
    assert abs(got.peak_bytes / eager.peak_bytes - 1) < 0.02
    assert eager.while_trips == [] and got.while_trips == trips


MESH_CHILD = r"""
import dataclasses, json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import configs, numerics
from repro_torch.launch import dryrun, opanalysis, specs
from repro_torch.launch.mesh import make_mesh, mesh_context
from repro_torch.models import layers, recurrent
from repro_torch.parallel import sharding

def eager(self, step, carry, consts, n):
    ys = []
    for t in range(n):
        carry, y = step(consts, carry, t)
        ys.append(y)
    return carry, ys

dryrun.fake_world(4)
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
cfg = configs.get_smoke("xlstm-350m")

def step(p, x):
    # checkpointed as a tile is under remat "nothing": forward, the
    # recompute, backward
    y = layers.checkpoint(
        lambda p, x: recurrent.apply_slstm(cfg, p, x)[0], p, x)
    torch.autograd.grad(y.float().sum(), list(p.values()) + [x])

out, loop = {}, opanalysis._Counter.time_loop
for counted in (False, True):
    opanalysis._Counter.time_loop = loop if counted else eager
    with FakeTensorMode(), mesh_context(mesh), implicit_replication(), \
            layers.xla_route(), numerics.card_forms():
        p = recurrent.init_slstm(cfg, torch.Generator())
        ps = sharding.param_specs({"tail": {"b0": {"slstm": p}}})
        p = {k: specs.sds(v.shape, v.dtype, specs._named(
                 mesh, ps["tail"]["b0"]["slstm"][k]), v.device)
             .requires_grad_() for k, v in p.items()}
        x = specs.sds((4, 16, cfg.d_model), torch.bfloat16, specs._named(
            mesh, sharding.batch_spec(2)), torch.device("cpu"))
        st = opanalysis.analyze(step, p, x.requires_grad_())
    out[str(counted)] = dict(
        dot=st.dot_flops, mem=st.mem_bytes, kinds=st.mem_by_kind,
        peak=st.peak_bytes, trips=st.while_trips,
        collectives={k: dataclasses.asdict(v)
                     for k, v in st.collectives.items()},
        groups={str(k): v for k, v in st.by_group_size.items()})
print(json.dumps(out))
"""


def test_counted_loop_equals_the_eager_loop_on_a_fake_mesh():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", MESH_CHILD], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    eager, got = out["False"], out["True"]
    for key in ("dot", "mem", "kinds", "collectives", "groups"):
        assert got[key] == eager[key], key
    assert eager["dot"] > 0
    assert {"all-gather", "reduce-scatter"} <= set(eager["collectives"])
    assert abs(got["peak"] / eager["peak"] - 1) < 0.05
    assert eager["trips"] == [] and got["trips"] == [16, 16, 16]


def test_time_loop_outside_the_analyzer_is_the_eager_loop():
    cfg = configs.get_smoke("xlstm-350m")
    g = torch.Generator().manual_seed(3)
    p = recurrent.init_slstm(cfg, g)
    x = torch.randn(2, 9, cfg.d_model, generator=g).bfloat16()
    assert loops.HOOK[0] is None
    y, cache = recurrent.apply_slstm(cfg, p, x)
    zeros = torch.zeros((2, cfg.d_model))
    carry, hs = (zeros, zeros, torch.full_like(zeros, -1e30), zeros), []
    for t in range(9):
        carry = recurrent.slstm_step(p, carry, x.float()[:, t], cfg.n_heads)
        hs.append(carry[3])
    h = layers.rms_norm(torch.stack(hs, 1), p["norm"], cfg.norm_eps)
    want = layers.dot(h.to(x.dtype), p["w_down"].to(x.dtype))
    assert torch.equal(y.view(torch.int16), want.view(torch.int16))
    for got, ref in zip((cache[k] for k in "cnmh"), carry):
        assert torch.equal(got, ref)
    _stats("prefill", True, seq=8)
    assert loops.HOOK[0] is None


def _xlstm_pins():
    """The four products by which the port's xlstm-350m SMOKE train step
    differs from JAX's count, per pass, at batch B x S (one chunk of S
    positions: the SMOKE chunk is 256)."""
    cfg = configs.get_smoke("xlstm-350m")
    H = cfg.n_heads
    dh = 2 * cfg.d_model // H                  # the mLSTM's head width
    dh_s = cfg.d_model // H                    # the sLSTM's
    n_m = cfg.block_pattern.count("mlstm") * (cfg.n_layers
                                              // len(cfg.block_pattern))
    n_s = cfg.n_layers // len(cfg.block_pattern)
    return {
        # the port computes the last chunk's state update "blhd,blhe->bhde"
        # (train discards the state; XLA drops it): once a forward pass
        "mlstm_state_update": n_m * 2 * B * H * S * dh * dh,
        # JAX's backward computes that update's two transposed products
        # from the final state's zero cotangent (the scan's transpose)
        "jax_state_update_backward": n_m * 2 * (2 * B * H * S * dh * dh),
        # the port's backward of "bkhd,bhd->bkh" (q . n) for q: an outer
        # product, a bmm of contraction 1 (XLA: an elementwise multiply)
        "mlstm_qn_outer_backward": n_m * 2 * B * H * S * dh,
        # JAX's scan backward computes the first step's cotangent of the
        # initial h (zeros, needing no gradient in the port): the four
        # recurrent products "bhd,hde->bhe"
        "jax_slstm_initial_h_backward": n_s * 4 * 2 * B * H * dh_s * dh_s,
    }


@pytest.mark.parametrize("remat,passes", [("nothing", 2), ("none", 1)])
def test_xlstm_train_dot_flops_against_jax_hlo(remat, passes):
    pins = _xlstm_pins()
    assert pins == {"mlstm_state_update": 12_582_912,
                    "jax_state_update_backward": 25_165_824,
                    "mlstm_qn_outer_backward": 393_216,
                    "jax_slstm_initial_h_backward": 32_768}
    got = port_stats("xlstm-350m", "train", remat_policy=remat).dot_flops
    want = jax_dot_flops("xlstm-350m", "train", remat_policy=remat)
    assert want == {"nothing": 1_531_314_176, "none": 1_167_065_088}[remat]
    assert got == (want + passes * pins["mlstm_state_update"]
                   - pins["jax_state_update_backward"]
                   + pins["mlstm_qn_outer_backward"]
                   - pins["jax_slstm_initial_h_backward"])
