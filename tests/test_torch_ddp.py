"""The port's explicit-all-reduce DDP step (``make_ddp_train_step``)
against the JAX package's, on a one-rank gloo world and a (1, 1) JAX test
mesh.

qwen3-1.7b and qwen2-moe-a2.7b SMOKE, and qwen3-1.7b under ``int8_ef``,
from the same numpy-seeded weights (``chip_smoke.numpy_params``, carried
across by ``repro_torch.models.interop``) and the same ``TokenStream``
batch, two steps in each package (JAX compiled with excess precision off,
``tests/_lm_parity.Strict``):

* the first step's metrics ``ce``, ``z_loss``, ``aux`` and ``loss``
  within 1e-6 relative of JAX's (tests/test_torch_train.py's bound: the
  same parameters), the second step's within 2e-2 (the parameters then
  differ: tests/test_torch_train_loop.py's bound), ``lr`` bit for bit,
  ``grad_norm`` within the gradient bound 2e-2;
* AdamW itself is held bit for bit on identical gradients by
  ``tests/test_torch_optim.py``; here the gradients are each package's
  own, within relative L2 2e-2 of each other (the bf16 bound).  So after
  the first step, from zero moments, every leaf's ``m / (1 - b1)`` (the
  gradient the wire carried; plus the residual under ``int8_ef``, whose
  grid rounding moves between the two) is held within relative L2 2e-2
  of JAX's, ``v`` (a square) within 4e-2; the parameters after each step
  within 2e-2 relative / 2e-3 absolute, the bound
  ``tests/test_opt_variants.py`` holds a step on gradients that differ in
  rounding to;
* the port's census of its DDP step equal to JAX's ``census_fn`` of JAX's
  (sites, primitives, payload bytes);
* the port's one-rank DDP step equal to its own ``make_train_step`` bit
  for bit (every parameter, moment, residual and metric), hooked with a
  pass-through ``TraceHandler`` too.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jax_configs
from repro import hooks as jhooks
from repro.configs.base import ShapeConfig as JaxShape
from repro.data.pipeline import TokenStream as JaxStream
from repro.launch.mesh import make_test_mesh as jax_test_mesh
from repro.optim import adamw as jax_adamw
from repro.optim import compress as jax_compress
from repro.train.step import make_ddp_train_step as jax_ddp_step
from repro_torch import configs
from repro_torch.hooks import TraceHandler, census_fn, hooking
from repro_torch.launch.mesh import init_world, make_test_mesh
from repro_torch.models.interop import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.optim import compress
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.step import make_ddp_train_step, make_train_step

from _lm_parity import Strict

_spec = importlib.util.spec_from_file_location(
    "_chip_smoke_ddp", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

METRIC_RTOL = 1e-6
GRAD_RTOL = 2e-2    # tests/test_kernels.py:26-27, bf16
TRAIN_RTOL = 2e-2   # losses after steps apart (tests/test_torch_train_loop.py)
# parameters after a step on gradients that differ in rounding: the bounds
# of tests/test_opt_variants.py::test_microbatch_matches_full_batch
SPLIT_PARAM_RTOL, SPLIT_PARAM_ATOL = 2e-2, 2e-3
RUN = dict(attn_chunk=8, mlstm_chunk=4, remat_policy="none", z_loss=1e-4)
SHAPE = JaxShape("t", 16, 2, "train")
STEPS = 2
CASES = (("qwen3-1.7b", {}), ("qwen2-moe-a2.7b", {}),
         ("qwen3-1.7b", {"grad_compression": "int8_ef"}))


@pytest.fixture(scope="module", autouse=True)
def world():
    """A one-rank gloo world for this file (one intra-op thread: many
    small operations, several test processes side by side), destroyed at
    its end."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    own = not dist.is_initialized()
    w = init_world("cpu")
    yield w
    if own:
        dist.destroy_process_group()
    torch.set_num_threads(n)


def build(arch, **run_kw):
    """(JAX cfg, run, state, batch), (port cfg, run, state, batch)."""
    cfg, tcfg = jax_configs.get_smoke(arch), configs.get_smoke(arch)
    kw = {**RUN, **run_kw}
    weights = SMOKE.numpy_params(arch, 0)
    jp = jax.tree.map(jnp.asarray, weights)
    tp = params_from_numpy(weights, device="cpu")
    jstate = {"params": jp, "opt": jax_adamw.init_opt_state(jp)}
    tstate = {"params": tp, "opt": adamw.init_opt_state(tp)}
    if kw.get("grad_compression") == "int8_ef":
        jstate["ef"] = jax_compress.init_ef_state(jp)
        tstate["ef"] = compress.init_ef_state(tp)
    b = JaxStream(cfg, SHAPE).batch_at(0)
    return ((cfg, jax_configs.RunConfig(**kw), jstate,
             {k: jnp.asarray(v) for k, v in b.items()}),
            (tcfg, configs.RunConfig(**kw), tstate,
             {k: torch.from_numpy(v) for k, v in b.items()}))


def named(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from named(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def rel_l2(got, want) -> float:
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / n) if n else float(
        np.linalg.norm(got))


@pytest.mark.parametrize("arch,run_kw", CASES,
                         ids=["qwen3-1.7b", "qwen2-moe-a2.7b", "int8_ef"])
def test_ddp_step_close_to_jax(arch, run_kw):
    (cfg, run, jstate, jb), (tcfg, trun, tstate, tb) = build(arch, **run_kw)
    jstep = Strict(jax_ddp_step(cfg, run, jax_test_mesh(1, 1)))
    tstep = make_ddp_train_step(tcfg, trun, make_test_mesh(1, 1))
    for step in range(STEPS):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        # the first step's forward runs on the same parameters
        rtol = METRIC_RTOL if step == 0 else TRAIN_RTOL
        for k in ("ce", "z_loss", "aux", "loss"):
            assert float(tm[k]) == pytest.approx(
                float(jm[k]), rel=rtol, abs=1e-12), (step, k)
        assert float(tm["lr"]) == float(jm["lr"])
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=GRAD_RTOL)
        want = dict(named(jstate["params"]))
        for path, t in named(tstate["params"]):
            np.testing.assert_allclose(t.numpy(), np.asarray(want[path]),
                                       rtol=SPLIT_PARAM_RTOL,
                                       atol=SPLIT_PARAM_ATOL, err_msg=path)
        if step:
            continue
        # after one step from zero moments: m = (1 - b1) c g, v = (1 - b2)
        # (c g)^2 of what the wire carried, clipped by c = min(1, clip /
        # norm); g itself under error feedback (sent + residual: the int8
        # grid's rounding moves between the two)
        jm_, tm_ = dict(named(jstate["opt"]["m"])), named(tstate["opt"]["m"])
        jef = dict(named(jstate["ef"])) if "ef" in jstate else {}
        tef = dict(named(tstate["ef"])) if "ef" in tstate else {}
        jc = min(1.0, run.grad_clip / float(jm["grad_norm"]))
        tc = min(1.0, trun.grad_clip / float(tm["grad_norm"]))
        for path, t in tm_:
            got = t.numpy() / ((1 - trun.b1) * tc)
            ref = np.asarray(jm_[path]) / ((1 - run.b1) * jc)
            if tef:
                got, ref = got + tef[path].numpy(), ref + np.asarray(
                    jef[path])
            assert rel_l2(got, ref) <= GRAD_RTOL, ("m", path)
        jv = dict(named(jstate["opt"]["v"]))
        for path, t in named(tstate["opt"]["v"]):
            assert rel_l2(t.numpy(), np.asarray(jv[path])) \
                <= 2 * GRAD_RTOL, ("v", path)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == STEPS


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_ddp_census_equals_jax(arch):
    (cfg, run, jstate, jb), (tcfg, trun, tstate, tb) = build(arch)
    c = census_fn(make_ddp_train_step(tcfg, trun, make_test_mesh(1, 1)),
                  tstate, tb)
    jc = jhooks.census_fn(jax_ddp_step(cfg, run, jax_test_mesh(1, 1)),
                          jstate, jb)
    n_leaves = len(tree_leaves(tstate["params"]))
    assert c["total_sites"] == jc["total_sites"] == n_leaves + 4
    assert c["by_primitive"] == jc["by_primitive"] == {"psum": n_leaves + 4}
    for k in ("payload_bytes_static", "payload_bytes_per_step"):
        assert c[k] == jc[k], k
    assert {s.loop_trip for s in c["sites"]} == {1}
    assert sorted(s.in_shapes for s in c["sites"]) == sorted(
        tuple(tuple(x) for x in s.in_shapes) for s in jc["sites"])
    # the census ran on clones: the caller's state did not move
    assert int(tstate["opt"]["step"]) == 0


@pytest.mark.parametrize("arch,run_kw", CASES,
                         ids=["qwen3-1.7b", "qwen2-moe-a2.7b", "int8_ef"])
def test_one_rank_ddp_step_equals_train_step(arch, run_kw):
    """One rank's all-reduce and a division by 1 leave every value as it
    was: the DDP step, plain and hooked, is make_train_step bit for bit."""
    _, (tcfg, trun, s1, tb) = build(arch, **run_kw)
    _, (_, _, s2, _) = build(arch, **run_kw)
    _, (_, _, s3, _) = build(arch, **run_kw)
    plain = make_train_step(tcfg, trun)
    ddp = make_ddp_train_step(tcfg, trun, make_test_mesh(1, 1))
    th = TraceHandler()
    for _ in range(STEPS):
        s1, m1 = plain(s1, tb)
        s2, m2 = ddp(s2, tb)
        with hooking({"psum": th}):
            s3, m3 = ddp(s3, tb)
        assert {k: float(v) for k, v in m1.items()} == \
            {k: float(v) for k, v in m2.items()} == \
            {k: float(v) for k, v in m3.items()}
    for a, b, c in zip(tree_leaves(s1), tree_leaves(s2), tree_leaves(s3)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert th.count == STEPS * (len(tree_leaves(s1["params"])) + 4)


def test_ddp_step_splits_the_batch_over_its_ranks():
    _, (tcfg, trun, s, tb) = build("qwen3-1.7b")
    tb = {k: v[:1] for k, v in tb.items()}
    step = make_ddp_train_step(tcfg, trun, make_test_mesh(1, 1))
    step(s, tb)  # one rank takes every row, also of a batch of one
    with pytest.raises(ValueError, match="attn_impl"):
        make_ddp_train_step(tcfg, configs.RunConfig(**RUN, attn_impl="pallas"),
                            make_test_mesh(1, 1))
