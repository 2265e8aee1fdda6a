"""The model half of the port's sharding rules and its meshes
(``repro_torch.parallel.sharding``, ``repro_torch.launch.mesh``) against
the JAX package's, as ``tests/test_sharding.py`` and
``tests/test_opt_variants.py`` run them.

* ``param_specs`` of every arch's SMOKE parameter tree, in both modes
  (2d, zero3), equal to JAX's (each ``PartitionSpec`` as a tuple);
* ``cache_spec`` of every arch's decode cache equal to JAX's, without a
  mesh and under a production-sized (data 16, model 16) mesh, where the
  heads-or-head_dim fallback decides;
* every sharded dimension of every FULL config divides the production
  mesh (shapes from a ``FakeTensorMode`` init: no memory is taken);
* ``constrain`` returns its tensor, ``head_axes`` on a (1, 1) mesh, the
  production mesh raises on one rank, the mesh helpers agree with JAX's;
* ``init_world`` brings up gloo on the CPU and never falls back from the
  card;
* zero3 and 2d give the same loss under ``mesh_context`` (the port's
  train step; JAX's holds the same, ``tests/test_opt_variants.py``).
"""
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jax_configs
from repro.launch import mesh as jax_mesh
from repro.models import lm as jax_lm
from repro.parallel import sharding as jshd
from repro_torch import configs
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm
from repro_torch.parallel import sharding as shd
from repro_torch.train.step import init_train_state, make_train_step

ARCHS = configs.ARCHS
PROD = {"pod": 2, "data": 16, "model": 16}


@pytest.fixture(scope="module", autouse=True)
def world():
    own = not dist.is_initialized()
    w = tmesh.init_world("cpu")
    yield w
    if own:
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def reset_mode():
    yield
    shd.set_sharding_mode("2d")
    jshd.set_sharding_mode("2d")


def fake_params(cfg):
    with FakeTensorMode():
        return lm.init_params(cfg, torch.Generator())


def as_tuples(tree):
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    return tuple(tuple(e) if isinstance(e, list) else e for e in tree)


@pytest.mark.parametrize("mode", ["2d", "zero3"])
def test_param_specs_equal_jax(mode):
    shd.set_sharding_mode(mode)
    jshd.set_sharding_mode(mode)
    for arch in ARCHS:
        jp = jax.eval_shape(lambda k: jax_lm.init_params(
            jax_configs.get_smoke(arch), k), jax.random.PRNGKey(0))
        want = jax.tree.map(lambda s: tuple(s), jshd.param_specs(jp),
                            is_leaf=lambda x: isinstance(x, jshd.P))
        got = as_tuples(shd.param_specs(fake_params(configs.get_smoke(arch))))
        assert got == want, arch


def test_rules_2d_and_zero3_basic():
    specs = shd.param_specs(fake_params(configs.get_smoke("qwen3-4b")))
    b0 = specs["tiles"]["b0"]
    assert b0["attn"]["wq"] == (None, ("pod", "data"), "model")
    assert b0["attn"]["wo"] == (None, "model", ("pod", "data"))
    assert b0["ln1"] == (None, None)
    assert specs["embed"]["tok"] == ("model", ("pod", "data"))
    shd.set_sharding_mode("zero3")
    specs = shd.param_specs(fake_params(configs.get_smoke("qwen3-4b")))
    assert specs["tiles"]["b0"]["attn"]["wq"] == (
        None, ("pod", "data", "model"), None)
    moe = shd.param_specs(fake_params(configs.get_smoke(
        "qwen2-moe-a2.7b")))["tiles"]["b0"]["moe"]
    assert moe["w1"] == (None, None, ("pod", "data", "model"), None)


def _caches(arch):
    cfg, tcfg = jax_configs.get_smoke(arch), configs.get_smoke(arch)
    jc = jax.eval_shape(lambda: jax_lm.init_decode_cache(cfg, 4, 32))
    with FakeTensorMode():
        tc = lm.init_decode_cache(tcfg, 4, 32, device="cpu")
    return cfg, tcfg, jc, tc


@pytest.mark.parametrize("sized", [False, True], ids=["no_mesh", "16x16"])
def test_cache_spec_equals_jax(sized):
    # a production-sized mesh's axes: JAX's abstract mesh, the port's
    # stand-in (the rules read only its names and sizes)
    jctx = (jax.sharding.use_abstract_mesh(jax.sharding.AbstractMesh(
        (16, 16), ("data", "model"))) if sized else None)
    stand_in = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                     mesh=torch.empty((16, 16),
                                                      device="meta"))
    for arch in ARCHS:
        cfg, tcfg, jc, tc = _caches(arch)
        if sized:
            with jctx:
                want = jshd.cache_spec(cfg, jc)
            with tmesh.mesh_context(stand_in):
                got = shd.cache_spec(tcfg, tc)
                assert shd.mesh_axis_size("model") == 16
        else:
            want, got = jshd.cache_spec(cfg, jc), shd.cache_spec(tcfg, tc)
        want = jax.tree.map(lambda s: tuple(s), want,
                            is_leaf=lambda x: isinstance(x, jshd.P))
        assert as_tuples(got) == want, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_dims_divisible_for_mesh(arch):
    """Every sharded dim of every FULL-config param divides 16 (model) and
    32 (pod x data) as the 2d rules require."""
    params = fake_params(configs.get_config(arch))
    specs = shd.param_specs(params)

    def check(leaf, spec):
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * leaf.dim()):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n = int(np.prod([PROD[a] for a in axes]))
            assert dim % n == 0, (arch, tuple(leaf.shape), spec)

    def walk(p, s):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s[k])
        else:
            check(p, s)

    walk(params, specs)


def test_constrain_noop():
    x = torch.ones((4, 4))
    assert shd.constrain(x, ("pod", "data"), None) is x
    with tmesh.mesh_context(tmesh.make_test_mesh(1, 1)):
        assert shd.constrain(x, ("pod", "data"), "model") is x


def test_head_axes_and_mesh_helpers_equal_jax():
    mesh = tmesh.make_test_mesh(data=1, model=1)
    assert shd.abstract_mesh() is None and shd.data_axes_in_mesh() == ()
    with tmesh.mesh_context(mesh):
        got = (shd.head_axes(16, 128), shd.mesh_axis_size("data"),
               shd.mesh_axis_size("pod"), shd.data_axes_in_mesh(),
               shd.batch_spec(2))
        assert shd.abstract_mesh() is mesh
    with jax_mesh.mesh_context(jax_mesh.make_test_mesh(1, 1)):
        want = (jshd.head_axes(16, 128), jshd.mesh_axis_size("data"),
                jshd.mesh_axis_size("pod"), jshd.data_axes_in_mesh(),
                tuple(jshd.batch_spec(2)))
    assert got == want == ((None, None), 1, 1, ("data",),
                           (("pod", "data"), None, None))
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.mesh.shape) == (1, 1)


def test_production_mesh_raises_on_one_rank():
    with pytest.raises(Exception):
        jax_mesh.make_production_mesh()  # needs 256 devices
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError):
            tmesh.make_production_mesh(multi_pod=multi_pod)


def test_init_world_is_gloo_on_the_cpu_and_never_falls_back():
    w = tmesh.init_world("cpu")
    assert (w.rank, w.size, w.backend, w.device.type) == (0, 1, "gloo", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.init_world()  # the card, NCCL: no card here
    assert dist.get_backend() == "gloo"


def test_zero3_mode_matches_2d_on_one_rank():
    """zero3 sharding rules are semantics-preserving (trivially on one
    rank: the port's step is written per rank)."""
    cfg = configs.get_smoke("gemma-7b")
    run = RunConfig(attn_chunk=8, mlstm_chunk=4, remat_policy="none",
                    z_loss=1e-4)
    batch = {k: torch.from_numpy(v) for k, v in TokenStream(
        cfg, ShapeConfig("t", 32, 4, "train")).batch_at(0).items()}
    mesh = tmesh.make_test_mesh(1, 1)
    losses = []
    for mode in ("2d", "zero3"):
        shd.set_sharding_mode(mode)
        state = init_train_state(cfg, run, torch.Generator().manual_seed(0))
        with tmesh.mesh_context(mesh):
            _, m = make_train_step(cfg, run)(state, batch)
        losses.append(float(m["loss"]))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
