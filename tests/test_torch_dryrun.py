"""The port's multi-pod dry run (``repro_torch.launch.dryrun``,
``launch.specs``) against the JAX package's, on the CPU.

* The sharded stand-ins: every leaf's layout of every SMOKE arch's state,
  batch and decode cache, for every shape the dry run traces, on both
  production meshes (16x16 and 2x16x16), equal to JAX's ``NamedSharding``
  specs (``tests/_dryrun_specs.py``, a process of its own: a fake world of
  256 or 512 ranks, and JAX with 512 host devices).
* The CLI (``python -m repro_torch.launch.dryrun --smoke --device cpu``,
  in a subprocess) on the cells ``tests/test_dryrun_smoke.py`` runs, on
  16x16: that test's asserts; ``model_flops_per_device`` equal to the JAX
  cell's; the train step's gradient reduced over the mesh (an all-reduce
  or a reduce-scatter among its collectives).
* ``--all``: every applicable cell on both meshes in a child process of
  its own; a cell still tracing at ``--timeout`` is recorded ``FAIL``.
* ``constrain`` of a plain tensor is the tensor itself, without a mesh and
  (in the child) under the production mesh; ``placements`` of a spec.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

from repro import configs as jax_configs
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel import sharding as shd

REPO = pathlib.Path(__file__).parent.parent


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    return env


def jax_model_flops_per_device(arch, shape_name, chips=256):
    """The JAX dry run's ``model_flops_per_device`` of a SMOKE cell.  Its
    module sets ``XLA_FLAGS`` when imported; the variable is put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jax_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    shape = jax_configs.shape_by_name(shape_name)
    shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 512),
                                global_batch=min(shape.global_batch, 32))
    return jax_dryrun.model_flops_per_step(jax_configs.get_smoke(arch),
                                           shape) / chips


def test_specs_equal_jax_on_production_meshes():
    res = subprocess.run([sys.executable, str(REPO / "tests" /
                                              "_dryrun_specs.py")],
                         env=dict(_env(), JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    cells = json.loads(res.stdout)
    assert len(cells) == 2 * (1 + sum(
        len(jax_configs.applicable_shapes(jax_configs.get_config(a)))
        for a in jax_configs.ARCHS))
    for key, (got, want) in cells.items():
        assert got == want, key
    # the layouts are not all trivial
    st = cells["2x16x16/qwen3-1.7b/train_4k"][0]
    assert st["/state/params/tiles/b0/attn/wq"] == [
        None, ["pod", "data"], ["model"]]
    assert st["/batch/tokens"] == [["pod", "data"], None]


@pytest.mark.parametrize("cell", [
    ("qwen3-1.7b", "train_4k"),
    ("recurrentgemma-2b", "long_500k"),
])
def test_dryrun_cli_smoke_cell(tmp_path, cell):
    arch, shape = cell
    out = tmp_path / "dry.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--smoke", "--device", "cpu", "--out", str(out),
         "--label", "ci"],
        env=_env(), capture_output=True, text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    cells = json.loads(out.read_text())
    assert len(cells) == 1
    c = cells[0]
    assert c["status"] == "OK", (c.get("error"), c.get("traceback"))
    assert c["mesh"] == "16x16" and c["label"] == "ci"
    assert c["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert c["hlo_dot_flops_per_device"] > 0
    assert c["bytes_per_device"] > 0
    assert c["model_flops_per_device"] == jax_model_flops_per_device(arch,
                                                                     shape)
    assert f"  OK trace={c['trace_s']}s" in res.stdout
    if shape == "train_4k":
        assert {"all-reduce", "reduce-scatter"} & set(c["collectives"])
        assert c["collective_wire_bytes_per_device"] > 0


def test_dryrun_all_records_cells_stopped_at_timeout(tmp_path):
    out = tmp_path / "all.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--both-meshes", "--smoke", "--device", "cpu", "--workers", "6",
         "--timeout", "0.5", "--out", str(out), "--label", "ci"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    cells = json.loads(out.read_text())
    want = {(a, s.name, m) for a in jax_configs.ARCHS
            for s in jax_configs.applicable_shapes(jax_configs.get_config(a))
            for m in ("16x16", "2x16x16")}
    assert len(cells) == len(want)
    assert {(c["arch"], c["shape"], c["mesh"]) for c in cells} == want
    for c in cells:
        assert c["status"] == "FAIL" and c["label"] == "ci"
        assert c["error"] == "TimeoutExpired: not traced within 0.5 s"
        assert c["trace_s"] >= 0.5


def test_constrain_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    x = torch.ones(4, 4)
    assert shd.constrain(x, shd.data_axes(), "model") is x
    stand_in = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                     shape=(2, 16, 16))
    with tmesh.mesh_context(stand_in):
        assert shd.constrain(x, shd.data_axes(), "model") is x
        assert shd.mesh_axis_size("data") == 16
    assert shd.placements(stand_in, shd.P(("pod", "data"), None, "model")) \
        == [Shard(0), Shard(0), Shard(2)]
    assert shd.placements(stand_in, shd.P(None, "data")) == [
        Replicate(), Shard(1), Replicate()]
    two_d = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert shd.placements(two_d, shd.P(("pod", "data"), "model")) == [
        Shard(0), Shard(1)]
    assert shd.constrain_like(x, x) is x
