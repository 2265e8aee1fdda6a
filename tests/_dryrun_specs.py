"""Child process of ``tests/test_torch_dryrun.py``: the dry run's sharded
stand-ins in both packages on the production meshes, printed as JSON.

The JAX side needs 512 host devices (``XLA_FLAGS`` is set before JAX is
imported) and the port's a fake world of 256 or 512 ranks, which must not
share a process with the gloo worlds of other test files: hence a process
of its own.  For every SMOKE arch, every shape the dry run traces for it
(SMOKE-sized) and both meshes, each leaf's spec is printed as a list of
one entry a dimension: ``null`` or the mesh axes it is sharded over, in
mesh order — JAX's from its ``NamedSharding``, the port's from the
``DTensor``'s placements.  The port's local shards are checked against
DTensor's own split, and ``constrain`` of a plain tensor under the mesh
against the tensor itself.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import Shard  # noqa: E402
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, mesh as tmesh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402


def jax_entry(spec, ndim):
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if e is None:
            out.append(None)
        else:
            out.append(list(e) if isinstance(e, (tuple, list)) else [e])
    return out


def port_entry(t):
    names = t.device_mesh.mesh_dim_names
    out = [[] for _ in range(t.dim())]
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            out[p.dim].append(name)
    want, _ = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements, skip_offset=True)
    assert tuple(t.to_local().shape) == tuple(want), (t.shape, want)
    return [e or None for e in out]


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def cell_shapes(arch):
    for shape in configs.applicable_shapes(configs.get_config(arch)):
        yield dataclasses.replace(shape, seq_len=min(shape.seq_len, 512),
                                  global_batch=min(shape.global_batch, 32))


def main():
    out = {}
    run = dryrun.dryrun_runconfig()
    jrun = JaxRun(**{f.name: getattr(run, f.name)
                     for f in dataclasses.fields(JaxRun)})
    plain = torch.ones(4, 4)
    for multi_pod in (False, True):
        tag = "2x16x16" if multi_pod else "16x16"
        dryrun.fake_world(512 if multi_pod else 256)
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod,
                                          device_type="cpu")
        jmesh = jax_mesh.make_production_mesh(multi_pod=multi_pod)
        with tmesh.mesh_context(mesh):
            out[f"{tag}/constrain_plain"] = [
                shd.constrain(plain, shd.data_axes(), "model") is plain,
                True]
        for arch in configs.ARCHS:
            cfg, jcfg = configs.get_smoke(arch), jax_configs.get_smoke(arch)
            for shape in cell_shapes(arch):
                jshape = jax_configs.shape_by_name(shape.name)
                jshape = dataclasses.replace(jshape, seq_len=shape.seq_len,
                                             global_batch=shape.global_batch)
                key = f"{tag}/{arch}/{shape.name}"
                with FakeTensorMode():
                    if shape.kind == "train":
                        st, batch, _ = specs.train_inputs(cfg, run, shape,
                                                          mesh, "cpu")
                        port = {"state": st, "batch": batch}
                        jst, jbatch, _ = jax_specs.train_inputs(
                            jcfg, jrun, jshape, jmesh)
                        jx = {"state": jst, "batch": jbatch}
                    elif shape.kind == "prefill":
                        p, batch, _ = specs.prefill_inputs(cfg, run, shape,
                                                           mesh, "cpu")
                        port = {"params": p, "batch": batch}
                        jp, jbatch, _ = jax_specs.prefill_inputs(
                            jcfg, jrun, jshape, jmesh)
                        jx = {"params": jp, "batch": jbatch}
                    else:
                        p, cache, tok, pos, _, _ = specs.decode_inputs(
                            cfg, run, shape, mesh, "cpu")
                        assert pos == shape.seq_len - 1
                        port = {"params": p, "cache": cache, "tokens": tok}
                        jp, jcache, jtok, _, _, _ = jax_specs.decode_inputs(
                            jcfg, jrun, jshape, jmesh)
                        jx = {"params": jp, "cache": jcache,
                              "tokens": jtok}
                    got = {k: port_entry(v) for k, v in flat(port).items()}
                jflat = flat(jx)
                want = {k: jax_entry(v.sharding.spec, len(v.shape))
                        for k, v in jflat.items()}
                out[key] = [got, want]
    json.dump(out, sys.stdout)


if __name__ == "__main__":
    main()
