"""Process groups and device meshes (the JAX package's ``launch/mesh.py``).

Single pod: (data=16, model=16) — 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) — 512 ranks; the ``pod`` axis joins ``data`` in every
batch/FSDP sharding rule (``parallel.sharding.DATA_AXES``), so gradient
reduction is hierarchical, as in the JAX package.

A JAX mesh names the devices of one program; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group, which :func:`init_world` brings up: NCCL on the card
(``device=None``), gloo only when the caller asks for the CPU; from
``torchrun``'s environment when it is set, else a one-rank world on an
in-process ``HashStore``.  A failed NCCL init raises; nothing falls back
to gloo or to the CPU.

The dry run (``launch.dryrun``) brings up a fake world of 256 or 512
ranks instead (``torch.testing._internal.distributed.fake_pg``: no
communication) and builds the production mesh on it.

The JAX package's ``shard_map_fn`` has no counterpart: the port's
collective programs (``train.step.make_ddp_train_step``) are written per
rank, which is what a shard_map body is.
"""
from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.machine import resolve_device
from ..parallel import sharding


class World(NamedTuple):
    rank: int
    size: int
    device: torch.device
    backend: str


def _world() -> World:
    backend = dist.get_backend()
    if backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return World(dist.get_rank(), dist.get_world_size(), device, backend)


def init_world(device=None) -> World:
    """Bring up the default process group (once) and return this rank's
    place in it.  ``device=None`` is the card (NCCL); ``"cpu"`` is gloo."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}"
                               f", not {backend} for {dev}")
        return _world()
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dev.index
                                                 or 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return _world()


def destroy_world() -> None:
    """Tear down the default process group (and the backend's threads)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with ``axes`` as its dimension names
    over the world's ranks (brought up on the card if it is not yet), on
    the world's device type unless ``device_type`` is given (the dry
    run's fake world serves both)."""
    world = _world() if dist.is_initialized() else init_world()
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or world.device.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the current mesh for the sharding rules
    (``parallel.sharding.abstract_mesh``)."""
    sharding._MESHES.append(mesh)
    try:
        yield mesh
    finally:
        sharding._MESHES.pop()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The production mesh; raises unless the world has 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_test_mesh(data: int = 1, model: int = 1):
    """Tiny mesh for unit tests on a one-rank world."""
    return make_mesh((data, model), ("data", "model"))
