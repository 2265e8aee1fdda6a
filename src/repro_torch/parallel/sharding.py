"""Fleet lane partitioning across devices: the fleet half of the JAX
package's ``parallel/sharding.py`` (``LANE_AXIS``, ``fleet_mesh``,
``lane_sharding``, ``fleet_divisor``, ``shard_fleet``).

A mesh here is the list of devices a fleet may split its lanes over
(:func:`fleet_devices`: every visible CUDA device, or the one device a
caller asked for).  :func:`shard_fleet` cuts the lanes of a carry (and of
a trace carry) into equal slices, one copy a device, and copies the decode
tables to every device; on one device, or when the device count does not
divide the lane count, it returns its inputs unchanged, as in JAX.  The
drivers of :mod:`repro_torch.core.fleet` run a partitioned fleet in
lockstep — one chunk on every slice, each on its own device through the
megastep wrapper, then one liveness test over all lanes — so a run takes
the chunks the unsharded run takes and every leaf is the same; then
:func:`gather_lanes` writes the slices back into the caller's carry.

The JAX package's model half (parameter and cache specs, the 2d and
zero3 modes) is not here: the port's model runs on one device.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..core.machine import resolve_device

LANE_AXIS = "lanes"


def fleet_devices(device=None) -> List[torch.device]:
    """The devices a fleet may split its lanes over: ``[device]`` when one
    is asked for, else every visible CUDA device (``None`` means the
    card, so with no card this raises, as every entry point does)."""
    if device is not None:
        return [resolve_device(device)]
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class FleetMesh(NamedTuple):
    """A 1-D mesh: the devices along ``LANE_AXIS``, in order."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (LANE_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def fleet_mesh(devices=None) -> FleetMesh:
    """1-D mesh over ``devices`` (default :func:`fleet_devices`) for
    lane-parallel fleet execution."""
    devices = list(devices if devices is not None else fleet_devices())
    return FleetMesh(tuple(torch.device(d) for d in devices))


class Shards(tuple):
    """One part a device of the mesh, in mesh order (what
    :func:`shard_fleet` returns for each input it partitions)."""


class LaneSharding(NamedTuple):
    """Splits the leading (lane) axis over the mesh; ``spec`` names each
    axis's mesh axis, as a JAX ``PartitionSpec`` does."""

    mesh: FleetMesh
    spec: Tuple[Optional[str], ...]

    def split(self, x: torch.Tensor) -> Shards:
        """``x``'s lanes in ``mesh.size`` equal slices, each copied to its
        device."""
        w = x.shape[0] // self.mesh.size
        return Shards(x[i * w:(i + 1) * w].to(d, copy=True)
                      for i, d in enumerate(self.mesh.devices))


def lane_sharding(mesh: FleetMesh, extra_dims: int = 0) -> LaneSharding:
    """The sharding that splits the leading (lane) axis over the mesh."""
    return LaneSharding(mesh, (LANE_AXIS,) + (None,) * extra_dims)


def fleet_divisor(n_lanes: int, mesh: Optional[FleetMesh] = None) -> int:
    """The lane-count divisor a partitioned fleet must respect: the device
    count when it divides ``n_lanes`` (so :func:`shard_fleet` actually
    partitions), else 1.  Feed it to ``fleet.compact_ladder(divisor=...)``
    for per-shard bucket ladders, so every rung keeps an equal lane slice a
    device."""
    mesh = mesh or fleet_mesh()
    ndev = mesh.size
    return ndev if ndev > 1 and n_lanes % ndev == 0 else 1


def shard_fleet(imgs, img_ids, states, mesh: Optional[FleetMesh] = None,
                trace=None):
    """Partition a fleet across the mesh: the states, ids and ``trace`` (a
    fleet ``TraceState``) cut along lanes, the decode tables copied to
    every device; each becomes :class:`Shards` of the type it was.

    No-op (returns the inputs unchanged) on a single device or when the
    device count does not divide the lane count: the fleet then runs
    whole, which is always correct.  Returns a 4-tuple iff ``trace`` was
    passed."""
    mesh = mesh or fleet_mesh()
    n_lanes = int(states.pc.shape[0])
    if fleet_divisor(n_lanes, mesh) == 1:
        return ((imgs, img_ids, states) if trace is None
                else (imgs, img_ids, states, trace))
    by_lane = lane_sharding(mesh)

    def split(carry):
        parts = zip(*(by_lane.split(x) for x in carry))
        return Shards(type(carry)(*p) for p in parts)

    imgs = Shards(type(imgs)(*(x.to(d, copy=True) for x in imgs))
                  for d in mesh.devices)
    out = (imgs, by_lane.split(img_ids), split(states))
    return out if trace is None else out + (split(trace),)


def gather_lanes(parts: Shards, carry) -> None:
    """Write each slice of ``parts`` back into ``carry``'s lanes, in
    place, on the carry's device."""
    w = int(parts[0][0].shape[0])
    for i, part in enumerate(parts):
        for dst, src in zip(carry, part):
            dst[i * w:(i + 1) * w].copy_(src)
