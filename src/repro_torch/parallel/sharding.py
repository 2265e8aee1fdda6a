"""Sharding rules: the JAX package's ``parallel/sharding.py``, both halves.

*The model half* — logical-axis rules: FSDP over ``data`` (+``pod``), TP
over ``model``.  Parameters are sharded 2-D (ZeRO-3 style over the data
axes *and* tensor-parallel over ``model``); ``set_sharding_mode("zero3")``
folds the model axis into FSDP.  Head-layout fallback: shard the *heads*
axis over ``model`` when divisible, else the *head_dim* axis, else
replicate.  A spec is :class:`P`, a tuple of axis entries (``None``, an
axis name or a tuple of names), as a JAX ``PartitionSpec`` is; the mesh
the rules read is the one ``launch.mesh.mesh_context`` makes current.
:func:`placements` turns a spec into a ``DTensor``'s placements on a
``DeviceMesh`` (``_named``'s place in the JAX package's launcher).
``constrain`` is ``with_sharding_constraint``'s place: inside a
``mesh_context``, a ``DTensor`` is redistributed to the spec's
placements; any other tensor is returned as it is (the same object) —
the port's collective programs are written per rank, so a plain tensor
already is its rank's shard, as the JAX package's ``constrain`` drops a
shard_map body's Manual axes and is a no-op outside a mesh.

*The fleet half* — lane partitioning across devices (``LANE_AXIS``,
``fleet_mesh``, ``lane_sharding``, ``fleet_divisor``, ``shard_fleet``).
A fleet mesh is the list of devices a fleet may split its lanes over
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
"""
from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..core.machine import resolve_device

DATA_AXES: Tuple[str, ...] = ("pod", "data")  # combined FSDP/batch axes
TP_AXIS = "model"

# Sharding mode: "2d" = FSDP over data x TP over model (default); "zero3" =
# fold the model axis into FSDP too — no tensor parallelism, params and
# optimizer state sharded over every axis.
_MODE = {"mode": "2d"}
_MESHES: list = []  # the meshes of launch.mesh.mesh_context, innermost last


class P(tuple):
    """A partition spec: one entry a tensor dimension — ``None``, a mesh
    axis name or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def set_sharding_mode(mode: str) -> None:
    assert mode in ("2d", "zero3"), mode
    _MODE["mode"] = mode


def sharding_mode() -> str:
    return _MODE["mode"]


def data_axes() -> Tuple[str, ...]:
    if _MODE["mode"] == "zero3":
        return ("pod", "data", "model")
    return DATA_AXES


def tp_axis():
    return None if _MODE["mode"] == "zero3" else TP_AXIS


def abstract_mesh():
    """The current mesh (``launch.mesh.mesh_context``), or None."""
    return _MESHES[-1] if _MESHES else None


def mesh_axis_size(name: str) -> int:
    m = abstract_mesh()
    if m is None:
        return 1
    # a DeviceMesh's own shape: its ``mesh`` tensor is built anew on every
    # read, a fake one under FakeTensorMode (stand-ins carry only ``mesh``)
    shape = m.shape if hasattr(m, "shape") else m.mesh.shape
    return dict(zip(m.mesh_dim_names, shape)).get(name, 1)


def data_axes_in_mesh() -> Tuple[str, ...]:
    m = abstract_mesh()
    if m is None:
        return ()
    return tuple(a for a in DATA_AXES if a in m.mesh_dim_names)


def placements(mesh, spec) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    every mesh dimension that dimension ``d``'s entry names, ``Replicate``
    on the others.  Axes the mesh lacks are dropped; an entry of several
    axes (``("pod", "data")``) shards over them in mesh order, pod-major
    as in JAX."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        for a in (e if isinstance(e, (tuple, list)) else (e,)):
            if a in names:
                out[names.index(a)] = Shard(d)
    return out


def constrain(x, *spec_entries):
    """with_sharding_constraint's place: inside a ``mesh_context``, a
    ``DTensor`` redistributed to the placements of ``P(*spec_entries)``;
    otherwise ``x`` itself (see the module docstring).  A dimension its
    axes do not divide (a batch of one over the data axes) stays whole:
    GSPMD pads it, and DTensor refuses views of uneven shards."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = abstract_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    out = placements(mesh, spec_entries)
    for d in {p.dim for p in out if isinstance(p, Shard)}:
        n = 1
        for m, p in zip(mesh.shape, out):
            n *= m if p == Shard(d) else 1
        if x.shape[d] % n:
            out = [Replicate() if p == Shard(d) else p for p in out]
    return x.redistribute(mesh, out)


def constrain_like(x, ref):
    """``x`` laid out as ``ref`` when both are DTensors (a gradient as its
    parameter: the reduction of a partial sum), else ``x`` itself."""
    if not (_is_dtensor(x) and _is_dtensor(ref)):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


class _Pin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        ctx.mesh = x.device_mesh
        ctx.placements = [Replicate() if p.is_partial() else p
                          for p in x.placements]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def pin(x):
    """``x`` itself, forward; backward, a DTensor's gradient laid out as
    ``x`` is (a partial sum's whole), where DTensor would pass it back in
    whatever layout the later operators left it.  Any other tensor is
    returned as it is."""
    if abstract_mesh() is None or not _is_dtensor(x):
        return x
    return _Pin.apply(x)


class _DenseGrad(torch.autograd.Function):
    """``x`` itself, forward; backward, its gradient made contiguous.  A
    DTensor's ``to_local`` takes its gradient back under the forward's
    global strides, which a transposed local gradient would belie."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _shard(t, mesh, placements):
    """This rank's local tensor of ``t`` laid out as ``placements`` (a
    plain tensor counts as replicated), its gradient made contiguous."""
    from torch.distributed.tensor import DTensor, Replicate
    if not _is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return _DenseGrad.apply(t.redistribute(mesh, placements).to_local())


def local_map(fn, args, keep, out_keep):
    """``fn(*args)`` on each rank's own shards: a ``vmap`` over dimensions
    that ``fn`` treats row by row (a batch, attention's heads), as GSPMD
    runs such a function on the local shards of a sharded ``vmap``.

    ``keep[i]`` lists, in one logical order shared by every argument
    (batch first, then heads), the dimensions of each tensor of
    ``args[i]`` (a tensor or a tree of them) that may stay sharded;
    ``out_keep`` does so for every tensor of ``fn``'s outputs.  With a
    DTensor among ``args`` (inside a ``mesh_context``), the first
    DTensor's placements on its ``keep`` dimensions are the layout: each
    tensor argument is laid out so (a plain tensor counts as replicated;
    any other dimension is gathered, a partial sum reduced), ``fn`` runs
    on the local tensors, and its tensors come back, contiguous, as
    DTensors of that layout.  Otherwise it is ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils._pytree import tree_leaves, tree_map
    lead = next(((t, dims) for a, dims in zip(args, keep)
                 for t in tree_leaves(a) if _is_dtensor(t)), None)
    if abstract_mesh() is None or lead is None:
        return fn(*args)
    mesh = lead[0].device_mesh
    lead_dims = list(lead[1])
    logical = [lead_dims.index(p.dim)
               if isinstance(p, Shard) and p.dim in lead_dims else None
               for p in lead[0].placements]

    def layout(dims):
        return [Shard(dims[j]) if j is not None and j < len(dims)
                else Replicate() for j in logical]

    out = fn(*(tree_map(lambda t: _shard(t, mesh, layout(dims))
                        if isinstance(t, torch.Tensor) else t, a)
               for a, dims in zip(args, keep)))
    # contiguous: a DTensor's later views act on its local tensor
    return tree_map(lambda t: DTensor.from_local(
        t.contiguous(), mesh, layout(out_keep), run_check=False)
        if isinstance(t, torch.Tensor) else t, out)


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` of two operands; of a mesh's DTensors,
    each rank's product of its own shards, as GSPMD partitions a dot:
    on each mesh dimension, an index sharded in one operand is sharded
    the same way in the other where that one has it (its local chunk of
    a replicated operand; one of two different shards is gathered), and
    the product is sharded there, or a partial sum where the index is
    summed.  DTensor's own rule flattens batch indices, or views a local
    tensor laid out otherwise than its global one, and refuses some of
    these layouts."""
    if not (_is_dtensor(a) or _is_dtensor(b)) or abstract_mesh() is None:
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ins, out = eq.split("->")
    sa, sb = ins.split(",")
    mesh = (a if _is_dtensor(a) else b).device_mesh

    def placed(t):
        if not _is_dtensor(t):
            return [Replicate()] * mesh.ndim
        return [Replicate() if p.is_partial() else p for p in t.placements]

    pa, pb, po = placed(a), placed(b), []
    for m in range(mesh.ndim):
        la = sa[pa[m].dim] if isinstance(pa[m], Shard) else None
        lb = sb[pb[m].dim] if isinstance(pb[m], Shard) else None
        if la and lb and la != lb:
            pb[m], lb = Replicate(), None
        if la and not lb and la in sb:
            pb[m], lb = Shard(sb.index(la)), la
        if lb and not la and lb in sa:
            pa[m], la = Shard(sa.index(lb)), lb
        idx = la or lb
        po.append(Replicate() if idx is None
                  else Shard(out.index(idx)) if idx in out else Partial())

    y = torch.einsum(eq, _shard(a, mesh, pa), _shard(b, mesh, pb))
    size = {**dict(zip(sa, a.shape)), **dict(zip(sb, b.shape))}
    shape = torch.Size(size[i] for i in out)
    return DTensor.from_local(y.contiguous(), mesh, po, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def batch_spec(extra_dims: int = 1) -> P:
    return P(data_axes(), *([None] * extra_dims))


def head_axes(n_heads: int, head_dim: int) -> Tuple[Optional[str],
                                                     Optional[str]]:
    """(heads_axis, hd_axis) for activation tensors (B, S, H, hd)."""
    if tp_axis() is None:
        return None, None
    tp = mesh_axis_size(TP_AXIS)
    if tp == 1:
        return None, None
    if n_heads % tp == 0:
        return TP_AXIS, None
    if head_dim % tp == 0:
        return None, TP_AXIS
    return None, None


# ---------------------------------------------------------------------------
# Parameter specs (by tree path)
# ---------------------------------------------------------------------------

_FSDP = DATA_AXES  # shard the "d_model-like" dim over the combined data axes

# leaf-name -> spec for the *unstacked* rank (tiles add a leading None)
_RULES = {
    # (in_dim, out_dim): FSDP on in, TP on out
    r"(wq|wk|wv|w1|w3|w_x|w_gate|w_up|wq_x|router)$": P(_FSDP, TP_AXIS),
    r"(w_r|w_i)$": P(_FSDP, TP_AXIS),
    # (out_dim, d): TP on in, FSDP on out
    r"(wo|w2|w_down)$": P(TP_AXIS, _FSDP),
    # embeddings
    r"tok$": P(TP_AXIS, _FSDP),
    r"lm_head$": P(_FSDP, TP_AXIS),
    r"frontend_proj$": P(_FSDP, TP_AXIS),
    # biases on TP-sharded outputs
    r"(bq|bk|bv)$": P(TP_AXIS),
    # conv taps (W, dr)
    r"conv$": P(None, TP_AXIS),
    # small per-head / per-channel params: replicate
    r"(ln1|ln2|ln_x|norm|final_norm|enc_norm|q_norm|k_norm|lam|b_r|b_i|bf|bi)$": P(),
    r"(wi|wf)$": P(_FSDP, None),        # gate projections (d, n_heads)
    r"(rz|ri|rf|ro)$": P(),             # sLSTM block-diagonal recurrences
}

_MOE_RULES = {
    r"w1$": P(None, _FSDP, TP_AXIS),
    r"w3$": P(None, _FSDP, TP_AXIS),
    r"w2$": P(None, TP_AXIS, _FSDP),
    r"router$": P(_FSDP, None),
}


def _spec_for(path: str, ndim: int) -> P:
    # routed-expert weights are 3-D (E, in, out); the shared-expert MLP under
    # moe/shared/ is a plain dense block and takes the dense rules
    is_routed = "/moe/" in path and "/shared/" not in path
    rules = _MOE_RULES if is_routed else _RULES
    stacked = path.startswith("tiles/") or path.startswith("enc_tiles/")
    for pat, spec in rules.items():
        if re.search(pat, path):
            entries = list(spec)
            if stacked:
                entries = [None] + entries
            # pad/truncate to rank
            while len(entries) < ndim:
                entries.append(None)
            return P(*entries[:ndim])
    # default: replicate
    return P(*([None] * ndim))


def _apply_mode(spec: P) -> P:
    """Rewrite a rule spec for the active sharding mode."""
    if _MODE["mode"] == "2d":
        return spec
    out = []
    for e in spec:
        if e == TP_AXIS:
            out.append(None)           # no tensor parallelism in zero3
        elif isinstance(e, (tuple, list)) and tuple(e) == tuple(DATA_AXES):
            out.append(data_axes())    # FSDP over every axis
        else:
            out.append(e)
    return P(*out)


def param_specs(params):
    """Mirror the parameter tree with :class:`P` specs (shapes only: fake
    or meta tensors will do)."""

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        return _apply_mode(_spec_for(prefix, tree.dim()))

    return walk(params, "")


def cache_spec(cfg, cache):
    """Decode-cache specs: batch over data axes; heads or head_dim over TP."""
    h_ax, hd_ax = head_axes(cfg.n_kv_heads, cfg.hd)

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        nd = tree.dim()
        lead = [None] if prefix.startswith("tiles/") else []
        body = nd - len(lead)
        name = prefix.rsplit("/", 1)[-1]
        if name in ("k", "v", "xk", "xv"):        # (B, S, Hkv, hd)
            return P(*lead, data_axes(), None, h_ax, hd_ax)
        if name == "slot_pos":                     # (W,)
            return P(*lead, None)
        if name == "C":                            # (B, H, dh, dh)
            return P(*lead, data_axes(), None, None, None)
        if name in ("n", "conv"):                  # (B, H, dh) / (B, W-1, dr)
            return P(*lead, data_axes(), *([None] * (body - 1)))
        if name in ("h", "c", "m"):                # (B, d)
            return P(*lead, data_axes(), *([None] * (body - 1)))
        if name == "pos":
            return P()
        return P(*([None] * nd))

    return walk(cache, "")


# ---------------------------------------------------------------------------
# Fleet lane partitioning (ASC-Hook fleet engine)
# ---------------------------------------------------------------------------

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
