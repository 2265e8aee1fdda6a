"""The counterpart of the JAX package's ``launch/hloanalysis.py``: a
per-rank roofline read from the operators a traced step runs.

The port has no HLO.  :func:`analyze` runs ``fn`` once under one
``TorchDispatchMode`` and counts what this rank executes:

* the mode returns ``NotImplemented`` for any call whose types include
  ``DTensor`` (as ``torch.distributed.tensor.debug.CommDebugMode``
  does), so DTensor splits the call into this rank's local operators and
  the collectives it issues, and the mode sees those.  DTensor also runs
  each new operator once on fake tensors of the *global* shape, to learn
  its output's shape (``ShardingPropagator._propagate_tensor_meta``);
  ``FakeTensorMode`` runs after every user mode, so this mode would see
  those calls too: they are not counted;
* loops: eager code runs every iteration, a checkpoint's recompute
  included, but a loop over time (:func:`repro_torch.loops.time_loop`:
  the sLSTM's steps, the chunked mLSTM's chunks) is counted as
  ``hloanalysis`` multiplies a ``while`` body by its trip count: the
  steps run one by one until the carry's layout repeats, then one step
  stands for the m steps before the last, its operators' dot FLOPs,
  bytes and collectives counted m times, and its backward too (an
  autograd function around the step whose backward runs under the same
  multiplier and adds each read tensor's gradient m - 1 more times, as
  the eager loop's accumulation does), then the last step runs: the
  eager loop's count exactly, from a few traced steps.  Live bytes: the
  repeated step's growth (what the loop keeps of a step: the tensors
  its backward saves, its y) is held m - 1 more times until the step's
  y dies.  ``while_trips`` lists the trip count of each loop of more
  than one step, once a run (forward, recompute) and once the backward
  of a counted step;
* **dot FLOPs** by ``torch.utils.flop_counter``'s formulas (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, convolution, SDPA): XLA's ``dot``
  count, equal to the JAX package's one-device HLO count;
* **HBM bytes**: operand plus output bytes of every local operator that
  moves data; the view and metadata operators (:data:`_SKIP_MEM`) are
  skipped, as JAX skips ``parameter``/``bitcast``/``get-tuple-element``.
  An eager program has no fusion, so this is the unfused traffic the port
  really issues: larger than JAX's fused count and not compared with it.
  ``mem_by_kind`` is keyed by aten operator name;
* **collectives**: ``_c10d_functional``'s ``all_reduce``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
  ``all_to_all_single`` (and the ``c10d`` forms) under JAX's kinds, the
  group size read from the operator's group, payload bytes and ring wire
  bytes (:func:`_ring_wire_bytes`, JAX's), per group size;
* **live bytes**: the peak of the storage bytes alive on the rank,
  arguments included (JAX's argument + temp + output - alias), by a
  tracker of its own: a storage's bytes are added when an operator first
  returns it and taken off by ``weakref.finalize`` when it dies.
  (``torch.distributed._tools.mem_tracker.MemTracker`` sees a DTensor
  call's global operator, not the rank's.)

:class:`Hardware` holds the H100's datasheet figures, not measurements.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .. import loops

COLLECTIVE_KINDS = {"all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute"}

_SKIP_MEM = {f"aten::{n}" for n in (
    "view", "_unsafe_view", "reshape", "_reshape_alias", "t", "transpose",
    "permute", "expand", "slice", "select", "squeeze", "unsqueeze",
    "as_strided", "alias", "detach", "split", "split_with_sizes", "chunk",
    "unbind", "narrow", "diagonal", "lift_fresh", "empty", "empty_strided",
    "empty_like", "new_empty", "new_empty_strided")} | {
    "_c10d_functional::wait_tensor"}

# operator name -> JAX's collective kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}


@dataclasses.dataclass
class CollectiveStat:
    count: int = 0
    payload_bytes: int = 0   # operand bytes per execution
    wire_bytes: int = 0      # ring-scaled bytes serialised on links


@dataclasses.dataclass
class OpStats:
    dot_flops: int = 0
    mem_bytes: int = 0
    collectives: Dict[str, CollectiveStat] = dataclasses.field(
        default_factory=dict)
    by_group_size: Dict[int, int] = dataclasses.field(default_factory=dict)
    mem_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0      # live storage bytes at their peak
    argument_bytes: int = 0  # live at the start (the arguments)
    while_trips: list = dataclasses.field(default_factory=list)

    @property
    def collective_wire_bytes(self) -> int:
        return sum(c.wire_bytes for c in self.collectives.values())

    @property
    def collective_payload_bytes(self) -> int:
        return sum(c.payload_bytes for c in self.collectives.values())


def _ring_wire_bytes(kind: str, operand_bytes: int, out_bytes: int,
                     n: int) -> int:
    """Per-device bytes serialised on links for ring algorithms."""
    if n <= 1:
        return 0
    if kind == "all-reduce":
        return int(2 * (n - 1) / n * operand_bytes)
    if kind == "all-gather":
        return int((n - 1) / n * out_bytes)
    if kind == "reduce-scatter":
        return int((n - 1) / n * operand_bytes)
    if kind == "all-to-all":
        return int((n - 1) / n * operand_bytes)
    if kind == "collective-permute":
        return operand_bytes
    return operand_bytes


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_size(args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    flat = list(args) + list(kwargs.values())
    names = [a for a in flat if isinstance(a, str)]
    if names:  # _c10d_functional: the group's name is its last string
        return _resolve_process_group(names[-1]).size()
    for a in flat:  # c10d: the ProcessGroup object
        if isinstance(a, torch.ScriptObject) and hasattr(a, "size"):
            return int(a.size())
    raise ValueError("a collective without a group")


def _local(t):
    """The rank's own tensor of ``t`` (a DTensor's local shard)."""
    return getattr(t, "_local_tensor", t)


class _Counter(TorchDispatchMode):
    def __init__(self, stats: OpStats):
        super().__init__()
        self.stats = stats
        self.live: Dict[int, int] = {}   # id(storage) -> bytes
        self.now = 0
        self.paused = 0  # inside DTensor's global-shape meta propagation
        self.mult = 1    # executions each operator stands for (time_loop)

    # -- live bytes ---------------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.now += n
        self.stats.peak_bytes = max(self.stats.peak_bytes, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def hold(self, nbytes: int, t: torch.Tensor) -> None:
        """``nbytes`` more live bytes until ``t``'s storage dies."""
        self.now += nbytes
        self.stats.peak_bytes = max(self.stats.peak_bytes, self.now)
        weakref.finalize(_local(t).untyped_storage(), self._release, nbytes)

    def _release(self, nbytes: int) -> None:
        self.now -= nbytes

    @contextlib.contextmanager
    def times(self, n: int):
        """Count each operator inside as ``n`` executions."""
        prev = self.mult
        self.mult = prev * n
        try:
            yield
        finally:
            self.mult = prev

    # -- a loop over time ---------------------------------------------------
    def time_loop(self, step, carry, consts, n: int):
        """:func:`loops.time_loop`, counted (the module docstring): the
        steps one at a time until the carry's layout repeats, then one
        step standing for all but the last, then the last."""
        if n > 1:
            self.stats.while_trips.append(n)
        ys, t, prev, growth = [], 0, None, None
        while t < n:
            m = n - t - 1
            if growth is not None and m > 1:
                carry, y = self._repeat(step, consts, carry, t, m, n)
                ys += [y] * m
                self.hold((m - 1) * growth, y)
                t, growth = t + m, None
                continue
            before = self.now
            carry, y = step(consts, carry, t)
            ys.append(y)
            t += 1
            lay = _layout(carry)
            if lay == prev:
                growth = self.now - before
            prev = lay
        return carry, ys

    def _repeat(self, step, consts, carry, t: int, m: int, n: int):
        """Step ``t`` counted ``m`` times: (carry, y)."""
        nc, at = len(consts), []

        def fn(flat):
            c, y = step(tuple(flat[:nc]), tuple(flat[nc:]), t)
            # y, when it is a tensor of the carry, is not a second output
            # (its gradient would be added once more a step)
            at[:] = [i for i, x in enumerate(c) if x is y] or [len(c)]
            return tuple(c) + ((y,) if at[0] == len(c) else ())

        flat = list(consts) + list(carry)
        if torch.is_grad_enabled() and any(x.requires_grad for x in flat):
            outs = _Repeat.apply((self, m, n, nc, fn), *flat)
        else:
            with self.times(m):
                outs = fn(flat)
        return tuple(outs[:len(carry)]), outs[at[0]]

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        s, k = self.stats, self.mult
        packet = func._overloadpacket
        if packet in flop_registry:
            s.dot_flops += k * int(flop_registry[packet](*args, **kwargs,
                                                         out_val=out))
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        if packet._qualified_op_name in _SKIP_MEM or not outs:
            return out
        in_b, out_b = _nbytes((args, kwargs)), _nbytes(out)
        s.mem_bytes += k * (in_b + out_b)
        name = packet.__name__
        s.mem_by_kind[name] = s.mem_by_kind.get(name, 0) + k * (in_b + out_b)
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            n = _group_size(args, kwargs)
            payload = _nbytes(args[0])
            cs = s.collectives.setdefault(kind, CollectiveStat())
            cs.count += k
            cs.payload_bytes += k * payload
            wire = _ring_wire_bytes(kind, payload, out_b, n)
            cs.wire_bytes += k * wire
            s.by_group_size[n] = s.by_group_size.get(n, 0) + k * wire
        return out


def _layout(tree) -> tuple:
    """Shapes, dtypes and DTensor placements of a carry."""
    return tuple((tuple(t.shape), t.dtype, tuple(getattr(t, "placements",
                                                         ())))
                 for t in _tensors(tree))


def _same(t):
    return t


class _Repeat(torch.autograd.Function):
    """A step of a counted loop that stands for ``m``: its forward and
    its backward each run once, under the counter's multiplier ``m``; an
    input the eager loop reads every step (``consts``) has its gradient
    added ``m - 1`` more times, as the eager loop's accumulation of ``m``
    contributions does."""

    @staticmethod
    def forward(ctx, info, *flat):
        counter, m, n, nc, fn = info
        ctx.set_materialize_grads(False)
        ctx.info = info
        ctx.leaves = [x.detach().requires_grad_(x.requires_grad)
                      for x in flat]
        # the step's saved tensors are its own graph's: a checkpoint's
        # hooks around the loop would recompute the block for this graph
        # too (another graph task)
        with torch.enable_grad(), counter.times(m), \
                torch.autograd.graph.saved_tensors_hooks(_same, _same):
            ctx.outs = fn(ctx.leaves)
        return tuple(o.detach() for o in ctx.outs)

    @staticmethod
    def backward(ctx, *grads):
        counter, m, n, nc, fn = ctx.info
        counter.stats.while_trips.append(n)
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if g is not None and o.requires_grad]
        need = [i for i, x in enumerate(ctx.leaves) if x.requires_grad]
        out = [None] * len(ctx.leaves)
        if pairs and need:
            with counter.times(m):
                got = torch.autograd.grad(
                    [o for o, _ in pairs], [ctx.leaves[i] for i in need],
                    [g for _, g in pairs], allow_unused=True)
            for i, g in zip(need, got):
                out[i] = g
            with counter.times(m - 1):  # the eager loop's accumulation
                for g in out[:nc]:
                    if g is not None:
                        g + g  # an addition of the gradient's layout
        del ctx.outs, ctx.leaves
        return (None, *out)


def analyze(fn, *args, **kwargs) -> OpStats:
    """Run ``fn(*args, **kwargs)`` once and count what this rank ran (see
    the module docstring).  The tensors of the arguments (a DTensor's
    local shard) count as live from the start."""
    stats = OpStats()
    counter = _Counter(stats)
    for t in _tensors((args, kwargs)):
        counter.track(_local(t))
    stats.argument_bytes = counter.now
    loops.HOOK[0] = counter.time_loop
    try:
        with _unseen_meta_propagation(counter), counter:
            fn(*args, **kwargs)
    finally:
        loops.HOOK[0] = None
    return stats


@contextlib.contextmanager
def _unseen_meta_propagation(counter: _Counter):
    """Pause ``counter`` while DTensor runs an operator on global-shaped
    fake tensors to propagate its output's metadata."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    inner = prop._propagate_tensor_meta_non_cached

    def paused(op_schema):
        counter.paused += 1
        try:
            return inner(op_schema)
        finally:
            counter.paused -= 1

    own = vars(prop).get("_propagate_tensor_meta_non_cached")
    prop._propagate_tensor_meta_non_cached = paused
    try:
        yield
    finally:
        if own is None:
            del prop._propagate_tensor_meta_non_cached  # the class's own
        else:
            prop._propagate_tensor_meta_non_cached = own


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Hardware:
    """The NVIDIA H100 SXM5 80GB at its 700 W power limit ("NVIDIA H100
    80GB HBM3", as ``nvidia-smi --query-gpu=name,power.limit`` names it),
    from its datasheet: dense bf16 tensor-core peak and HBM3 bandwidth.
    ``ici_bw`` keeps the JAX package's field name for the rank's link to
    the rest of its group: one GPU's 400 Gb/s NDR InfiniBand port
    (50 GB/s), since every group of the production meshes (16 and 256
    ranks) spans more than one 8-GPU NVLink node, so a ring over it runs
    at the NIC."""
    peak_flops: float = 989.4e12     # bf16 FLOP/s per GPU, dense
    hbm_bw: float = 3.35e12          # B/s per GPU
    ici_bw: float = 50e9             # B/s per GPU's network port


HW = Hardware()


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dot_flops: int
    mem_bytes: int
    wire_bytes: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant,
                "dot_flops": self.dot_flops, "mem_bytes": self.mem_bytes,
                "wire_bytes": self.wire_bytes}


def roofline_terms(stats: OpStats, hw: Hardware = HW) -> Roofline:
    """Per-rank seconds of each term."""
    return Roofline(
        compute_s=stats.dot_flops / hw.peak_flops,
        memory_s=stats.mem_bytes / hw.hbm_bw,
        collective_s=stats.collective_wire_bytes / hw.ici_bw,
        dot_flops=stats.dot_flops,
        mem_bytes=stats.mem_bytes,
        wire_bytes=stats.collective_wire_bytes,
    )
