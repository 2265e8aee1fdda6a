"""ASC-Hook for per-rank distributed programs: transparent collective
interception (the JAX package's ``repro.hooks.interceptor``).

The "privileged boundary" of a distributed training step is its
**collectives**.  The JAX package intercepts them at trace time by
rebinding the collective primitives' ``bind``, the lowest layer every
caller passes through.  In PyTorch that layer is the dispatcher's
``c10d::*`` and ``_c10d_functional::*`` operators: ``dist.all_reduce``,
the functional collectives, DDP's reducer and library code written in
C++ all reach them.  So the hook is a ``TorchDispatchMode`` entered while
a hook context is active — the moral equivalent of ASC-Hook's load-time
rewrite: user code is not modified, every collective the dispatcher runs
on this thread (and on the autograd threads its backward passes start,
which inherit the mode) is routed through a per-kind trampoline, and the
original operator can be re-executed from inside the hook (the displaced
instruction).  A patch of ``torch.distributed``'s Python functions would
miss names bound with ``from torch.distributed import all_reduce`` and
every C++ caller.  The price of the layer: a dispatch mode sees every
operator, so while hooking each of the program's operators takes one
Python call more.

Faithfulness properties carried over from the paper:

* **transparency** — the trampoline checks that a handler's outputs have
  the shapes and dtypes the original operator writes or returns; the
  operator's own return value (its ``Work`` for a ``c10d`` operator) is
  always built by the trampoline, so a pure pass-through handler runs the
  same operators on the same tensors (tested);
* **no recursive interception** — handlers run inside a re-entrancy
  guard, the analogue of loading the hook library with ``dlmopen`` into a
  separate namespace (§3.4): collectives issued *by the handler* run
  natively;
* **completeness accounting** — the census of what the hook saw
  (scanner.py) against the backend's own record of what it ran
  (completeness.py) exposes every collective the hook cannot see: one
  issued on a thread the mode was not entered on, one issued before the
  context, a kind with no entry here (a barrier, a broadcast) — the
  paper's indirect-jump case.

A collective runs in order with its caller's stream: ``do_original``
waits on the operator's ``Work`` (or ``wait_tensor``s a functional
result) before it returns, which on the card orders the caller's stream
after the backend's, as the caller's own ``Work.wait()`` would; the
caller's later wait is then a no-op.  (A backend that already ran a
blocking collective in order with the caller's stream returns an empty
``Work``, which is passed on as it came.)

The JAX package's ``_in_legacy_rewrite``/``_REWRITE_FRAMES`` guard its
trace-time hook against the re-interpretation that older jax versions'
shard_map does; an eager dispatch has no such second pass, so they have
no counterpart here.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode


class _Op(NamedTuple):
    kind: str              # all_reduce | all_gather | reduce_scatter | all_to_all
    inp: str               # the schema argument that holds the payload
    out: Optional[str]     # the buffer the operator writes, if not ``inp``
    in_place: bool         # the operator writes its payload argument


# The syscall table of this world: the operators this torch has, by
# qualified name.  Names move between releases, so bind whatever exists
# and skip the rest, as the JAX package does with its primitives.
_OP_TABLE = {
    "c10d::allreduce_": _Op("all_reduce", "tensors", None, True),
    "c10d::_allgather_base_": _Op("all_gather", "input_tensor",
                                  "output_tensor", False),
    "c10d::_reduce_scatter_base_": _Op("reduce_scatter", "input_tensor",
                                       "output_tensor", False),
    "c10d::alltoall_base_": _Op("all_to_all", "input", "output", False),
    "_c10d_functional::all_reduce": _Op("all_reduce", "input", None, False),
    "_c10d_functional::all_reduce_": _Op("all_reduce", "input", None, True),
    "_c10d_functional::all_gather_into_tensor": _Op("all_gather", "input",
                                                    None, False),
    "_c10d_functional::reduce_scatter_tensor": _Op("reduce_scatter",
                                                   "input", None, False),
    "_c10d_functional::all_to_all_single": _Op("all_to_all", "input", None,
                                               False),
}

# reductions an all-reduce can carry -> the JAX primitive's name; other
# reductions (average, product, bitwise) have no primitive and run
# natively, unhooked (the completeness check counts them)
_REDUCTIONS = {"SUM": "psum", "MAX": "pmax", "MIN": "pmin"}


def _operator(qualified: str):
    ns, name = qualified.split("::")
    try:
        return getattr(getattr(torch.ops, ns), name).default
    except (AttributeError, RuntimeError):
        return None


_OPS = {op: spec for op, spec in ((_operator(q), s)
                                  for q, s in _OP_TABLE.items())
        if op is not None}

# JAX primitive name -> the operators of this torch that can carry it
# (there is no single operator for a send/recv pair, so no ppermute)
COLLECTIVE_PRIMS: Dict[str, Tuple[str, ...]] = {}
for _op, _spec in _OPS.items():
    for _name in (tuple(_REDUCTIONS.values()) if _spec.kind == "all_reduce"
                  else (_spec.kind,)):
        COLLECTIVE_PRIMS.setdefault(_name, ())
        COLLECTIVE_PRIMS[_name] += (_op.name(),)

# Handler signature: (prim_name, args, params, do_original) -> outputs,
# args the payload tensors; do_original(*new_args, **overrides) re-executes
# the original operator (the displaced instruction) on new payloads.
Handler = Callable[..., Any]


class _State(threading.local):
    def __init__(self):
        self.in_handler = False


_STATE = _State()


def _completed_work():
    fut = torch.futures.Future()
    fut.set_result(None)
    return torch._C._distributed_c10d._create_work_from_future(fut).boxed()


def _reduction(value) -> str:
    if isinstance(value, str):
        return value.upper()
    return dist.ReduceOp.RedOpType(value.op()).name


def _group(bound: dict):
    if "process_group" in bound:
        return dist.ProcessGroup.unbox(bound["process_group"])
    name = bound["group_name"]
    if isinstance(name, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(name)
    return name


def _out_shape(kind: str, x: torch.Tensor, n: int, bound: dict) -> tuple:
    """The shape an operator of ``kind`` gives for payload ``x`` over a
    group of ``n`` ranks."""
    lead = x.shape[0] if x.dim() else 1
    if kind == "all_gather":
        lead *= n
    elif kind == "reduce_scatter":
        lead //= n
    elif kind == "all_to_all" and bound.get("output_split_sizes"):
        lead = sum(bound["output_split_sizes"])
    else:
        return tuple(x.shape)
    return (lead,) + tuple(x.shape[1:])


class _Call:
    """One intercepted operator call, its schema arguments by name."""

    def __init__(self, func, spec: _Op, args, kwargs):
        self.func, self.spec = func, spec
        self.names = [a.name for a in func._schema.arguments]
        self.bound = dict(zip(self.names, args))
        self.bound.update(kwargs)
        payload = self.bound[spec.inp]
        self.listed = isinstance(payload, (list, tuple))
        self.payload = tuple(payload) if self.listed else (payload,)
        self.group = _group(self.bound)
        self.work = None
        # the JAX primitive's name (None: a reduction JAX has no primitive
        # for, which runs natively)
        self.name = (_REDUCTIONS.get(_reduction(self.bound["reduce_op"]))
                     if spec.kind == "all_reduce" else spec.kind)

    @property
    def params(self) -> dict:
        p = {"op": self.func.name(), "group": self.group,
             "axis_size": self.group.size()}
        if "reduce_op" in self.bound:
            p["reduce_op"] = _reduction(self.bound["reduce_op"])
        return p

    def expected(self) -> tuple:
        """(shape, dtype) of each tensor the operator writes or returns."""
        n = self.group.size()
        return tuple((_out_shape(self.spec.kind, x, n, self.bound), x.dtype)
                     for x in self.payload)

    def _run(self, bound: dict):
        pos = []
        for k in self.names:          # positional up to the first default
            if k not in bound:
                break
            pos.append(bound[k])
        res = self.func(*pos, **{k: bound[k] for k in self.names[len(pos):]
                                 if k in bound})
        if self.func.namespace == "_c10d_functional":
            with torch._C._DisableTorchDispatch():
                torch.ops._c10d_functional.wait_tensor(res)
            return (res,)
        work = res[1] if isinstance(res, (tuple, list)) else res
        # a backend that ran the collective in order with the caller's
        # stream (NCCL, not async_op) returns no Work: nothing to wait on
        unboxed = dist.Work.unbox(work) if work is not None else None
        if unboxed is not None:
            unboxed.wait()
        self.work = work
        if self.spec.out is not None:
            return (bound[self.spec.out],)
        return tuple(bound[self.spec.inp]) if self.listed else (
            bound[self.spec.inp],)

    def original(self, *new_args, **overrides):
        """Run the operator natively, on ``new_args`` when given (fresh
        output buffers of their dtype), else on the caller's own tensors;
        one tensor, or a tuple for a payload of several."""
        bound = {**self.bound, **overrides}
        if new_args and not all(a is b for a, b in zip(new_args,
                                                        self.payload)):
            if len(new_args) != len(self.payload):
                raise TypeError(f"{self.name}: {len(new_args)} payloads "
                                f"for {len(self.payload)}")
            bound[self.spec.inp] = list(new_args) if self.listed else (
                new_args[0])
            if self.spec.out is not None:
                x = new_args[0]
                shape = _out_shape(self.spec.kind, x, self.group.size(),
                                   bound)
                bound[self.spec.out] = x.new_empty(shape)
        outs = self._run(bound)
        return outs if len(outs) > 1 else outs[0]

    def finish(self, outs):
        """What the operator returns to its caller, ``outs`` written
        into the caller's buffers."""
        spec = self.spec
        dests = ((self.bound[spec.out],) if spec.out is not None else
                 self.payload if spec.in_place else None)
        if dests is None:                      # a functional result
            return outs[0]
        for d, o in zip(dests, outs):
            if o is not d:
                d.copy_(o)
        if self.func.namespace == "_c10d_functional":
            return dests[0]
        work = self.work if self.work is not None else _completed_work()
        if len(self.func._schema.returns) == 1:
            return work
        first = list(dests) if self.listed else dests[0]
        return first, work


class _HookMode(TorchDispatchMode):
    """The trampoline: every operator of the program passes through; a
    collective of this table goes to its handler."""

    def __init__(self, handlers: Dict[str, Handler]):
        super().__init__()
        self.handlers = handlers
        self.dispatched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.dispatched += 1
        spec = _OPS.get(func)
        if spec is None or _STATE.in_handler:
            return func(*args, **kwargs)
        call = _Call(func, spec, args, kwargs)
        handler = self.handlers.get(call.name) if call.name else None
        # the innermost hook decides: outer hooks see the native call
        _STATE.in_handler = True
        try:
            if handler is None:
                return func(*args, **kwargs)
            out = handler(call.name, call.payload, call.params,
                          call.original)
        finally:
            _STATE.in_handler = False
        outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        ref = call.expected()
        got = tuple((tuple(o.shape), o.dtype) for o in outs)
        if got != ref:
            raise TypeError(
                f"hook handler for {call.name} broke transparency: "
                f"expected {ref}, got {got}")
        return call.finish(outs)


@contextlib.contextmanager
def hooking(handlers: Dict[str, Handler]):
    """Intercept the collectives dispatched while the context is active.

    Keys are the JAX primitives' names: "psum", "pmax", "pmin" (an
    all-reduce by its reduction), "all_gather", "reduce_scatter",
    "all_to_all".  Yields the mode; its ``dispatched`` counts the
    operators it saw.
    """
    with _HookMode(dict(handlers)) as mode:
        yield mode


def hook_collectives(fn: Callable, handlers: Dict[str, Handler]) -> Callable:
    """Return fn with its collectives routed through ``handlers``.

    Everything the wrapped function dispatches — in any nesting of
    library code, autograd's backward, DDP's reducer — is intercepted.
    This is the "LD_PRELOAD entry point" of the adaptation.
    """
    def wrapped(*args, **kwargs):
        with hooking(handlers):
            return fn(*args, **kwargs)

    return wrapped
