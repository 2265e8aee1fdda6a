"""The megastep wrapper and its run / span drivers.

:func:`megastep_chunk` is the one entry to the kernel: for CPU tensors it
runs the plain version (:mod:`.ref`); for CUDA tensors it launches the
CUDA kernel (:mod:`.kernel`) or raises — there is no fallback.  Either way
the carry (and the trace carry, when given) is updated in place and
returned.  ``megastep_chunk.launches`` counts kernel launches (it stays 0
on the CPU).

:func:`run` and :func:`span` mirror the JAX package's ``jitted_run`` /
``jitted_span`` and their traced twins: they check the operands once,
build the kernel's arguments once (the carry is updated in place, so its
pointers hold), then loop chunks while any lane is alive (one host sync
per chunk); ``run`` patches ``HALT_FUEL`` afterwards, ``span`` stops
after at most ``span`` chunks and does not.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import fleet as F
from ...core import layout as L
from ...core.machine import MachineState
from .ref import megastep_chunk_ref

_TRAILING = {"regs": (31,), "mem": (L.MEM_WORDS,),
             "k_ino_data": (L.MAX_INODES * L.FILE_WORDS,)}
_TRAILING.update({f: (L.MAX_FDS,) for f in (
    "k_fd_ofd", "k_ofd_kind", "k_ofd_ino", "k_ofd_off", "k_ofd_flags",
    "k_ofd_ref")})
_TRAILING.update({f: (L.MAX_INODES,) for f in (
    "k_ino_kind", "k_ino_name", "k_ino_size")})


def _check_tensor(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, the carry is on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _validate(imgs: F.FleetImages, ids, s: MachineState,
              tr: Optional[F.TraceState], chunk: int, block: Optional[int]):
    """Types, shapes, devices and contiguity: no host sync."""
    if not isinstance(s, MachineState):
        raise TypeError("s must be a MachineState")
    dev = s.pc.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    B = int(s.pc.shape[0]) if s.pc.dim() == 1 else -1
    if B < 1:
        raise ValueError("the carry must be batched: leaves [B, ...], B >= 1")
    for name, leaf in zip(MachineState._fields, s):
        _check_tensor(name, leaf, torch.int64,
                      (B,) + _TRAILING.get(name, ()), dev)
    G = int(imgs.packed.shape[0]) if imgs.packed.dim() == 2 else 0
    for name in ("packed", "imm"):
        _check_tensor(name, getattr(imgs, name), torch.int64,
                      (G, L.CODE_WORDS), dev)
    _check_tensor("ids", ids, torch.int32, (B,), dev)
    if int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if block is not None and not 1 <= int(block) <= 32:
        raise ValueError(f"block must be in [1, 32] lanes, got {block}")
    if tr is None:
        return
    if not isinstance(tr, F.TraceState):
        raise TypeError("tr must be a TraceState")
    cap = int(tr.buf.shape[2]) if tr.buf.dim() == 4 else 0
    if cap < 1:
        raise ValueError("tr.buf must be [B, 2, CAP, REC_WORDS], CAP >= 1")
    shapes = {"buf": (B, 2, cap, F.REC_WORDS),
              "hist": (B, F.N_POLICY_SLOTS, F.N_VERDICTS),
              "pol_action": (B, F.N_POLICY_SLOTS),
              "pol_arg": (B, F.N_POLICY_SLOTS)}
    for name, leaf in zip(F.TraceState._fields, tr):
        _check_tensor(f"tr.{name}", leaf,
                      torch.int32 if name == "pol_action" else torch.int64,
                      shapes.get(name, (B,)), dev)


def _check_ids(imgs: F.FleetImages, ids):
    """Image ids in range: one host sync."""
    G = int(imgs.packed.shape[0])
    if bool(((ids < 0) | (ids >= G)).any()):
        raise ValueError(f"ids must index the {G} image rows")


def megastep_chunk(imgs: F.FleetImages, ids: torch.Tensor, s: MachineState,
                   tr: Optional[F.TraceState] = None, *, chunk: int,
                   block: Optional[int] = None):
    """``chunk`` masked fleet steps for every lane, in place.

    Bit-identical to ``chunk`` iterations of the JAX package's
    ``fleet._step_core``, with the guest-kernel service on the lanes that
    have it enabled and, with ``tr``, the trace ring and policy gate.
    ``block`` is the kernel's lanes per block (one warp a lane; the JAX
    package's meaning); the plain version ignores it.  Returns ``s``, or
    ``(s, tr)`` with a trace carry.
    """
    _validate(imgs, ids, s, tr, chunk, block)
    _check_ids(imgs, ids)
    return _chunk(imgs, ids, s, tr, int(chunk), block)


def _chunk(imgs, ids, s, tr, chunk, block, launch=None):
    """One chunk on checked operands: the plain version on the CPU, one
    counted kernel launch on the card (``launch``: the kernel's arguments
    for this carry, when the caller built them already)."""
    if s.pc.device.type == "cpu":
        out = megastep_chunk_ref(imgs, ids, s, tr, chunk=chunk)
        pairs = zip(s, out) if tr is None else zip(
            (*s, *tr), (*out[0], *out[1]))
        for dst, src in pairs:
            if src is not dst:
                dst.copy_(src)
    else:
        if launch is None:
            launch = _launch(imgs, ids, s, tr, chunk)
        launch(block)
        megastep_chunk.launches += 1
    return s if tr is None else (s, tr)


def _launch(imgs, ids, s, tr, chunk):
    """The kernel's arguments for this carry on the card, else None."""
    if s.pc.device.type == "cpu":
        return None
    from .kernel import Launch  # lazy: builds at first use
    return Launch(imgs, ids, s, tr, chunk=chunk)


megastep_chunk.launches = 0


def run(imgs: F.FleetImages, ids: torch.Tensor, s: MachineState,
        tr: Optional[F.TraceState] = None, *, chunk: int,
        block: Optional[int] = None):
    """Run every lane to halt (or out of fuel, patched to HALT_FUEL).
    Returns ``s``, or ``(s, tr)`` with a trace carry."""
    _validate(imgs, ids, s, tr, chunk, block)
    _check_ids(imgs, ids)
    launch = _launch(imgs, ids, s, tr, int(chunk))
    while bool(F._alive(s).any()):
        _chunk(imgs, ids, s, tr, int(chunk), block, launch)
    s.halted.copy_(F._patch_fuel(s).halted)
    return s if tr is None else (s, tr)


def span(imgs: F.FleetImages, ids: torch.Tensor, s: MachineState,
         tr: Optional[F.TraceState] = None, *, chunk: int, span: int,
         block: Optional[int] = None):
    """At most ``span`` chunks, early exit when every lane halts; no
    HALT_FUEL patch.  Returns ``s``, or ``(s, tr)`` with a trace carry."""
    _validate(imgs, ids, s, tr, chunk, block)
    _check_ids(imgs, ids)
    launch = _launch(imgs, ids, s, tr, int(chunk))
    k = 0
    while k < span and bool(F._alive(s).any()):
        _chunk(imgs, ids, s, tr, int(chunk), block, launch)
        k += 1
    return s if tr is None else (s, tr)
