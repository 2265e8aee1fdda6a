"""The megastep wrapper and its run / span drivers.

:func:`megastep_chunk` is the one entry to the kernel: for CPU tensors it
runs the plain version (:mod:`.ref`); for CUDA tensors it launches the
CUDA kernel (:mod:`.kernel`) or raises — there is no fallback.  Either way
the carry is updated in place and returned.  ``megastep_chunk.launches``
counts kernel launches (it stays 0 on the CPU).

:func:`run` and :func:`span` mirror the JAX package's ``jitted_run`` /
``jitted_span``: they loop chunks while any lane is alive (one host sync
per chunk); ``run`` patches ``HALT_FUEL`` afterwards, ``span`` stops after
at most ``span`` chunks and does not.
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


def _validate(imgs: F.FleetImages, ids, s: MachineState, chunk: int,
              block: Optional[int]):
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
    if block is not None and not 1 <= int(block) <= 1024:
        raise ValueError(f"block must be in [1, 1024], got {block}")
    bad_ids, emul_on = (torch.stack([(ids < 0).any() | (ids >= G).any(),
                                     (s.k_enabled != 0).any()]).tolist())
    if bad_ids:
        raise ValueError(f"ids must index the {G} image rows")
    if emul_on:
        raise NotImplementedError(F._EMUL_HINT)


def megastep_chunk(imgs: F.FleetImages, ids: torch.Tensor, s: MachineState,
                   *, chunk: int, block: Optional[int] = None
                   ) -> MachineState:
    """``chunk`` masked fleet steps for every lane, in place.

    Bit-identical to ``chunk`` iterations of the JAX package's
    ``fleet._step_core`` on untraced, emulation-off lanes.  ``block`` is
    the kernel's threads (lanes) per block; the plain version ignores it.
    """
    _validate(imgs, ids, s, chunk, block)
    if s.pc.device.type == "cpu":
        out = megastep_chunk_ref(imgs, ids, s, chunk=int(chunk))
        for dst, src in zip(s, out):
            if src is not dst:
                dst.copy_(src)
        return s
    from .kernel import megastep_chunk_cuda  # lazy: builds at first use
    megastep_chunk_cuda(imgs, ids, s, chunk=int(chunk), block=block)
    megastep_chunk.launches += 1
    return s


megastep_chunk.launches = 0


def run(imgs: F.FleetImages, ids: torch.Tensor, s: MachineState, *,
        chunk: int, block: Optional[int] = None) -> MachineState:
    """Run every lane to halt (or out of fuel, patched to HALT_FUEL)."""
    while bool(F._alive(s).any()):
        s = megastep_chunk(imgs, ids, s, chunk=chunk, block=block)
    s.halted.copy_(F._patch_fuel(s).halted)
    return s


def span(imgs: F.FleetImages, ids: torch.Tensor, s: MachineState, *,
         chunk: int, span: int, block: Optional[int] = None) -> MachineState:
    """At most ``span`` chunks, early exit when every lane halts; no
    HALT_FUEL patch."""
    k = 0
    while k < span and bool(F._alive(s).any()):
        s = megastep_chunk(imgs, ids, s, chunk=chunk, block=block)
        k += 1
    return s
