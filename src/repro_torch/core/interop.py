"""Carry state and decode tables across frameworks as numpy arrays.

``{field: np.ndarray}`` dicts (as ``np.asarray`` of each leaf of a JAX
``MachineState`` / ``FleetImages`` gives them) become the port's tensors
on a device, and back.  This is how one packed state is handed to both
packages, so that executor parity is tested apart from host-side
preparation.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .fleet import FleetImages
from .machine import MachineState


def _tensor(a, device) -> torch.Tensor:
    # np.array copies: the tensor never aliases the caller's buffer
    return torch.from_numpy(np.array(a)).to(device)


def state_from_numpy(leaves: Mapping[str, np.ndarray],
                     device="cpu") -> MachineState:
    """A ``MachineState`` on ``device`` from one array per field."""
    missing = set(MachineState._fields) - set(leaves)
    if missing:
        raise KeyError(f"missing MachineState leaves: {sorted(missing)}")
    return MachineState(*(_tensor(leaves[f], device)
                          for f in MachineState._fields))


def state_to_numpy(s: MachineState) -> dict:
    """``{field: np.ndarray}`` host copies of every leaf."""
    return {f: getattr(s, f).cpu().numpy() for f in MachineState._fields}


def images_from_numpy(tables: Mapping[str, np.ndarray],
                      device="cpu") -> FleetImages:
    """``FleetImages`` on ``device`` from ``{"packed": ..., "imm": ...}``."""
    return FleetImages(*(_tensor(tables[f], device)
                         for f in FleetImages._fields))

