"""Faults planted underneath the timed path, to show that a cell's
comparison catches them: each is a context manager that patches the
program (``repro_torch``) while it is active and restores it after.

Census (the megastep driver's ``lockstep``, which every census runs):
  ``unchanged``   a run that returns the carry as it was given;
  ``half_lanes``  the second half of the lanes left out (not run);
  ``altered``     every other lane's x0 changed by one where it is
                  produced.
Training (the DDP step's own module):
  ``unchanged``   AdamW leaves the state as it was;
  ``half_batch``  the loss taken over the first half of each sequence,
                  the mean over those positions alone.
The exchange between ranks cannot be left out visibly on a one-rank
world: there the all-reduce is the identity.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, new):
    old = getattr(module, name)
    setattr(module, name, new)
    try:
        yield
    finally:
        setattr(module, name, old)


def _census(kind):
    from repro_torch.kernels.megastep import ops
    orig = ops.lockstep

    def lockstep(parts, **kw):
        if kind == "unchanged":
            return None
        if kind == "half_lanes":
            saved = []
            for p in parts:
                half = p[2].pc.shape[0] // 2
                saved.append([leaf[half:].clone() for leaf in p[2]])
        orig(parts, **kw)
        for j, p in enumerate(parts):
            if kind == "half_lanes":
                half = p[2].pc.shape[0] // 2
                for leaf, old in zip(p[2], saved[j]):
                    leaf[half:].copy_(old)
            elif kind == "altered":
                p[2].regs[1::2, 0] += 1
        return None

    return _patched(ops, "lockstep", lockstep)


def _train(kind):
    import torch
    from repro_torch.models import lm
    from repro_torch.train import step as step_mod
    if kind == "unchanged":
        def adamw_update(params, grads, opt, run):
            z = torch.zeros((), dtype=torch.float32,
                            device=opt["step"].device)
            return params, opt, {"lr": z, "grad_norm": z}
        return _patched(step_mod, "adamw_update", adamw_update)
    if kind == "half_batch":
        orig = lm.loss_fn

        def loss_fn(cfg, run, params, batch):
            half = batch["tokens"].shape[1] // 2
            return orig(cfg, run, params, {**batch,
                                           "tokens": batch["tokens"][:, :half]})
        return _patched(lm, "loss_fn", loss_fn)
    raise ValueError(f"no training fault {kind!r}")


CENSUS = ("unchanged", "half_lanes", "altered")
TRAIN = ("unchanged", "half_batch")


def planted(kind_of_cell: str, fault: str):
    """The context manager that plants ``fault`` in a ``census`` or
    ``train`` cell's program."""
    if kind_of_cell == "census":
        if fault not in CENSUS:
            raise ValueError(f"no census fault {fault!r}")
        return _census(fault)
    return _train(fault)
