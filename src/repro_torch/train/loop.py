"""Fault-tolerant training loop: auto-resume, async checkpoints, failure
injection for tests (the JAX package's ``repro.train.loop``).

All state that matters — params, optimizer, EF residuals, data-iterator
position — is in the checkpoint (the JAX package's files:
:mod:`repro_torch.checkpoint.manager`), and ``run_training`` started on a
wreck resumes from the last atomic checkpoint bit-exactly.  A directory
the JAX package's loop wrote resumes here too.  Runs on the card unless
``device="cpu"``; the parameters are drawn from a ``torch.Generator``
seeded with ``run.seed``, so a fresh start differs from the JAX
package's (another generator) while a resumed one continues its state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from ..checkpoint.manager import AsyncWriter, CheckpointManager
from ..configs.base import ModelConfig, RunConfig, ShapeConfig
from ..core.machine import resolve_device
from ..data.pipeline import TokenStream
from .step import init_train_state, make_train_step


class InjectedFailure(RuntimeError):
    """Raised by tests to simulate a node loss mid-run."""


@dataclasses.dataclass
class TrainResult:
    steps_done: int
    losses: List[float]
    resumed_from: Optional[int]
    state: Any


def run_training(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig, *,
                 steps: int,
                 seed: int = 0,
                 fail_at_step: Optional[int] = None,
                 log_every: int = 10,
                 verbose: bool = False,
                 device=None) -> TrainResult:
    """Train for ``steps`` optimizer steps with checkpoint/auto-resume;
    ``device=None`` is the card."""
    dev = resolve_device(device)
    mgr = CheckpointManager(run.ckpt_dir, keep=run.ckpt_keep)
    writer = AsyncWriter(mgr)
    stream = TokenStream(cfg, shape, seed=seed)

    gen = torch.Generator(dev).manual_seed(run.seed)
    state = init_train_state(cfg, run, gen)
    start_step = 0
    resumed_from = None
    restored = mgr.restore_latest(state)
    if restored is not None:
        start_step, state, extra = restored
        resumed_from = start_step
        stream.load_state_dict(extra["data_state"])

    step_fn = make_train_step(cfg, run)

    losses: List[float] = []
    try:
        for step in range(start_step, steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in stream.batch_at(step).items()}
            stream.step = step + 1
            if fail_at_step is not None and step == fail_at_step:
                raise InjectedFailure(f"simulated node loss at step {step}")
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if verbose and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e}")
            if (step + 1) % run.ckpt_every == 0 or step + 1 == steps:
                writer.save(step + 1, state,
                            extra={"data_state": stream.state_dict()})
    finally:
        writer.wait()
    return TrainResult(steps_done=len(losses), losses=losses,
                       resumed_from=resumed_from, state=state)
