"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the fault-tolerant loop (checkpoint/auto-resume) on the card, or on
the CPU with ``--device cpu``.  It trains the reduced (smoke) configs by
default and the full architecture with ``--full-config`` (then every
tile is checkpointed: ``remat_policy="nothing"``), as the JAX package's
launcher does.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import ARCHS, get_config, get_smoke
from ..configs.base import RunConfig, ShapeConfig
from ..core.machine import resolve_device
from ..train.loop import run_training


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16_ef", "int8_ef"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the "
                         "plain PyTorch version on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full_config else get_smoke(args.arch)
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
    run = RunConfig(learning_rate=args.lr, warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every,
                    grad_compression=args.grad_compression,
                    attn_chunk=max(args.seq_len // 4, 8), mlstm_chunk=8,
                    remat_policy="none" if not args.full_config else "nothing")
    print(f"training {cfg.name} for {args.steps} steps on {dev}")
    res = run_training(cfg, run, shape, steps=args.steps, seed=args.seed,
                       verbose=True, device=dev)
    print(f"done: {res.steps_done} steps, final loss "
          f"{res.losses[-1]:.4f} (resumed from {res.resumed_from})")


if __name__ == "__main__":
    main()
