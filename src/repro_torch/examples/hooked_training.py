"""End-to-end driver: train a (reduced) LM with the collective-hook layer,
on the card.

The JAX package's ``examples/hooked_training.py`` through the port: a DDP
train step whose gradient all-reduce is (a) censused and (b) compressed
on the wire (bf16) by a hook, while training still converges.  The world
is one rank (``launch.mesh.init_world``: NCCL on the card, gloo with
``--device cpu``), brought up here and torn down at the end; the model's
forms are the plain ones under autograd (no kernel has a backward).

    PYTHONPATH=src python -m repro_torch.examples.hooked_training \
        [--steps 60] [--arch qwen3-1.7b] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..configs import get_smoke
from ..configs.base import RunConfig, ShapeConfig
from ..data.pipeline import TokenStream
from ..hooks import CastCompressHandler, census_fn, hook_collectives
from ..launch.mesh import destroy_world, init_world, make_test_mesh
from ..models import lm
from ..train.step import init_train_state, make_ddp_train_step

SHAPE = ShapeConfig("demo", 64, 4, "train")
MIN_BYTES = 1 << 12  # the compression hook's smallest payload


class Trained(NamedTuple):
    lines: List[str]      # what the example prints
    census: Dict          # census_fn of the DDP step
    losses: List[float]   # every step's loss
    lrs: List[float]      # every step's learning rate
    params: dict          # the parameters after the last step
    update_norm: float    # L2 norm of the parameters' change over the run


def demo_run(steps: int) -> RunConfig:
    return RunConfig(attn_chunk=8, remat_policy="none", learning_rate=3e-3,
                     warmup_steps=5, total_steps=steps, z_loss=0.0)


def hooked_training(steps: int = 60, arch: str = "qwen3-1.7b", device=None,
                    params: Optional[dict] = None) -> Trained:
    """``steps`` hooked DDP steps on a one-rank world on ``device`` (None:
    the card).  ``params`` (the port's parameter tree on that device)
    replaces the weights drawn from a seeded CPU generator.  A world that
    is already up is used and left up; one brought up here is torn down."""
    owned = not dist.is_initialized()
    world = init_world(device)
    try:
        dev = world.device
        cfg = get_smoke(arch)
        run = demo_run(steps)
        mesh = make_test_mesh(data=world.size, model=1)
        state = lm.tree_map(lambda t: t.to(dev), init_train_state(
            cfg, run, torch.Generator().manual_seed(0)))
        if params is not None:
            state["params"] = params
        start = lm.tree_map(torch.clone, state["params"])
        step = make_ddp_train_step(cfg, run, mesh)
        stream = TokenStream(cfg, SHAPE)

        def batch_at(i):
            return {k: torch.from_numpy(v).to(dev)
                    for k, v in stream.batch_at(i).items()}

        # 1. census: how many collective sites does this step have?
        cen = census_fn(step, state, batch_at(0))
        lines = [f"collective census: {cen['total_sites']} sites, "
                 f"{cen['payload_bytes_per_step'] / 2**20:.1f} MiB/step on "
                 f"the wire"]
        # 2. train with a compression hook at the gradient boundary
        hooked = hook_collectives(
            step, {"psum": CastCompressHandler(min_bytes=MIN_BYTES)})
        losses, lrs = [], []
        t0 = time.time()
        for i in range(steps):
            state, metrics = hooked(state, batch_at(i))
            losses.append(float(metrics["loss"]))
            lrs.append(float(metrics["lr"]))
            if i % 10 == 0:
                lines.append(f"step {i:3d} loss {losses[-1]:.4f} "
                             f"lr {lrs[-1]:.2e}")
        if steps:
            lines.append(f"done in {time.time() - t0:.1f}s — final loss "
                         f"{losses[-1]:.4f} (compressed gradient wire)")
        moved = sum(float((a.double() - b.double()).pow(2).sum())
                    for a, b in zip(lm.tree_leaves(state["params"]),
                                    lm.tree_leaves(start)))
        return Trained(lines, cen, losses, lrs, state["params"],
                       moved ** 0.5)
    finally:
        if owned:
            destroy_world()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' trains "
                         "on the CPU over gloo)")
    args = ap.parse_args(argv)
    print("\n".join(hooked_training(args.steps, args.arch,
                                    args.device).lines))


if __name__ == "__main__":
    main()
