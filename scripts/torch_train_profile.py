#!/usr/bin/env python3
"""Where the port's training step time goes on one NVIDIA GPU.

    PYTHONPATH=src python scripts/torch_train_profile.py [--arch NAME]
        [--layers N] [--seq-len S] [--global-batch B]

Builds ``--arch`` (default qwen3-1.7b) at full width from a seeded
``torch.Generator`` (``--layers`` cuts a deeper config to N layers) with
f32 parameters and AdamW moments on the card, ``RunConfig(remat_policy=
"nothing", loss_chunk=128)`` (chip_smoke.py's ``train_full``), and a
``TokenStream`` batch of B x S (default 4 x 512); runs two warm-up steps
of ``make_train_step``, then under ``torch.profiler``: the loss and its
gradient (``grads_and_metrics``: the forward, the recompute of every
checkpointed tile and the backward), the optimizer on those gradients
(``adamw_update``: the global clip and AdamW), and one whole step.
Prints one JSON line a part (host wall time, synchronised; device time
summed over the kernels the profiler saw; the idle share; the top
kernels by device time; the top host operators by their own CPU time),
then the card line.  Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import RunConfig, ShapeConfig, get_config  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.optim.adamw import adamw_update  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    grads_and_metrics, init_train_state, make_train_step)

TOP = 15


def host_rows(fn, top: int) -> list:
    """The operators of one more call of ``fn`` by their own host time."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [{"name": e.key[:80], "self_ms": e.self_cpu_time_total / 1e3,
             "calls": e.count} for e in rows[:top]]


def _serve_profile():
    spec = importlib.util.spec_from_file_location(
        "_serve_profile", ROOT / "scripts" / "torch_serve_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device is available",
              file=sys.stderr)
        return 2
    profiled = _serve_profile().profiled
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers and cfg.n_layers > args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    run = RunConfig(remat_policy="nothing", loss_chunk=128)
    state = init_train_state(cfg, run, torch.Generator(dev).manual_seed(0))
    stream = TokenStream(cfg, ShapeConfig("profile", args.seq_len,
                                          args.global_batch, "train"))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(0).items()}
    step = make_train_step(cfg, run)
    for _ in range(2):  # warm-up: cuBLAS handles, the allocator
        state, _ = step(state, batch)
    held = {}

    def grads():
        held["grads"], _ = grads_and_metrics(cfg, run, state["params"],
                                             batch)

    def optimizer():
        adamw_update(state["params"], held.pop("grads"), state["opt"], run)

    def whole():
        step(state, batch)

    tokens = args.global_batch * args.seq_len
    for fn, label in ((grads, "loss_and_grads"), (optimizer, "adamw"),
                      (whole, "step")):
        out = {"arch": args.arch, "layers": cfg.n_layers, "tokens": tokens,
               **profiled(fn, label, TOP)}
        if label == "step":
            out["tokens_per_s"] = tokens / (out["wall_ms"] / 1e3)
            out["host_top"] = host_rows(whole, TOP)
        print(json.dumps(out), flush=True)
    print(json.dumps({"peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
