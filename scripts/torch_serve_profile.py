#!/usr/bin/env python3
"""Where the port's LM serving time goes on one NVIDIA GPU.

    PYTHONPATH=src python scripts/torch_serve_profile.py [--arch NAME ...]
        [--layers N]

Builds each ``--arch`` in turn (default qwen3-1.7b; any of the registry's:
chip_smoke.py serves recurrentgemma-2b, xlstm-350m, qwen2-moe-a2.7b,
seamless-m4t-medium and llava-next-34b too) at full width from a seeded
``torch.Generator`` (random weights; ``--layers`` cuts the depth of a
config deeper than N, as chip_smoke.py cuts llava-next-34b to 16),
prefills 8 prompts padded to 512 tokens (decode budget 64; a frontend's
zero prefix or the encoder's zero input of 512 // frontend_len_div
positions, as ``ServeEngine`` builds them), then decodes 8 tokens, all
through the kernels, under ``torch.profiler``, and frees the model before
the next.  Prints one JSON line per part (prefill, decode): the
host wall time (synchronised), the device time summed over the kernels
the profiler saw (device-side events only), the device idle share (1 -
device / wall), the top kernels by device time and the rows of the
port's own model kernels by name (attention: ``flash_tc_kernel`` /
``flash_kernel``, ``decode_split_kernel`` and ``decode_combine_kernel``;
the RG-LRU scan: ``rglru_scan``; the mLSTM: ``mlstm_scores_kernel``,
``mlstm_state_kernel``, ``mlstm_decode_n_kernel`` and
``mlstm_decode_c_kernel``); then the card line.
Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import model_input  # noqa: E402

BATCH, PROMPT_LEN, DECODE_STEPS, TOP = 8, 512, 8, 12
MODEL_KERNELS = ("flash_tc_kernel", "flash_kernel", "decode_split_kernel",
                 "decode_combine_kernel", "rglru_scan", "mlstm_")


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profiled(fn, label: str, top: int) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpy/memset): the operators
    # that launched them carry the same time again
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, device_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda]
    rows = [r for r in rows if r[1] > 0]
    dev_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {"part": label, "wall_ms": wall_ms, "device_ms": dev_ms,
            "device_idle_share": (1 - dev_ms / wall_ms) if wall_ms else None,
            "top": [{"name": n[:90], "ms": ms, "calls": c}
                    for n, ms, c in rows[:top]],
            "model_kernels": [{"name": n[:90], "ms": ms, "calls": c}
                              for n, ms, c in rows
                              if any(k in n for k in MODEL_KERNELS)]}


def profile_arch(arch: str, layers, dev) -> None:
    cfg = get_config(arch)
    if layers and cfg.n_layers > layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    run = RunConfig(decode_budget=64)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (BATCH, PROMPT_LEN))).to(dev)
    nxt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (BATCH, DECODE_STEPS))).to(dev)
    batch, npfx = model_input(cfg, toks, PROMPT_LEN)
    state = {}

    def prefill():
        state["logits"], state["cache"] = lm.prefill(cfg, run, params, batch)

    def decode():
        for t in range(DECODE_STEPS):
            state["logits"], state["cache"] = lm.decode_step(
                cfg, run, params, state["cache"], nxt[:, t:t + 1],
                PROMPT_LEN + npfx + t)

    prefill()  # warm-up: kernel libraries, cuBLAS handles, allocator
    decode()
    prefill()
    for fn, label in ((prefill, "prefill"), (decode, "decode")):
        out = {"arch": arch, "layers": cfg.n_layers,
               **profiled(fn, label, TOP)}
        if label == "decode":
            out["per_token_wall_ms"] = out["wall_ms"] / DECODE_STEPS
        print(json.dumps(out), flush=True)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=["qwen3-1.7b"])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut a deeper config to this many layers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device is available",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for arch in args.arch:
        profile_arch(arch, args.layers, dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
