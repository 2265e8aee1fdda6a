#!/usr/bin/env python3
"""Where the census drivers' host time goes, on one NVIDIA GPU.

    PYTHONPATH=src python scripts/torch_driver_study.py

The default census (``chip_smoke.py``'s 500 lanes) through the fixed-width
run driver and through each driver around the same kernel: compacted
(``run_fleet_compact``, HookConfig's ladder), streamed
(``run_fleet_stream``, cap 64, chunk 128) against the traced fixed-width
driver, and continuous batching into a 128-lane pool
(``chip_smoke.admission_run``).  Each from a fresh pack, in turns (a, b,
b, a), with the host seconds inside the functions a driver calls summed
by wrappers (a function that waits for the card counts its wait), the
kernel's time from CUDA events around each launch, and the card memory
segments the caching allocator had to ask the driver for during the run.
Prints one JSON line a run, then the card line.  Needs a card.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.core import HookConfig, fleet, pack_fleet  # noqa: E402
from repro_torch.core import runtime  # noqa: E402
from repro_torch.kernels.megastep import kernel as mkernel  # noqa: E402
from repro_torch.kernels.megastep import ops as mops  # noqa: E402
from repro_torch.trace.stream import TraceStream  # noqa: E402

# (owner, attribute) of every function whose host time is summed
WRAPPED = [(mops, "span"), (mops, "run"), (mops, "_check_ids"),
           (mkernel.Launch, "__init__"), (fleet, "permute_split"),
           (fleet, "_assemble_lanes"), (fleet, "_host_rows"),
           (fleet, "flip_trace"), (fleet, "_landed"),
           (TraceStream, "push_block"), (fleet, "admit_lanes"),
           (fleet, "restore_lanes"), (runtime.FleetImageTable, "admit"),
           (smoke, "initial_state"), (smoke, "run_fleet_span")]


@contextlib.contextmanager
def wrapped():
    """Sum the host seconds in each function of WRAPPED, and the calls."""
    seconds, calls, saved = {}, {}, []
    for owner, name in WRAPPED:
        fn = getattr(owner, name)
        key = f"{getattr(owner, '__name__', owner)}.{name}".split(".")[-2:]
        key = ".".join(key)

        def timed(*a, _fn=fn, _key=key, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                seconds[_key] = seconds.get(_key, 0.0) + (
                    time.perf_counter() - t0)
                calls[_key] = calls.get(_key, 0) + 1

        saved.append((owner, name, fn))
        setattr(owner, name, timed)
    try:
        yield seconds, calls
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def one(label, pps, regs, dev, run) -> dict:
    """One run of ``run(packed)`` from a fresh pack: driver ms, host ms by
    function, kernel ms, launches, new allocator segments."""
    traced = label in ("streamed", "traced")
    packed = pack_fleet(pps, fuel=smoke.FUEL, regs=regs, trace=traced,
                        device=dev) if label != "admission" else None
    torch.cuda.synchronize()
    seg0 = torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)
    with wrapped() as (seconds, calls), smoke.LaunchTimer() as timer:
        t0 = time.perf_counter()
        run(packed)
        torch.cuda.synchronize()
        driver_ms = (time.perf_counter() - t0) * 1e3
    seg1 = torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)
    return {"run": label, "driver_ms": driver_ms, "kernel_ms": timer.ms(),
            "launches": len(timer.pairs), "new_segments": seg1 - seg0,
            "host_ms": {k: v * 1e3 for k, v in sorted(seconds.items())},
            "calls": dict(sorted(calls.items()))}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_driver_study: no CUDA device is available",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    mkernel.load_library()
    pps, regs = smoke.census_processes()
    cfg = HookConfig()
    runs = {
        "fixed": lambda p: mops.run(p[0], p[1], p[2], chunk=smoke.CHUNK),
        "compact": lambda p: fleet.run_fleet_compact(
            p[0], p[2], p[1], chunk=smoke.CHUNK,
            min_bucket=cfg.compact_min_bucket,
            hysteresis=cfg.compact_hysteresis, device=dev),
        "traced": lambda p: mops.run(p[0], p[1], p[2], p[3],
                                     chunk=smoke.CHUNK),
        "streamed": lambda p: fleet.run_fleet_stream(
            p[0], p[2], p[1], chunk=smoke.CHUNK, trace=p[3],
            stream=TraceStream(), device=dev),
        "admission": lambda p: smoke.admission_run(
            pps, regs, pool=128, table_rows=32, steps=4 * smoke.CHUNK,
            dev=dev),
    }
    one("fixed", pps, regs, dev, runs["fixed"])  # warm-up
    for a, b in (("fixed", "compact"), ("traced", "streamed"),
                 ("fixed", "admission")):
        for label in (a, b, b, a):
            print(json.dumps(one(label, pps, regs, dev, runs[label])),
                  flush=True)
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
