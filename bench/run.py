"""One run of one benchmark cell on the card.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (preparation, packing or the model and its optimizer state, the
warm-up, and any build) runs first; then the window: the cell's units of
work (a census, a step) one after another for ``--seconds``.  With
``--trace 1`` the per-layer metrics replace the end-to-end ones: a
profile of the card's activity over the window's first 15 s gives them,
and a profile of the host's operators over units run after the window
labels the breakdown's idle gaps (``trace.py``).  Once the window has
closed the peak memory is read, the program's state is freed and the
cell's output is compared with the plain reference.  The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), then ``checks``: each number compared beside its limit, which
also end standard error.  Without a card, or with fewer cards than the
cell asks for, it prints no result and exits 2.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

# caches inside the checkout, at fixed paths; NCCL keeps off /dev/shm
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ["NCCL_SHM_DISABLE"] = "1"
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from bench import common, trace  # noqa: E402


def _log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def measure(cell, seconds: float, tick=None):
    """The window: ``cell.unit()`` one after another until ``seconds``
    have passed (once at least); ``tick`` sees the count after each.
    Returns (start, each unit's seconds, the window's seconds)."""
    times = []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        cell.unit()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if tick is not None:
            tick(len(times))
        if t1 - t_start >= seconds:
            break
    return t_start, times, t1 - t_start


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             device="cuda", spec=None, t_process: float = T_PROCESS,
             root: Path = common.HERE,
             trace_seconds: float = trace.TRACE_SECONDS):
    """Set up, measure and check one cell; returns ``(result dict,
    checks)``.  ``device`` is the card (the harness's own tests drive it
    on the CPU at a small size, with a shorter device profile)."""
    wl, cfg, drv = common.load_cell(workload, root)
    spec = common.load_json(common.SPEC) if spec is None else spec
    want = common.cell_metrics(spec, workload)
    cell = drv.Cell(wl, cfg, seed, device)
    dev = torch.device(device)
    card = dev.type == "cuda"
    cell.setup()
    _log(f"set-up {time.perf_counter() - t_process:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in cell.counters.items()))
    tracer = trace.Tracer(card, trace_seconds) if traced else None
    if tracer is not None:
        tracer.start()
    t_start, times, window_s = measure(cell, seconds,
                                       tick=tracer and tracer.tick)
    setup_s = t_start - t_process
    peak = torch.cuda.max_memory_allocated(dev) if card else 0
    if tracer is not None:
        tracer.stop(len(times))
        t0 = time.perf_counter()
        dev_tr = tracer.reduce()
        lab_tr = trace.labelled(cell.unit, card)
        traced_units, rest = times[:tracer.units], times[tracer.units:]
        _log(f"device profile of {len(traced_units)} units in "
             f"{dev_tr.window_s:.3f} s (median unit "
             f"{statistics.median(traced_units):.5f} s); untraced "
             f"remainder of {len(rest)} units in {sum(rest):.3f} s (median "
             f"unit {statistics.median(rest) if rest else math.nan:.5f} s);"
             f" labelled profile of {lab_tr.window_s:.3f} s; read in "
             f"{time.perf_counter() - t0:.3f} s")
        del tracer.prof
    cell.release()
    gc.collect()
    t0 = time.perf_counter()
    checks = cell.check()
    _log(f"reference and comparison {time.perf_counter() - t0:.3f} s"
         + "".join(f", {k} {getattr(cell, k)}" for k in (
             "grad_leaf", "change_leaf", "skipped") if hasattr(cell, k)))
    correct = all(c["ok"] for c in checks)

    metrics, breakdown = {}, None
    device_info = {"platform": "gpu" if card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if card:
        device_info["power_limit_w"] = power_limit_w()
    if not traced:
        values = dict(cell.end_to_end(times, window_s), setup_s=setup_s)
        for m in want["end_to_end"]:
            metrics[m["name"]] = common.metric_entry(values[m["name"]],
                                                     m["unit"])
    else:
        ctx = {"trace": dev_tr, "units": tracer.units, "cell": cell,
               "device": device_info, "rest_units": len(rest),
               "rest_s": sum(rest)}
        for m in want["per_layer"]:
            v = common.metric_reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = common.metric_entry(v, m["unit"])
        device_info["busy_s"] = trace.busy_s(dev_tr)
        device_info["window_s"] = dev_tr.window_s
        breakdown = trace.breakdown(dev_tr, lab_tr)
    result = dict(correct=correct, attempted=len(times),
                  failed=getattr(cell, "failed", 0), metrics=metrics,
                  device=device_info, checks=checks, breakdown=breakdown)
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    wl, _, _ = common.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} asks for {wl['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    bad = common.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r})"
              f" {'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(common.result_line(
        correct=result["correct"], attempted=result["attempted"],
        failed=result["failed"], metrics=result["metrics"],
        device=result["device"], checks=checks,
        breakdown=result["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
