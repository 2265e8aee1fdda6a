"""The readings a cell's limits are set from, on the card, many seeds in
one process and without the measured window (set-up, the program's state
freed, the reference, the comparison):

    python3 -m bench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control <name> | --fault <name>] [--device cuda]

prints one JSON line a seed with the numbers the cell compares.  Sound
runs give the lower readings; ``--control`` the upper, one of the cell's
driver's ``CONTROLS``: for a training cell the reference computed in a
precision below the configuration's in the program's place (``fp8``:
float8 matmul operands; ``bf16_scores``: the attention's scores, softmax
and p·v in bfloat16), for the census the program with its guest-kernel
emulation off (``emul_off``).  ``--fault`` plants one of
``bench/faults.py``'s faults in the program.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from bench import common, faults  # noqa: E402


def readings(workload: str, seed: int, *, control: str | None = None,
             fault: str | None = None, device="cuda",
             root: Path = common.HERE) -> dict:
    wl, cfg, drv = common.load_cell(workload, root)
    cell = drv.Cell(wl, cfg, seed, device)
    t0 = time.perf_counter()
    nums = cell.control(control) if control else None
    if nums is not None:
        return {"seed": seed, "control": control, **nums,
                "grad_leaf": cell.grad_leaf, "change_leaf": cell.change_leaf,
                "seconds": time.perf_counter() - t0}
    ctx = (faults.planted(cfg["kind"], fault) if fault
           else contextlib.nullcontext())
    with ctx:
        cell.setup()
        cell.unit()
    cell.release()
    gc.collect()
    checks = cell.check()
    out = {"seed": seed, "control": control, "fault": fault,
           **{c["name"]: c["value"] for c in checks},
           "seconds": time.perf_counter() - t0}
    for k in ("grad_leaf", "change_leaf", "losses"):
        if hasattr(cell, k):
            out[k] = getattr(cell, k)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s),
                                  control=args.control, fault=args.fault,
                                  device=args.device)), flush=True)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
