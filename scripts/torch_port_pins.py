"""Re-derive, from the JAX package, the census results that chip_smoke.py
holds the PyTorch port to on the card.

chip_smoke.py pins the JAX package's 500-lane census at the default
HookConfig (counts and the sha256 of the 34 final MachineState leaves) and
the same census traced (records, verdict counts and the sha256 of the 10
TraceState leaves).  Those runs take minutes on the CPU, so the tests only
copy the pins; this script recomputes them and, with ``--check``, exits 1
if they differ from chip_smoke.py's constants:

    JAX_PLATFORMS=cpu python scripts/torch_port_pins.py --check

It runs the census of ``benchmarks/collective_hook_overhead.py`` through
``repro.core.run_fleet_prepared`` (fuel 10M, chunk 128), untraced and then
with ``trace=True`` (the configs' trace_cap, all-ALLOW), and hashes each
leaf's int64 bytes in field order with chip_smoke.py's own ``digest``.
About 3.5 minutes a run on a CPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from benchmarks.collective_hook_overhead import (  # noqa: E402
    FUEL, _prepare_cells, census_grid)
from repro.core import run_fleet_prepared  # noqa: E402


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke_pins",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def census_pins(digest) -> dict:
    grid = census_grid()
    cells = _prepare_cells()
    pps = [cells[(g[0], g[3])] for g in grid]
    regs = [{19: g[4]} for g in grid]

    t0 = time.perf_counter()
    out = run_fleet_prepared(pps, fuel=FUEL, chunk=128, regs=regs)
    icount = np.asarray(out.icount)
    census = {"lanes": int(icount.shape[0]), "total_steps": int(icount.sum()),
              "longest_lane_steps": int(icount.max()),
              "enosys_total": int(np.asarray(out.enosys_count).sum()),
              "emul_served_total": int(np.asarray(out.emul_served).sum())}
    census_sha = digest(out)
    census_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, tr = run_fleet_prepared(pps, fuel=FUEL, chunk=128, regs=regs,
                               trace=True)
    traced = {"records_total": int(np.asarray(tr.count).sum()),
              "deny": int(np.asarray(tr.deny_count).sum()),
              "emul": int(np.asarray(tr.emul_count).sum()),
              "kill": int(np.asarray(tr.kill_count).sum())}
    return {"census": census, "census_sha256": census_sha,
            "census_s": census_s, "traced": traced,
            "traced_sha256": digest(tr),
            "traced_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless chip_smoke.py's pins match")
    args = ap.parse_args(argv)
    smoke = _chip_smoke()
    got = census_pins(smoke.digest)
    print(json.dumps(got), flush=True)
    if not args.check:
        return 0
    want = {"census": smoke.CENSUS_DEFAULT_EXPECTED,
            "census_sha256": smoke.CENSUS_DEFAULT_SHA256,
            "traced": smoke.TRACED_EXPECTED,
            "traced_sha256": smoke.TRACED_SHA256}
    bad = [k for k, v in want.items() if got[k] != v]
    print(json.dumps({"pins_match": not bad, "differ": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
